"""Port parity: the Riccati KKT sweep, its kernel's plain version, and the
LQR gain of gpmpc_tpu_torch against gpmpc_tpu on the same numpy inputs."""

import re
import shutil
import subprocess

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gpmpc_tpu.ops.pallas_kernels import riccati_sweep_pallas
from gpmpc_tpu.solvers import riccati as jric
from gpmpc_tpu_torch.ops import cuda_kernels
from gpmpc_tpu_torch.ops.cuda_kernels import (
    CSRC, LAUNCHES, RICCATI_BLOCK_THREADS, RICCATI_CHUNK, RICCATI_SHAPES,
    RICCATI_SMEM_OPTIN, check_riccati_sweep_bad_pivot, library_path,
    riccati_block_layout, riccati_entry, riccati_layout,
    riccati_library_path, riccati_path, riccati_sweep,
    riccati_sweep_reference, riccati_unit_source)
from gpmpc_tpu_torch.solvers import riccati as tric


def random_qp(nt, nx, nu, seed):
    """The random stage QPs of tests/test_pallas.py (cross terms, defects,
    nonzero dx0), as numpy arrays in StageQP order plus dx0."""
    rng = np.random.default_rng(seed)
    a = 0.9 * np.eye(nx)[None] + 0.05 * rng.standard_normal((nt, nx, nx))
    b = 0.3 * rng.standard_normal((nt, nx, nu))
    c = 0.02 * rng.standard_normal((nt, nx))
    m = rng.standard_normal((nt, nx, nx))
    q_xx = 0.5 * (m @ np.swapaxes(m, 1, 2)) + 2.0 * np.eye(nx)[None]
    q_uu = np.tile(0.5 * np.eye(nu)[None], (nt, 1, 1))
    q_xu = 0.1 * rng.standard_normal((nt, nx, nu))
    q_x = 0.1 * rng.standard_normal((nt, nx))
    q_u = 0.1 * rng.standard_normal((nt, nu))
    qf_xx = 5.0 * np.eye(nx)
    qf_x = 0.1 * rng.standard_normal(nx)
    dx0 = 0.3 * rng.standard_normal(nx)
    return (a, b, c, q_xx, q_uu, q_xu, q_x, q_u, qf_xx, qf_x), dx0


@pytest.mark.parametrize("nt,nx,nu,seed", [(20, 4, 2, 0), (13, 5, 3, 1),
                                           (8, 2, 1, 2), (20, 6, 2, 3)])
def test_solve_matches_jax_f64(nt, nx, nu, seed):
    qp, dx0 = random_qp(nt, nx, nu, seed)
    ref = jric.solve(jric.StageQP(*map(jnp.asarray, qp)), jnp.asarray(dx0),
                     1e-6)
    got = tric.solve(tric.StageQP(*map(torch.as_tensor, qp)),
                     torch.as_tensor(dx0), 1e-6)
    for name in ("dx", "du", "gain_k", "ff_k", "exp_dec"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=0, atol=1e-10, err_msg=name)
    assert bool(got.ok) and bool(ref.ok)


@pytest.mark.parametrize("nx,nu", [(4, 2), (5, 3), (2, 1), (6, 2)])
def test_sweep_reference_long_horizon_matches_jax_f64(nx, nu):
    """The kernel's plain version in f64 against JAX x64 riccati.solve at
    Nt=300, the long horizon that the kernel streams through its
    shared-memory chunks on the card: within 1e-8."""
    qp, dx0 = random_qp(300, nx, nu, 7)
    ref = jric.solve(jric.StageQP(*map(jnp.asarray, qp)), jnp.asarray(dx0),
                     1e-6)
    got = riccati_sweep_reference(*map(torch.as_tensor, qp),
                                  torch.as_tensor(dx0), torch.tensor(1e-6))
    for g, name in zip(got, ("dx", "du", "gain_k", "ff_k", "exp_dec")):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(ref, name)),
                                   rtol=0, atol=1e-8, err_msg=name)


def test_riccati_shapes_mirror_the_kernel_instantiations():
    """RICCATI_SHAPES, the (nx, nu) pairs the wrapper lets through, are the
    instantiations of csrc/riccati_sweep.cu's C entry."""
    src = (CSRC / "riccati_sweep.cu").read_text()
    found = re.findall(r"^\s*GPMPC_RICCATI_CASE\((\d+), (\d+)\)", src,
                       re.MULTILINE)
    assert sorted((int(a), int(b)) for a, b in found) == \
        sorted(RICCATI_SHAPES)
    assert (6, 2) in RICCATI_SHAPES


def test_riccati_chunk_mirrors_the_kernel_source():
    """RICCATI_CHUNK, which the card tests use to cross the kernel's chunk
    boundaries, is the CHUNK constant of csrc/riccati_sweep.cu."""
    src = (CSRC / "riccati_sweep.cu").read_text()
    found = re.findall(r"constexpr int CHUNK = (\d+);", src)
    assert found == [str(RICCATI_CHUNK)]


def test_riccati_layout_mirrors_the_kernel_source():
    """RICCATI_SMEM_OPTIN is SMEM_OPTIN of csrc/riccati_sweep.cu (the
    H100's 227 KB), and riccati_layout gives the pre-built shapes the full
    chunk and four warps a block, as the kernel's Layout does."""
    src = (CSRC / "riccati_sweep.cu").read_text()
    assert re.findall(r"constexpr int SMEM_OPTIN = (\d+);", src) == [
        str(RICCATI_SMEM_OPTIN)]
    assert RICCATI_SMEM_OPTIN == 227 * 1024
    for nx, nu in RICCATI_SHAPES:
        assert riccati_layout(nx, nu)[0] == RICCATI_CHUNK
        assert riccati_layout(nx, nu)[2] == 4
    # (4, 2): 19536 bytes a warp, summed field by field over the kernel's
    # Layout at 32 stages (two chunks of 38 floats a stage, 64 + 20 rows)
    assert riccati_layout(4, 2) == (32, 19536, 4)


def test_riccati_layout_admits_every_shape_within_the_lane_limits():
    """Every (nx, nu) with nx < 31 and nu <= 32 fits one warp's shared
    memory once the chunk halves (down to 4 stages), so the lane limits
    are the only limits: (18, 2) is the widest nu = 2 at the full chunk,
    (19, 2) takes 16 stages and (30, 32) 4."""
    for nx in range(1, 31):
        for nu in range(1, 33):
            chunk, warp_bytes, warps = riccati_layout(nx, nu)
            assert chunk in (4, 8, 16, 32) and warps in (1, 2, 3, 4)
            assert warp_bytes <= RICCATI_SMEM_OPTIN, (nx, nu)
            if chunk < RICCATI_CHUNK:
                assert 4 * cuda_kernels._riccati_floats(
                    nx, nu, 2 * chunk) > RICCATI_SMEM_OPTIN, (nx, nu)
    assert riccati_layout(18, 2)[0] == 32
    assert riccati_layout(19, 2)[0] == 16
    assert riccati_layout(30, 32) == (4, 206592, 1)


@pytest.mark.parametrize("nx,nu,limit", [(31, 2, "nx < 31"),
                                         (4, 33, "nu <= 32"),
                                         (0, 1, "nx < 31")])
def test_riccati_limits_raise_before_any_build(nx, nu, limit):
    """The warp kernel's layout refuses a pair past its lane limits with
    ValueError naming the limit, and such a pair takes the block path
    (:func:`riccati_path`); nx < 1 or nu < 1 raises ValueError from the one
    lookup every launch goes through, before any build (this machine has
    no nvcc: a build would raise RuntimeError)."""
    with pytest.raises(ValueError, match=re.escape(limit)):
        riccati_layout(nx, nu)
    if nx >= 1:
        assert riccati_path(nx, nu) == "block"
        return
    for pair in ((nx, nu), (1, 0), (-1, 3)):
        with pytest.raises(ValueError, match="nx >= 1, nu >= 1"):
            riccati_entry(*pair)
    assert not riccati_library_path(1, nu).exists()
    assert not library_path().exists()


@pytest.mark.parametrize("nx,nu,path,work_smem", [
    (30, 32, "warp", None), (1, 1, "warp", None), (31, 2, "block", True),
    (4, 33, "block", True), (40, 20, "block", True), (40, 40, "block", True),
    (96, 48, "block", False)])
def test_riccati_routing(nx, nu, path, work_smem):
    """Pairs within the warp kernel's lane limits (nx < 31, nu <= 32) take
    the warp path as before; every other pair the block path, whose
    working set leaves shared memory for a per-problem workspace past the
    227 KB a block may opt in to ((96, 48): one stage buffer beside it)."""
    assert riccati_path(nx, nu) == path
    if path == "warp":
        assert riccati_layout(nx, nu)[1] <= RICCATI_SMEM_OPTIN
        return
    lay = riccati_block_layout(nx, nu)
    assert lay.work_smem == work_smem
    assert lay.smem_bytes <= RICCATI_SMEM_OPTIN
    if work_smem:
        assert lay.buffers == 2 and lay.smem_bytes > 4 * lay.work_floats
    else:
        assert lay.buffers == 1 and lay.work_floats > 3 * nx * nx
        assert lay.smem_bytes + 4 * lay.work_floats > RICCATI_SMEM_OPTIN


def _block_source_host_part():
    """csrc/riccati_sweep_block.cu's constants, tile schedule and
    block_layout: the part of the source that the host compiler takes, from
    its GPMPC_HD macro to the first device-only definition."""
    src = (CSRC / "riccati_sweep_block.cu").read_text()
    start = src.index("#if defined(__CUDACC__)")
    end = src.index("constexpr unsigned FULL")
    return ("#include <cmath>\n#include <cstdio>\n#include <vector>\n"
            + src[start:end] + "}  // namespace\n")


def _compile_and_run(tmp_path, name, code):
    (tmp_path / f"{name}.cpp").write_text(code)
    cxx = shutil.which("g++")
    subprocess.run([cxx, "-std=c++17", "-O2", "-o", str(tmp_path / name),
                    str(tmp_path / f"{name}.cpp")], check=True)
    return subprocess.run([str(tmp_path / name)], capture_output=True,
                          text=True, check=True).stdout


def test_riccati_block_layout_mirrors_the_kernel_source(tmp_path):
    """riccati_block_layout is csrc/riccati_sweep_block.cu's block_layout:
    the source's own function (and its constants), compiled here with the
    host g++, gives the same layout at pairs on both sides of every break;
    the source's thread count is RICCATI_BLOCK_THREADS, its panel width
    RICCATI_BLOCK_PANEL and its opt-in the warp kernel's SMEM_OPTIN."""
    src = (CSRC / "riccati_sweep_block.cu").read_text()
    assert re.findall(r"constexpr int THREADS = (\d+);", src) == [
        str(RICCATI_BLOCK_THREADS)]
    assert re.findall(r"constexpr int PANEL = (\d+);", src) == [
        str(cuda_kernels.RICCATI_BLOCK_PANEL)]
    assert re.findall(r"constexpr int OPTIN_FLOATS = (\d+) / 4;", src) == [
        str(RICCATI_SMEM_OPTIN)]
    pairs = [(n, n) for n in range(1, 130)] + [
        (31, 2), (4, 33), (40, 20), (96, 48), (200, 3), (3, 200), (300, 10)]
    main = "\n".join(
        f"  {{ BlockLayout L = block_layout({a}, {b}); "
        f'printf("%d %d %d %d\\n", L.buffers, L.work_smem, L.work, '
        f"L.smem_bytes); }}"
        for a, b in pairs)
    out = _compile_and_run(tmp_path, "lay", _block_source_host_part()
                           + f"int main() {{\n{main}\n}}\n").split("\n")
    for (a, b), line in zip(pairs, out):
        buffers, work_smem, work, smem = map(int, line.split())
        assert riccati_block_layout(a, b) == (buffers, bool(work_smem), work,
                                              smem), (a, b)
    # the breaks the source states for nx = nu = n
    assert [riccati_block_layout(n, n)[:2] for n in (50, 51, 60, 61, 69, 70,
                                                     97, 98)] == [
        (2, True), (1, True), (1, True), (2, False), (2, False), (1, False),
        (1, False), (0, False)]


#: the C++ check of the block kernel's tile schedule, over every (nx, nu)
#: in 1..N: each product's entries owned by exactly one tile, each tile's
#: reads and writes inside its padded arrays, H_uu's panels a partition
#: and their trailing and back updates each entry once
_SCHEDULE_CHECK = r"""
static int bad = 0;
static void fail(const char* what, int nx, int nu, int t) {
  if (bad++ < 20) printf("FAIL %s at (%d, %d) tile %d\n", what, nx, nu, t);
}
// every entry (i, j) of a rows x cols output written by exactly one tile of
// the pass; reads of P's columns below pld and Q's below qld
static void pass(int nx, int nu, bool tri, int rows, int cols, int col,
                 int pld, int qld, std::vector<int>& own, const char* what) {
  own.assign(rows * cols, 0);
  const int nt = tri ? tri_count(rows, col) : rect_count(rows, cols);
  for (int t = 0; t < nt; ++t) {
    const Tile T = tri ? tri_tile(t, rows, col) : rect_tile(t, cols);
    if (T.i0 + 3 >= pld || T.j0 + T.tn - 1 >= qld) fail(what, nx, nu, t);
    for (int e = 0; e < 4; ++e)
      for (int f = 0; f < T.tn; ++f) {
        const int i = T.i0 + e, j = T.j0 + f;
        if (tile_keeps(T, i, j, rows, cols, tri)) {
          if (i < 0 || j < 0 || i >= rows || j >= cols) fail(what, nx, nu, t);
          else ++own[i * cols + j];
        }
      }
  }
  for (int i = 0; i < rows; ++i)
    for (int j = 0; j < cols; ++j) {
      const bool want = !tri || j <= i || (col >= 0 && j == col);
      if (own[i * cols + j] != (want ? 1 : 0)) fail(what, nx, nu, -1);
    }
}
int main() {
  std::vector<int> own;
  int pairs = 0;
  for (int nx = 1; nx <= N; ++nx)
    for (int nu = 1; nu <= N; ++nu) {
      ++pairs;
      const BlockLayout L = block_layout(nx, nu);
      const int n = nx + nu;
      // M = V [A B c]: V rows of ldv, Z and M rows of ldn
      pass(nx, nu, false, nx, n + 1, -1, L.ldv, L.ldn, own, "M");
      // H and h: Z rows (P) and M rows (Q) of ldn
      pass(nx, nu, true, n, n + 1, n, L.ldn, L.ldn, own, "H");
      // V and v_x: H rows (P, ldn) and S rows (Q, lds)
      pass(nx, nu, true, nx, nx + 1, nx, L.ldn, L.lds, own, "V");
      // H_uu's panels: a partition of its columns
      int c = 0;
      for (int p = 0; p < panel_count(nu); ++p) {
        const int pw = panel_width(p, nu), c0 = PANEL * p, c1 = c0 + pw;
        if (c0 != c || pw < 1 || pw > PANEL) fail("panel", nx, nu, p);
        c = c1;
        if (p == panel_count(nu) - 1) continue;
        const int rows = nu - c1;
        // the trailing update: W rows c1 .. of ldw (pad4(nu) rows), S rows
        pass(nx, nu, true, rows, rows, -1, L.ldw - c0, L.ldw - c0, own,
             "trailing W");
        if (c1 + 4 * cdiv4(rows) > pad4(nu)) fail("W rows", nx, nu, p);
        pass(nx, nu, false, rows, nx + 1, -1, L.ldw - c0, L.lds, own,
             "trailing S");
        // the back update: L21' S_below, the panel's rows of S
        pass(nx, nu, false, pw, nx + 1, -1, L.ldw - c0, L.lds, own,
             "back S");
      }
      if (c != nu) fail("panels", nx, nu, -1);
      // the layout: aligned arrays, none past shared memory
      const int offs[] = {L.z, L.qh, L.stage, L.v, L.vx, L.m, L.h, L.w,
                          L.s, L.pv, L.xf, L.uf, L.zs, L.work, L.ldn,
                          L.ldv, L.lds};
      for (int o : offs)
        if (o % 4) fail("alignment", nx, nu, o);
      if (L.ldw % 2 == 0 || L.ldp % 2 == 0 || L.ldn < n + 1 ||
          L.ldv < nx || L.lds < nx + 1 || L.smem_bytes > 4 * OPTIN_FLOATS)
        fail("layout", nx, nu, -1);
    }
  printf("%d pairs, %d failures\n", pairs, bad);
}
"""


def test_riccati_block_tile_schedule_owns_every_entry_once(tmp_path):
    """The block kernel's tile and panel index functions, compiled out of
    csrc/riccati_sweep_block.cu with the host g++ (they are __host__
    __device__), at every (nx, nu) in 1..130: each entry of M, of H's
    lower triangle and h, of V's lower triangle and v_x, and of each
    panel's trailing and back updates is written by exactly one tile; no
    tile reads a column past its array's padded leading dimension (nor W
    past its padded rows); the panels partition H_uu's columns; every
    array offset is 16-byte aligned and W's and the factor's leading
    dimensions are odd."""
    out = _compile_and_run(
        tmp_path, "sched", _block_source_host_part()
        + "constexpr int N = 130;\n" + _SCHEDULE_CHECK)
    assert out.strip().splitlines()[-1] == "16900 pairs, 0 failures", out


def test_riccati_block_path_is_in_the_main_library(tmp_path, monkeypatch):
    """The block path's source builds into the main library (no build per
    pair): an edited csrc/riccati_sweep_block.cu gives the main library
    another name, and leaves the warp kernel's on-demand libraries' names
    as they are (they hash csrc/riccati_sweep.cu alone)."""
    main, warp = library_path(), riccati_library_path(3, 3)
    for src in list(CSRC.glob("*.cu")) + list(CSRC.glob("*.h")):
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(cuda_kernels, "CSRC", tmp_path)
    assert library_path() == main and riccati_library_path(3, 3) == warp
    with open(tmp_path / "riccati_sweep_block.cu", "a") as fh:
        fh.write("// edited\n")
    assert library_path() != main
    assert library_path().name.startswith("libgpmpc_cuda_")
    assert riccati_library_path(3, 3) == warp
    assert "gpmpc_riccati_sweep_block_f32" in (
        tmp_path / "riccati_sweep_block.cu").read_text()


def test_riccati_unit_instantiates_one_shape(tmp_path):
    """The unit built on demand for (3, 3) defines the pair and includes
    csrc/riccati_sweep.cu, whose C entry then instantiates that pair
    alone (preprocessed here with the host compiler and a stand-in for
    the CUDA header); its library is keyed by the pair and by the
    source."""
    unit = riccati_unit_source(3, 3)
    code = [ln for ln in unit.splitlines() if not ln.startswith("//")]
    assert code == ["#define GPMPC_RICCATI_NX 3", "#define GPMPC_RICCATI_NU 3",
                    '#include "riccati_sweep.cu"']
    src = (CSRC / "riccati_sweep.cu").read_text()
    assert re.search(r"#ifdef GPMPC_RICCATI_NX\s+GPMPC_RICCATI_CASE\("
                     r"GPMPC_RICCATI_NX, GPMPC_RICCATI_NU\)\s+#else", src)
    (tmp_path / "cuda_runtime.h").write_text("")
    (tmp_path / "unit.cu").write_text(unit)
    cxx = shutil.which("g++") or shutil.which("cpp")
    out = subprocess.run([cxx, "-E", "-P", "-x", "c++", "-I", str(CSRC),
                          "-I", str(tmp_path), str(tmp_path / "unit.cu")],
                         capture_output=True, text=True, check=True).stdout
    entry = out[out.index('extern "C"'):]
    assert re.findall(r"launch<(\d+), (\d+)>", entry) == [("3", "3")]
    path = riccati_library_path(3, 3)
    assert path.parent == cuda_kernels.BUILD_DIR
    assert "3x3" in path.name and path != riccati_library_path(3, 4)


def test_riccati_library_key_follows_the_source(tmp_path, monkeypatch):
    """An edited csrc/riccati_sweep.cu gets another library name for the
    same pair, so a stale build is never loaded."""
    before = riccati_library_path(3, 3)
    (tmp_path / "riccati_sweep.cu").write_text(
        (CSRC / "riccati_sweep.cu").read_text() + "// edited\n")
    monkeypatch.setattr(cuda_kernels, "CSRC", tmp_path)
    after = riccati_library_path(3, 3)
    assert after != before and after.name.startswith("libgpmpc_riccati_3x3_")


@pytest.mark.parametrize("shape", [None, (20, 6, 2), (20, 4, 4)])
@pytest.mark.parametrize("kind", ["indefinite", "zero"])
def test_bad_pivot_cases_give_non_finite_gains_on_cpu(kind, shape):
    """The bad-pivot cases the card checks K1 with, at their default shapes,
    at the car's (6, 2) and at the four-tank MHE's (4, 4): its plain
    version gives non-finite gains for an indefinite and for a zero H_uu
    pivot too."""
    check_riccati_sweep_bad_pivot(kind, device="cpu", shape=shape)
    with pytest.raises(ValueError, match="unknown"):
        check_riccati_sweep_bad_pivot("other", device="cpu")


def test_sweep_reference_matches_pallas_interpret_f32():
    """The kernel's plain version against the TPU kernel (Pallas interpret)
    at the tolerances of tests/test_pallas.py."""
    nt, nx, nu = 8, 4, 2
    qp, dx0 = random_qp(nt, nx, nu, 3)
    qp32 = [x.astype(np.float32) for x in qp]
    dx0_32 = dx0.astype(np.float32)
    ref = riccati_sweep_pallas(*map(jnp.asarray, qp32), jnp.asarray(dx0_32),
                               1e-6, interpret=True)
    got = riccati_sweep_reference(*map(torch.as_tensor, qp32),
                                  torch.as_tensor(dx0_32),
                                  torch.tensor(1e-6))
    scale = float(np.abs(np.asarray(ref[0])).max()) + 1.0
    for i, atol in ((0, 1e-5 * scale), (1, 1e-5 * scale), (2, 2e-5)):
        assert got[i].dtype == torch.float32
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref[i]),
                                   atol=atol)
    np.testing.assert_allclose(float(got[4]), float(ref[4]), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("nt,nx,nu", [(3, 33, 2), (2, 8, 33)])
def test_sweep_reference_past_one_warp_matches_pallas_interpret(nt, nx, nu):
    """Past the warp kernel's lanes (the block path's pairs): the plain
    version against the TPU kernel (Pallas interpret, which takes any
    shape) at the tolerances of tests/test_pallas.py."""
    qp, dx0 = random_qp(nt, nx, nu, 4)
    qp32 = [x.astype(np.float32) for x in qp]
    dx0_32 = dx0.astype(np.float32)
    ref = riccati_sweep_pallas(*map(jnp.asarray, qp32), jnp.asarray(dx0_32),
                               1e-6, interpret=True)
    got = riccati_sweep_reference(*map(torch.as_tensor, qp32),
                                  torch.as_tensor(dx0_32),
                                  torch.tensor(1e-6))
    scale = float(np.abs(np.asarray(ref[0])).max()) + 1.0
    for i, atol in ((0, 1e-5 * scale), (1, 1e-5 * scale), (2, 2e-5),
                    (3, 2e-5)):
        assert got[i].shape == ref[i].shape
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref[i]),
                                   atol=atol)
    np.testing.assert_allclose(float(got[4]), float(ref[4]), rtol=1e-4,
                               atol=1e-6)


def dense_kkt_solve(qp, dx0s, reg):
    """The stage QP solved as one dense equality-constrained QP in numpy
    f64 (reg I added to Q_uu, as the sweep adds it to H_uu), for each
    start in ``dx0s`` (k, nx): dx (k, Nt+1, nx) and du (k, Nt, nu)."""
    a, b, c, q_xx, q_uu, q_xu, q_x, q_u, qf_xx, qf_x = qp
    nt, nx, nu = b.shape
    nz = nt * (nx + nu)                   # x_1..x_Nt, then u_0..u_Nt-1
    xi = lambda t: slice((t - 1) * nx, t * nx)          # noqa: E731
    ui = lambda t: slice(nt * nx + t * nu, nt * nx + (t + 1) * nu)  # noqa
    h = np.zeros((nz, nz))
    g = np.zeros((len(dx0s), nz))
    e_mat = np.zeros((nt * nx, nz))
    e = np.zeros((len(dx0s), nt * nx))
    for t in range(nt):
        h[ui(t), ui(t)] += q_uu[t] + reg * np.eye(nu)
        g[:, ui(t)] += q_u[t]
        if t == 0:
            g[:, ui(0)] += dx0s @ q_xu[0]
        else:
            h[xi(t), xi(t)] += q_xx[t]
            h[xi(t), ui(t)] += q_xu[t]
            h[ui(t), xi(t)] += q_xu[t].T
            g[:, xi(t)] += q_x[t]
            e_mat[xi(t + 1), xi(t)] = -a[t]
        e_mat[xi(t + 1), xi(t + 1)] = np.eye(nx)
        e_mat[xi(t + 1), ui(t)] = -b[t]
        e[:, xi(t + 1)] = c[t] + (dx0s @ a[0].T if t == 0 else 0.0)
    h[xi(nt), xi(nt)] += qf_xx
    g[:, xi(nt)] += qf_x
    kkt = np.block([[h, e_mat.T], [e_mat, np.zeros((nt * nx, nt * nx))]])
    sol = np.linalg.solve(kkt, np.concatenate([-g, e], axis=1).T).T
    xs = sol[:, :nt * nx].reshape(-1, nt, nx)
    dx = np.concatenate([dx0s[:, None], xs], axis=1)
    return dx, sol[:, nt * nx:nz].reshape(-1, nt, nu)


def test_sweep_reference_at_40x40_matches_jax_f64():
    """The four-tank network's pairs, the block path's on the card: the
    plain version in f64 at (Nt, nx, nu) = (4, 40, 8) against JAX x64
    riccati.solve, and at the MHE's (4, 40, 40), which JAX's unrolled
    Cholesky does not compile on XLA:CPU (its compiler crashes at nu =
    40; nu = 30 takes ~60 s on one CPU core), against the QP solved densely in numpy f64: dx, du and
    the first stage's gain (du_0's derivative in dx0, from the dense
    solves at dx0 and dx0 + e_i) and feedforward, within 1e-8."""
    qp, dx0 = random_qp(4, 40, 8, 8)
    ref = jric.solve(jric.StageQP(*map(jnp.asarray, qp)), jnp.asarray(dx0),
                     1e-6)
    got = riccati_sweep_reference(*map(torch.as_tensor, qp),
                                  torch.as_tensor(dx0), torch.tensor(1e-6))
    for g, name in zip(got, ("dx", "du", "gain_k", "ff_k", "exp_dec")):
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(ref, name)),
                                   rtol=0, atol=1e-8, err_msg=name)
    qp, dx0 = random_qp(4, 40, 40, 8)
    dx, du, gains, ffs, _ = riccati_sweep_reference(
        *map(torch.as_tensor, qp), torch.as_tensor(dx0), torch.tensor(1e-6))
    starts = np.concatenate([dx0[None], np.zeros((1, 40)), np.eye(40)])
    d_dx, d_du = dense_kkt_solve(qp, starts, 1e-6)
    np.testing.assert_allclose(dx.numpy(), d_dx[0], rtol=0, atol=1e-8)
    np.testing.assert_allclose(du.numpy(), d_du[0], rtol=0, atol=1e-8)
    np.testing.assert_allclose(ffs[0].numpy(), d_du[1, 0], rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(gains[0].numpy(),
                               (d_du[2:, 0] - d_du[1, 0]).T, rtol=0,
                               atol=1e-8)


def test_sweep_reference_batched_equals_per_problem():
    """The batch dim (one kernel thread per problem) gives each problem the
    answer it gets alone; reg may differ per problem."""
    probs = [random_qp(6, 4, 2, s) for s in range(3)]
    regs = [1e-6, 1e-3, 0.1]
    stack = [torch.as_tensor(np.stack([p[0][i] for p in probs]))
             for i in range(10)]
    dx0 = torch.as_tensor(np.stack([p[1] for p in probs]))
    out = riccati_sweep_reference(*stack, dx0, torch.tensor(regs,
                                                            dtype=torch.float64))
    for k, ((qp, d0), reg) in enumerate(zip(probs, regs)):
        one = riccati_sweep_reference(*map(torch.as_tensor, qp),
                                      torch.as_tensor(d0), reg)
        for got, ref in zip(out, one):
            np.testing.assert_allclose(got[k].numpy(), ref.numpy(),
                                       rtol=1e-12, atol=1e-14)


def test_indefinite_quu_gives_not_ok():
    """An indefinite H_uu (negative q_uu, no reg) yields NaN and ok=False in
    the sequential sweep and in the fused path (its plain version on CPU),
    like the JAX sweep."""
    qp, dx0 = random_qp(8, 2, 1, 2)
    qp = list(qp)
    qp[4] = -qp[4]
    assert not bool(jric.solve(jric.StageQP(*map(jnp.asarray, qp)),
                               jnp.asarray(dx0), 0.0).ok)
    assert not bool(tric.solve(tric.StageQP(*map(torch.as_tensor, qp)),
                               torch.as_tensor(dx0), 0.0).ok)
    qp32 = tric.StageQP(*(torch.as_tensor(x, dtype=torch.float32)
                          for x in qp))
    before = dict(LAUNCHES)
    sol = tric.solve_fused(qp32, torch.as_tensor(dx0, dtype=torch.float32),
                           0.0)
    assert not bool(sol.ok)
    assert LAUNCHES == before        # the CPU path launches no kernel


def test_wrapper_on_cpu_is_the_plain_version():
    qp, dx0 = random_qp(5, 4, 2, 4)
    args = [torch.as_tensor(x, dtype=torch.float32) for x in qp]
    d0 = torch.as_tensor(dx0, dtype=torch.float32)
    reg = torch.tensor(1e-4)
    for got, ref in zip(riccati_sweep(*args, d0, reg),
                        riccati_sweep_reference(*args, d0, reg)):
        assert torch.equal(got, ref)


def test_select_backend():
    assert tric.select_backend(20, torch.float32, fused=True) is \
        tric.solve_fused
    assert tric.select_backend(500, torch.float32, fused=True) is \
        tric.solve_fused             # no horizon cap: the kernel loops
    assert tric.select_backend(20, torch.float32) is tric.solve_parallel
    assert tric.select_backend(19, torch.float32) is tric.solve
    assert tric.select_backend(20, torch.float64) is tric.solve
    assert tric.select_backend(20, torch.float32, parallel=True) is \
        tric.solve_parallel
    with pytest.raises(ValueError, match="f32"):
        tric.select_backend(20, torch.float64, fused=True)
    qp, dx0 = random_qp(4, 2, 1, 0)
    with pytest.raises(ValueError, match="f32"):
        tric.solve_fused(tric.StageQP(*map(torch.as_tensor, qp)),
                         torch.as_tensor(dx0), 1e-6)


@pytest.mark.parametrize("nt", [3, 5, 8, 19, 20, 60, 256])
@pytest.mark.parametrize("f64", [False, True])
@pytest.mark.parametrize("fused,parallel", [(False, False), (False, True),
                                            (True, False), (True, True)])
def test_select_backend_matches_jax(nt, f64, fused, parallel):
    """The port picks the KKT solve the JAX package picks, by name, over
    horizons on both sides of PARALLEL_MIN_NT and up to JAX's fused_max_nt
    (beyond it JAX degrades fused to the associative scan; the port's sweep
    kernel loops at run time and keeps it, tested in
    test_select_backend)."""
    tdt, jdt = ((torch.float64, jnp.float64) if f64
                else (torch.float32, jnp.float32))
    if fused and f64:
        with pytest.raises(ValueError):
            jric.select_backend(nt, jdt, fused=fused, parallel=parallel)
        with pytest.raises(ValueError):
            tric.select_backend(nt, tdt, fused=fused, parallel=parallel)
        return
    assert tric.select_backend(nt, tdt, fused=fused, parallel=parallel
                               ).__name__ == jric.select_backend(
        nt, jdt, fused=fused, parallel=parallel).__name__


@pytest.mark.parametrize("nt,nx,nu,seed", [(20, 4, 2, 0), (13, 5, 3, 1),
                                           (8, 2, 1, 2), (1, 3, 2, 3)])
def test_solve_parallel_matches_jax_f64(nt, nx, nu, seed):
    """The associative-scan Riccati solve against JAX x64 solve_parallel on
    the stage QPs of tests/test_pallas.py: rtol 1e-8 (scale-relative)."""
    qp, dx0 = random_qp(nt, nx, nu, seed)
    ref = jric.solve_parallel(jric.StageQP(*map(jnp.asarray, qp)),
                              jnp.asarray(dx0), 1e-6)
    got = tric.solve_parallel(tric.StageQP(*map(torch.as_tensor, qp)),
                              torch.as_tensor(dx0), 1e-6)
    for name in ("dx", "du", "gain_k", "ff_k", "exp_dec"):
        r = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(getattr(got, name).numpy(), r, rtol=1e-8,
                                   atol=1e-8 * (1.0 + np.abs(r).max()))
    assert bool(got.ok) and bool(ref.ok)
    seq = tric.solve(tric.StageQP(*map(torch.as_tensor, qp)),
                     torch.as_tensor(dx0), 1e-6)
    np.testing.assert_allclose(got.dx.numpy(), seq.dx.numpy(), atol=1e-9)


def test_solve_parallel_indefinite_gives_not_ok():
    qp, dx0 = random_qp(8, 2, 1, 2)
    qp = list(qp)
    qp[4] = -qp[4]
    got = tric.solve_parallel(tric.StageQP(*map(torch.as_tensor, qp)),
                              torch.as_tensor(dx0), 0.0)
    assert not bool(got.ok)


@pytest.mark.parametrize("seed", [0, 1])
def test_lqr_gain_matches_jax(seed):
    rng = np.random.default_rng(seed)
    a = np.eye(4) + 0.1 * rng.standard_normal((4, 4))
    b = rng.standard_normal((4, 2))
    q, r = np.diag([20.0, 20.0, 0.1, 0.1]), 0.05 * np.eye(2)
    k_j, ok_j = jric.lqr_gain(*map(jnp.asarray, (a, b, q, r)),
                              return_converged=True)
    k_t, ok_t = tric.lqr_gain(*map(torch.as_tensor, (a, b, q, r)),
                              return_converged=True)
    assert ok_t == bool(ok_j)
    np.testing.assert_allclose(k_t.numpy(), np.asarray(k_j), rtol=1e-8,
                               atol=1e-10)
