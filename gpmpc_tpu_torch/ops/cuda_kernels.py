"""Hand-written CUDA kernels of the control path, their plain PyTorch
versions, the wrappers that choose between them by the device of the
tensors, and the build of the one library that holds every kernel.

Counterpart of ``gpmpc_tpu/ops/pallas_kernels.py``.  Two kernels here, both
CUDA C++ for ``sm_90a`` in ``gpmpc_tpu_torch/csrc/``:

* K1 ``riccati_sweep`` replaces ``pallas_kernels.py:riccati_sweep_pallas``:
  the whole backward Riccati factorization of the stage-QP KKT system plus
  the forward rollout, in one launch.
* K2 ``rk4_substeps`` replaces ``pallas_kernels.py:rk4_substeps_pallas``:
  ``n_sub`` RK4 substeps of the plant ODE in one launch, for any ODE the
  Pallas kernel takes.  ``systems.four_tank_ode`` and ``car_ode``, passed
  as they are (their ``cuda_ode`` tag), take the hand-written functors
  ``FourTank`` and ``Car``; any other ODE is traced on one point into a
  functor of its own (:mod:`gpmpc_tpu_torch.ops.ode_trace`), built at its
  first launch into a library of its own (:func:`register_ode`,
  :func:`k2_entry`).

The GP path's kernels (K3, K4, K5) are in :mod:`gpmpc_tpu_torch.ops.gp_cuda`
and build into the same library.

Both are latency-bound on an H100: the main path's sweep is ~20 dependent
stages of 4x4 products and the plant step 40 evaluations of a 4-state ODE,
far below any roofline, so what costs is the number of launches and of
device-memory round trips between dependent steps.  Each kernel therefore
runs its whole chain in one launch.  K1 gives each problem one warp: the
lanes share each stage's products, and the stage arrays reach shared
memory in chunks of :data:`RICCATI_CHUNK` stages by ``cp.async``, the next
chunk's copy in flight while one is solved, so Nt <= RICCATI_CHUNK pays
one memory round trip in all.  K2 runs one thread per rollout with the
state in registers and the main path's n_sub = 10 compiled in; FourTank
takes its square roots by one MUFU.RSQ each, a traced functor rounds
each op as PyTorch does.  The source files say more.

The wrappers: on a CPU tensor they run the plain version; on a CUDA tensor
they launch the kernel or raise.  There is no fallback.  Under a
``torch.func`` transform (the batched study's ``vmap`` over rollouts) a
CUDA call goes through a custom operator (``gpmpc::riccati_sweep``,
``gpmpc::rk4_substeps``) whose vmap rule launches the kernel once for the
whole batch; on CPU tensors the plain versions vmap as they are.  While a
step is traced (:func:`tracing`: ``utils/export.py`` under ``make_fx``) the
wrappers take their custom operators on either device, so the traced graph
names each kernel as one node (on the CPU the operator's body is the plain
version); each operator has a fake implementation for ``torch.export``,
and a launch outside its operator while tracing raises.  The shared library
is built with ``nvcc`` from ``csrc/*.cu`` at first use into the package's
own ``build/`` directory (one compiler process per source, all at once,
then one link; rebuilt when a source changes) and bound with ``ctypes``.
It holds K1 at the (nx, nu) pairs of :data:`RICCATI_SHAPES`; K1 at any
other pair the warp kernel admits (:func:`riccati_layout`) is built at its
first launch into a library of its own (:func:`riccati_entry`).  Every
other pair (nx >= 31 or nu > 32: :func:`riccati_path` says "block") takes
K1's block path, ``csrc/riccati_sweep_block.cu``: one thread block per
problem, nx and nu at run time, in the main library.
``LAUNCHES`` counts kernel launches, one per launch (a vmapped call of a
whole batch is one); ``K2_LAUNCHES`` K2's by functor id.
``check_riccati_sweep`` and ``check_rk4_substeps`` hold a kernel against
its plain version on the card, for the tests and the smoke script alike.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
import typing
from pathlib import Path

import numpy as np
import torch
from torch.fx.experimental.proxy_tensor import get_proxy_mode

from gpmpc_tpu_torch.ops.chol import chol_small, tri_solve_small

#: kernel launches by kernel name; a wrapper adds one where it launches
LAUNCHES = {"riccati_sweep": 0, "rk4_substeps": 0, "se_ard_gram": 0,
            "cholesky": 0, "gp_predict_batch": 0}
#: K1's launches by (nx, nu), counted with LAUNCHES["riccati_sweep"]
RICCATI_LAUNCHES = {}
#: K2's launches by ode_id, counted with LAUNCHES["rk4_substeps"]
K2_LAUNCHES = {}

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: a traced K2 unit's flags besides NVCC_FLAGS: no contraction of a product
#: and a sum into an FMA, so that each ATen op rounds once as PyTorch's
#: elementwise kernels do (the RK4 chain's own ``fmaf`` stay fused)
K2_TRACED_FLAGS = ("--fmad=false",)

#: (nx, nu) pairs the main library instantiates the Riccati kernel for
#: (and ``chip_smoke.py`` phase 3 holds): the four-tank main path, the JAX
#: package's kernel-test shapes, the car with the delta-u augmentation (nx
#: = 4 states + the previous 2 inputs; also the quadrotor's 6 states), and
#: the four-tank MHE (its NLP's input slot carries the 4 process noises).
#: Any other admitted pair is built at its first launch.
RICCATI_SHAPES = ((4, 2), (5, 3), (2, 1), (6, 2), (4, 4))

#: stages per shared-memory chunk of the Riccati kernel, at most: the
#: constant ``CHUNK`` of ``csrc/riccati_sweep.cu``, mirrored for tests that
#: cross its chunk boundaries
RICCATI_CHUNK = 32

#: the most dynamic shared memory one block may opt in to on an H100, in
#: bytes (227 KB): ``SMEM_OPTIN`` of ``csrc/riccati_sweep.cu``
RICCATI_SMEM_OPTIN = 232448

#: the hand-written functors compiled into the RK4 kernel: the ``cuda_ode``
#: tag -> (ode_id, nx, nu)
CUDA_ODES = {"four_tank": (0, 4, 2), "car": (1, 4, 2)}

_lib = None
#: what the last build did: seconds, library path, compiler output
BUILD_INFO = {}
#: K1's libraries built on demand, by (nx, nu): the library and what its
#: build did (seconds, path, compiler output)
RICCATI_BUILDS = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    RICCATI_LAUNCHES.clear()
    K2_LAUNCHES.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin or "
                       "/usr/local/cuda/bin): cannot build the CUDA kernels")


def _run_at_once(cmds) -> str:
    """Run the commands as concurrent processes; their joined output, or
    raise with the first failing command's output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for p, c, out in zip(procs, cmds, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(c)}\n{out}")
    return "".join(outs)


def library_path() -> Path:
    """Where the main library is built: keyed by a hash of the flags and
    of every ``csrc/*.cu`` and ``*.h`` (K1's block path among them)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.h")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libgpmpc_cuda_{digest.hexdigest()[:16]}.so"


def build_library() -> ctypes.CDLL:
    """Build (if its sources changed) and load the kernels' shared library:
    one ``nvcc`` per source, all at once, then one link."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(CSRC.glob("*.cu"))
    so = library_path()
    t0 = time.perf_counter()
    log = ""
    if not so.exists():
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        objs = [tmp.with_suffix(f".{src.stem}.o") for src in sources]
        try:
            log = _run_at_once([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o),
                                 str(src)] for src, o in zip(sources, objs)])
            log += _run_at_once([[nvcc, "-shared", "-o", str(tmp),
                                  *map(str, objs)]])
        finally:
            for o in objs:
                o.unlink(missing_ok=True)
        os.replace(tmp, so)
        for stale in BUILD_DIR.glob("libgpmpc_cuda_*.so"):
            if stale != so:
                stale.unlink(missing_ok=True)
    lib = ctypes.CDLL(str(so))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    _bind_riccati(lib)
    lib.gpmpc_riccati_sweep_block_f32.argtypes = [ptr] * 18 + [i32] * 4 + [
        ptr]
    lib.gpmpc_riccati_sweep_block_f32.restype = i32
    lib.gpmpc_riccati_block_layout.argtypes = [i32, i32, ptr]
    lib.gpmpc_riccati_block_layout.restype = None
    lib.gpmpc_rk4_substeps_f32.argtypes = [i32, ptr, ptr, ptr, i32, i32,
                                           ctypes.c_double, ptr]
    lib.gpmpc_rk4_substeps_f32.restype = i32
    lib.gpmpc_rk4_chain_cycles_f32.argtypes = [i32] + [ptr] * 4 + [
        i32, ctypes.c_double, ptr]
    lib.gpmpc_rk4_chain_cycles_f32.restype = i32
    lib.gpmpc_se_ard_gram_f32.argtypes = [ptr] * 4 + [ctypes.c_float, ptr] \
        + [i32] * 3 + [ptr]
    lib.gpmpc_se_ard_gram_f32.restype = i32
    lib.gpmpc_cholesky_f32.argtypes = [ptr] * 4 + [i32] * 3 + [ptr]
    lib.gpmpc_cholesky_f32.restype = i32
    lib.gpmpc_gp_predict_batch_f32.argtypes = [ptr] * 7 + [i32] * 4 + [ptr]
    lib.gpmpc_gp_predict_batch_f32.restype = i32
    lib.gpmpc_gp_predict_batch_multi_f32.argtypes = [ptr] * 7 + [i32] * 5 \
        + [ptr]
    lib.gpmpc_gp_predict_batch_multi_f32.restype = i32
    BUILD_INFO.update(seconds=time.perf_counter() - t0, path=str(so), log=log)
    _lib = lib
    return lib


def _bind_riccati(lib) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.gpmpc_riccati_sweep_f32.argtypes = [ptr] * 17 + [i32] * 4 + [ptr]
    lib.gpmpc_riccati_sweep_f32.restype = i32


def _riccati_floats(nx: int, nu: int, chunk: int) -> int:
    """Floats of one warp's shared memory at ``chunk`` stages a chunk: the
    ``LayoutAt<NX, NU, CH>::FLOATS`` of ``csrc/riccati_sweep.cu``."""
    def pad4(n):
        return (n + 3) & ~3

    xx, xu, uu = nx * nx, nx * nu, nu * nu
    # A, B, c, the five cost terms, the gains and feedforwards: two chunks
    staged = 2 * chunk * (xx + xu + nx + xx + uu + xu + nx + nu + xu + nu)
    # a chunk's du and dx rows, then V, v_x, A'V, B'V, Vc, H_xx, H_xu,
    # h_x, h_u and the ZERO and SINK cells
    rows = pad4(chunk * nu) + pad4((chunk + 1) * nx)
    stage = 3 * xx + 2 * xu + 3 * nx + nu + 2
    return pad4(staged + rows + stage)


def riccati_layout(nx: int, nu: int):
    """The warp kernel's shared memory at (nx, nu), as
    ``csrc/riccati_sweep.cu`` lays it out: (stages a chunk, bytes a warp,
    warps a block).  The chunk is RICCATI_CHUNK, halved while one warp
    would pass RICCATI_SMEM_OPTIN, down to 4; up to 4 warps share a block
    within 200 KB.  At 4 stages every pair within the lane limits fits
    (the largest, (30, 32), in 206592 bytes), so those limits are the only
    ones: a pair past them raises ``ValueError`` naming the limit (such a
    pair takes the block path: :func:`riccati_path`)."""
    if not 1 <= nx < 31:
        raise ValueError(f"riccati_sweep: nx={nx} is past the kernel's "
                         f"limit 1 <= nx < 31 (lane 31 of a problem's warp "
                         f"sums the predicted decrease)")
    if not 1 <= nu <= 32:
        raise ValueError(f"riccati_sweep: nu={nu} is past the kernel's "
                         f"limit 1 <= nu <= 32 (lane j of a problem's warp "
                         f"keeps row j of du)")
    chunk = RICCATI_CHUNK
    while chunk > 4 and 4 * _riccati_floats(nx, nu, chunk) > \
            RICCATI_SMEM_OPTIN:
        chunk //= 2
    warp_bytes = 4 * _riccati_floats(nx, nu, chunk)
    return chunk, warp_bytes, min(4, max(1, 200 * 1024 // warp_bytes))


#: threads of a problem's block on K1's block path: ``THREADS`` of
#: ``csrc/riccati_sweep_block.cu``
RICCATI_BLOCK_THREADS = 256


def riccati_path(nx: int, nu: int) -> str:
    """Which K1 kernel takes (nx, nu): ``"warp"`` (``csrc/riccati_sweep.cu``,
    a warp a problem) within its lane limits, nx < 31 and nu <= 32;
    ``"block"`` (``csrc/riccati_sweep_block.cu``, a block a problem) for
    every other pair.  nx < 1 or nu < 1 raises ``ValueError``."""
    if nx < 1 or nu < 1:
        raise ValueError(f"riccati_sweep: (nx, nu) = ({nx}, {nu}) is past "
                         f"the kernels' limits nx >= 1, nu >= 1")
    return "warp" if nx < 31 and nu <= 32 else "block"


class BlockLayout(typing.NamedTuple):
    """K1's block path at (nx, nu), as ``block_layout`` of
    ``csrc/riccati_sweep_block.cu`` lays it out."""
    buffers: int        # stage buffers in shared memory: 2, 1 or 0
    work_smem: bool     # the working set in shared memory, else workspace
    work_floats: int    # floats of the working set (a problem's workspace)
    smem_bytes: int     # dynamic shared memory of the launch, gains aside


#: columns of a Cholesky panel on K1's block path: ``PANEL`` of
#: ``csrc/riccati_sweep_block.cu``
RICCATI_BLOCK_PANEL = 32


def riccati_block_layout(nx: int, nu: int) -> BlockLayout:
    """The block path's layout at (nx, nu), mirroring the kernel: every
    array 16-byte aligned, the row strides of Z, V, S odd multiples of 4
    floats (``ld4``).  A stage buffer holds Z = [A B c] (nx rows of
    ld4(nx + nu + 1)) and QH, the cost terms laid out as H (nx + nu rows of
    Z's stride); the working set V (nx rows of ld4(nx)), v_x, M (as Z), H
    and h (nx + nu rows of Z's stride), H_uu's factor (pad4(nu) rows of the
    odd nu | 1), S (nu rows of ld4(nx + 1)), the current panel's factor
    (min(nu, 32) rows of min(nu, 32) | 1), the forward state twice and du.
    Two stage buffers beside the working set where they fit
    RICCATI_SMEM_OPTIN, else one; past that the working set goes to a
    workspace in device memory (``work_floats`` a problem) and the stages
    keep two buffers or one, or (past one) a buffer in the workspace.  The
    launch adds all Nt stages' gains to ``smem_bytes`` where they fit.  For
    nx = nu = n the working set leaves shared memory from n = 61."""
    def pad4(n):
        return (n + 3) & ~3

    def ld4(n):     # an odd multiple of 4 floats
        return pad4(n) if pad4(n) & 4 else pad4(n) + 4

    n = nx + nu
    ldn, ldv, lds, ldw = ld4(n + 1), ld4(nx), ld4(nx + 1), nu | 1
    pw = min(nu, RICCATI_BLOCK_PANEL)
    stage = nx * ldn + n * ldn
    work = (nx * ldv + ldv + nx * ldn + n * ldn + pad4(pad4(nu) * ldw)
            + nu * lds + pad4(pw * (pw | 1)) + 2 * ldv + pad4(nu))
    optin = RICCATI_SMEM_OPTIN // 4
    if work + 2 * stage <= optin:
        buffers, work_smem = 2, True
    elif work + stage <= optin:
        buffers, work_smem = 1, True
    else:
        work_smem = False
        buffers = 2 if 2 * stage <= optin else (1 if stage <= optin else 0)
        if buffers == 0:
            work += stage
    smem = 4 * (buffers * stage + (work if work_smem else 0))
    return BlockLayout(buffers, work_smem, work, smem or 16)


def _riccati_block_entry(nx: int, nu: int):
    """The block path's launch at (nx, nu) with the warp kernel's C
    signature (17 arrays, batch, nt, nx, nu, stream): the main library's
    ``gpmpc_riccati_sweep_block_f32``, given a workspace of ``batch x
    work_floats`` floats from ``torch.empty`` on the current device where
    the working set passes shared memory."""
    fn = build_library().gpmpc_riccati_sweep_block_f32
    layout = riccati_block_layout(nx, nu)

    def entry(*args):
        arrays, (bsz, nt, nx_, nu_, stream) = args[:17], args[17:]
        ws = None
        if not layout.work_smem:
            ws = torch.empty(bsz * layout.work_floats, dtype=torch.float32,
                             device=torch.cuda.current_device())
        return fn(*arrays, None if ws is None else ws.data_ptr(), bsz, nt,
                  nx_, nu_, stream)

    return entry


def riccati_unit_source(nx: int, nu: int) -> str:
    """The compilation unit of K1 at (nx, nu) alone: ``csrc/riccati_sweep.cu``
    with its C entry instantiated for that pair."""
    return (f"// K1 at (nx, nu) = ({nx}, {nu}) alone, built at its first "
            f"launch\n// by gpmpc_tpu_torch/ops/cuda_kernels.py.\n"
            f"#define GPMPC_RICCATI_NX {nx}\n#define GPMPC_RICCATI_NU {nu}\n"
            f'#include "riccati_sweep.cu"\n')


def riccati_library_path(nx: int, nu: int) -> Path:
    """Where K1's library for (nx, nu) is built: keyed by the pair and a
    hash of the flags and ``csrc/riccati_sweep.cu``."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    digest.update((CSRC / "riccati_sweep.cu").read_bytes())
    return BUILD_DIR / (f"libgpmpc_riccati_{nx}x{nu}_"
                        f"{digest.hexdigest()[:16]}.so")


def _build_riccati_shape(nx: int, nu: int) -> ctypes.CDLL:
    """Build (if its source changed) and load K1's library for (nx, nu)."""
    so = riccati_library_path(nx, nu)
    t0 = time.perf_counter()
    log = ""
    if not so.exists():
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        unit = so.with_suffix(f".{os.getpid()}.cu")
        unit.write_text(riccati_unit_source(nx, nu))
        try:
            log = _run_at_once([[nvcc, *NVCC_FLAGS, "-I", str(CSRC),
                                 "-shared", "-o", str(tmp), str(unit)]])
        finally:
            unit.unlink(missing_ok=True)
        os.replace(tmp, so)
        for stale in BUILD_DIR.glob(f"libgpmpc_riccati_{nx}x{nu}_*.so"):
            if stale != so:
                stale.unlink(missing_ok=True)
    lib = ctypes.CDLL(str(so))
    _bind_riccati(lib)
    RICCATI_BUILDS[(nx, nu)] = dict(lib=lib, seconds=time.perf_counter() - t0,
                                    path=str(so), log=log)
    return lib


def riccati_entry(nx: int, nu: int):
    """K1's C entry for (nx, nu), the one lookup of every launch: on the
    warp path the main library's for :data:`RICCATI_SHAPES`, else that of
    the pair's own library, built at its first use; on the block path
    (:func:`riccati_path`) the main library's block entry, which serves
    every pair.  nx < 1 or nu < 1 raises ``ValueError`` before any
    build."""
    if riccati_path(nx, nu) == "block":
        return _riccati_block_entry(nx, nu)
    if (nx, nu) in RICCATI_SHAPES:
        return build_library().gpmpc_riccati_sweep_f32
    if (nx, nu) in RICCATI_BUILDS:
        return RICCATI_BUILDS[(nx, nu)]["lib"].gpmpc_riccati_sweep_f32
    riccati_layout(nx, nu)
    return _build_riccati_shape(nx, nu).gpmpc_riccati_sweep_f32


def _check_cuda(name, tensors, shapes):
    """Raise unless every tensor is contiguous float32 of its expected shape
    on the first one's device (``shapes`` lists the arguments in order)."""
    dev = tensors[0].device
    for key, t in zip(shapes, tensors):
        if not torch.is_tensor(t) or t.device != dev:
            raise ValueError(f"{name}: {key} must be a tensor on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32, got {t.dtype}")
        if tuple(t.shape) != shapes[key]:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {shapes[key]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def tracing() -> bool:
    """Whether a ``make_fx`` trace is recording the calls (its proxy mode
    is on the dispatch stack).  Inside a custom operator's own body the
    tracer has stepped aside, so this is False where the kernel launches
    for the trace."""
    return get_proxy_mode() is not None


def _refuse_launch_under_trace(name) -> None:
    """Raise where a kernel would launch outside its custom operator while
    a trace records: the graph would hold its empty outputs and lose the
    launch."""
    if tracing():
        raise RuntimeError(
            f"{name}: the kernel would launch outside its custom operator "
            f"while a trace records the calls; the traced graph would lose "
            f"it (call it through its operator)")


def _raise_on_error(name, code):
    if code != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{code}")


# ------------------------------------------------------------- K1: Riccati

def riccati_sweep_reference(a, b, c, q_xx, q_uu, q_xu, q_x, q_u, qf_xx,
                            qf_x, dx0, reg):
    """Plain PyTorch version of the Riccati sweep kernel: same math and
    outputs.  Stage arrays as in ``riccati.StageQP`` with an optional
    leading batch dim; ``reg`` a scalar or (B,).  Returns ``(dx (...,Nt+1,nx),
    du (...,Nt,nu), gains (...,Nt,nu,nx), ffs (...,Nt,nu), exp_dec (...))``."""
    nt, nx, nu = b.shape[-3:]
    reg = torch.as_tensor(reg, dtype=b.dtype, device=b.device)
    eye_u = torch.eye(nu, dtype=b.dtype, device=b.device)
    reg_eye = reg.reshape(reg.shape + (1, 1)) * eye_u

    def mv(m, v):
        return (m @ v[..., None])[..., 0]

    v_xx, v_x = qf_xx, qf_x
    gains, ffs = [None] * nt, [None] * nt
    dec = torch.zeros(b.shape[:-3], dtype=b.dtype, device=b.device)
    for t in range(nt - 1, -1, -1):
        at, bt, ct = a[..., t, :, :], b[..., t, :, :], c[..., t, :]
        av = at.mT @ v_xx
        bv = bt.mT @ v_xx
        h_xx = q_xx[..., t, :, :] + av @ at
        h_uu = q_uu[..., t, :, :] + bv @ bt + reg_eye
        h_xu = q_xu[..., t, :, :] + av @ bt
        vc = v_x + mv(v_xx, ct)
        h_x = q_x[..., t, :] + mv(at.mT, vc)
        h_u = q_u[..., t, :] + mv(bt.mT, vc)
        l = chol_small(h_uu, clamp=False)
        rhs = torch.cat([h_xu.mT, h_u[..., None]], dim=-1)   # (nu, nx+1)
        sol = tri_solve_small(l, tri_solve_small(l, rhs), trans=True)
        k_gain, k_ff = -sol[..., :nx], -sol[..., nx]
        gains[t], ffs[t] = k_gain, k_ff
        v_xx = h_xx + h_xu @ k_gain
        v_xx = 0.5 * (v_xx + v_xx.mT)
        v_x = h_x + mv(h_xu, k_ff)
        dec = dec - torch.sum(k_ff * (h_u + 0.5 * mv(h_uu, k_ff)), dim=-1)

    dx = dx0
    dxs, dus = [], []
    for t in range(nt):
        du = ffs[t] + mv(gains[t], dx)
        dxs.append(dx)
        dus.append(du)
        dx = mv(a[..., t, :, :], dx) + mv(b[..., t, :, :], du) + c[..., t, :]
    dxs.append(dx)
    return (torch.stack(dxs, dim=-2), torch.stack(dus, dim=-2),
            torch.stack(gains, dim=-3), torch.stack(ffs, dim=-2), dec)


def _functorch_wrapped(*tensors) -> bool:
    """Whether any tensor is wrapped by a ``torch.func`` transform (a
    ``vmap`` batch): then it has no ``data_ptr`` to hand to a kernel."""
    return any(torch._C._functorch.is_functorch_wrapped_tensor(t)
               for t in tensors)


def _to_front(info, in_dims, args):
    """The arguments of a vmapped custom operator with the vmapped dim in
    front, unbatched ones expanded to the batch, all contiguous."""
    return [(a.movedim(d, 0) if d is not None
             else a.expand((info.batch_size,) + a.shape)).contiguous()
            for a, d in zip(args, in_dims)]


def riccati_sweep(a, b, c, q_xx, q_uu, q_xu, q_x, q_u, qf_xx, qf_x, dx0,
                  reg):
    """K1 wrapper: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors.  Same signature and outputs as
    :func:`riccati_sweep_reference`; on CUDA every argument, ``reg`` and
    ``dx0`` included, must be a contiguous float32 tensor on the card.
    Under ``torch.func.vmap`` on the card the call goes through the custom
    operator ``gpmpc::riccati_sweep``, whose vmap rule makes one batched
    launch for the whole batch; while a trace records (:func:`tracing`)
    it goes through the operator on either device."""
    args = (a, b, c, q_xx, q_uu, q_xu, q_x, q_u, qf_xx, qf_x, dx0, reg)
    traced = tracing()
    if a.device.type == "cpu" and not traced:
        return riccati_sweep_reference(*args)
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"riccati_sweep: no kernel for device {a.device}")
    if traced or _functorch_wrapped(*args):
        return tuple(riccati_sweep_op(*args))
    return _riccati_sweep_launch(*args)


def _riccati_sweep_launch(a, b, c, q_xx, q_uu, q_xu, q_x, q_u, qf_xx, qf_x,
                          dx0, reg):
    """Launch K1 on plain CUDA tensors (one problem, or a leading batch)."""
    batched = a.ndim == 4
    nt, nx, nu = b.shape[-3:]
    bsz = a.shape[0] if batched else 1
    lead = (bsz,) if batched else ()
    shapes = dict(a=lead + (nt, nx, nx), b=lead + (nt, nx, nu),
                  c=lead + (nt, nx), q_xx=lead + (nt, nx, nx),
                  q_uu=lead + (nt, nu, nu), q_xu=lead + (nt, nx, nu),
                  q_x=lead + (nt, nx), q_u=lead + (nt, nu),
                  qf_xx=lead + (nx, nx), qf_x=lead + (nx,), dx0=lead + (nx,),
                  reg=lead)
    args = (a, b, c, q_xx, q_uu, q_xu, q_x, q_u, qf_xx, qf_x, dx0, reg)
    _check_cuda("riccati_sweep", args, shapes)
    _refuse_launch_under_trace("riccati_sweep")
    entry = riccati_entry(nx, nu)
    kw = dict(dtype=torch.float32, device=a.device)
    dx = torch.empty(lead + (nt + 1, nx), **kw)
    du = torch.empty(lead + (nt, nu), **kw)
    gains = torch.empty(lead + (nt, nu, nx), **kw)
    ffs = torch.empty(lead + (nt, nu), **kw)
    dec = torch.empty(lead, **kw)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        code = entry(
            *(t.data_ptr() for t in args),
            *(t.data_ptr() for t in (dx, du, gains, ffs, dec)),
            bsz, nt, nx, nu, stream)
    _raise_on_error("riccati_sweep", code)
    LAUNCHES["riccati_sweep"] += 1
    RICCATI_LAUNCHES[(nx, nu)] = RICCATI_LAUNCHES.get((nx, nu), 0) + 1
    return dx, du, gains, ffs, dec


@torch.library.custom_op("gpmpc::riccati_sweep", mutates_args=())
def riccati_sweep_op(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                     q_xx: torch.Tensor, q_uu: torch.Tensor,
                     q_xu: torch.Tensor, q_x: torch.Tensor,
                     q_u: torch.Tensor, qf_xx: torch.Tensor,
                     qf_x: torch.Tensor, dx0: torch.Tensor,
                     reg: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor, torch.Tensor]:
    """K1 as a custom operator, the form :func:`riccati_sweep` takes under
    ``torch.func.vmap`` on the card and in a traced step: the kernel for
    CUDA tensors, the plain version for CPU tensors (where the vmap rule
    can be tested)."""
    args = (a, b, c, q_xx, q_uu, q_xu, q_x, q_u, qf_xx, qf_x, dx0, reg)
    if a.device.type == "cpu":
        return tuple(t.clone() for t in riccati_sweep_reference(*args))
    return _riccati_sweep_launch(*args)


@riccati_sweep_op.register_fake
def _riccati_sweep_fake(a, b, c, q_xx, q_uu, q_xu, q_x, q_u, qf_xx, qf_x,
                        dx0, reg):
    """The outputs' shapes and dtype: ``dx (..., Nt+1, nx)``, ``du (...,
    Nt, nu)``, ``gains (..., Nt, nu, nx)``, ``ffs (..., Nt, nu)``,
    ``exp_dec (...)`` for stage arrays with an optional batch dim."""
    *lead, nt, nx, nu = b.shape
    lead = tuple(lead)
    return (b.new_empty(lead + (nt + 1, nx)), b.new_empty(lead + (nt, nu)),
            b.new_empty(lead + (nt, nu, nx)), b.new_empty(lead + (nt, nu)),
            b.new_empty(lead))


@riccati_sweep_op.register_vmap
def _riccati_sweep_vmap(info, in_dims, *args):
    """One call (one K1 launch on the card) for the whole batch: the
    vmapped dim moved to the front, unbatched arguments expanded."""
    return riccati_sweep_op(*_to_front(info, in_dims, args)), (0,) * 5


# ----------------------------------------------------------------- K2: RK4

class K2Spec(typing.NamedTuple):
    """One functor of K2: ``ode_id`` (0 ``FourTank``, 1 ``Car``, >= 2 a
    traced one), a name, its (nx, nu), the callable whose plain version it
    computes and, for a traced functor, its generated
    :class:`~gpmpc_tpu_torch.ops.ode_trace.Functor`."""
    ode_id: int
    name: str
    nx: int
    nu: int
    ode: typing.Callable
    functor: typing.Any = None


#: K2's functors by ode_id: the hand-written ones, then each traced one
#: as :func:`register_ode` meets it
K2_SPECS = {}
#: a traced functor's ode_id by the SHA-256 of its text
_K2_BY_DIGEST = {}
#: the traced functors' libraries, by ode_id: the library and what its
#: build did (seconds, path, compiler output)
K2_BUILDS = {}


def _compiled_in_spec(tag):
    """The spec of a hand-written functor (its ODE from ``systems``)."""
    from gpmpc_tpu_torch import systems
    ode_id, nx, nu = CUDA_ODES[tag]
    if ode_id not in K2_SPECS:
        K2_SPECS[ode_id] = K2Spec(ode_id, tag, nx, nu,
                                  getattr(systems, f"{tag}_ode"))
    return K2_SPECS[ode_id]


def register_ode(ode, nx: int, nu: int, device=None) -> K2Spec:
    """K2's functor for ``ode`` at (nx, nu).  An ODE with a ``cuda_ode``
    tag of :data:`CUDA_ODES` (``systems.four_tank_ode``, ``car_ode`` as
    they are) takes its hand-written functor.  Any other is traced on one
    point on ``device`` and lowered into a generated functor
    (:func:`gpmpc_tpu_torch.ops.ode_trace.compile_ode`; an op outside the
    lowering or a branch on the data raises ``ValueError`` naming it) at
    each call; equal programs share one ode_id and one library.  A
    closure's tensors are read here.  A caller that launches again keeps
    the spec and hands it to :func:`rk4_substeps`, as ``Model`` does."""
    tag = getattr(ode, "cuda_ode", None)
    if tag in CUDA_ODES:
        spec = _compiled_in_spec(tag)
    else:
        from gpmpc_tpu_torch.ops.ode_trace import compile_ode
        functor = compile_ode(ode, nx, nu, device)
        if functor.digest in _K2_BY_DIGEST:
            spec = K2_SPECS[_K2_BY_DIGEST[functor.digest]]
        else:
            ode_id = max([len(CUDA_ODES) - 1, *K2_SPECS]) + 1
            spec = K2Spec(ode_id, f"traced_{functor.digest[:16]}", nx, nu,
                          ode, functor)
            K2_SPECS[ode_id] = spec
            _K2_BY_DIGEST[functor.digest] = ode_id
    if (spec.nx, spec.nu) != (nx, nu):
        raise ValueError(f"rk4_substeps: the {spec.name} functor takes (nx, "
                         f"nu) = ({spec.nx}, {spec.nu}), got ({nx}, {nu})")
    return spec


def traced_unit_source(functor) -> str:
    """The compilation unit of a traced functor: its source, then
    ``csrc/rk4_substeps.cu`` with its traced entries instantiated for it
    alone."""
    return (f"// K2 for a traced plant ODE alone, built at its first launch "
            f"by\n// gpmpc_tpu_torch/ops/cuda_kernels.py.\n"
            f'#include "rk4_chain.h"\n\n{functor.source}\n'
            f"#define GPMPC_RK4_TRACED {functor.name}\n"
            f'#include "rk4_substeps.cu"\n')


def k2_library_path(functor) -> Path:
    """Where a traced functor's library is built: keyed by the functor's
    name and a hash of its unit, the flags, ``csrc/rk4_substeps.cu`` and
    ``csrc/rk4_chain.h``."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + K2_TRACED_FLAGS).encode())
    digest.update(traced_unit_source(functor).encode())
    for src in ("rk4_substeps.cu", "rk4_chain.h"):
        digest.update((CSRC / src).read_bytes())
    return BUILD_DIR / (f"libgpmpc_rk4_{functor.name}_"
                        f"{digest.hexdigest()[:16]}.so")


def _bind_k2_traced(lib) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.gpmpc_rk4_traced_f32.argtypes = [ptr] * 3 + [i32, i32,
                                                     ctypes.c_double, ptr]
    lib.gpmpc_rk4_traced_f32.restype = i32
    lib.gpmpc_rk4_traced_chain_cycles_f32.argtypes = [ptr] * 4 + [
        i32, ctypes.c_double, ptr]
    lib.gpmpc_rk4_traced_chain_cycles_f32.restype = i32


def prebuild(specs) -> dict:
    """Build the traced functors of ``specs`` not yet loaded, one ``nvcc``
    each, all at once, and load them.  Returns {ode_id: seconds of the
    build} for those it loaded (0 where the library was already on disk)."""
    todo = {}
    for spec in specs:
        if spec.functor is not None and spec.ode_id not in K2_BUILDS:
            todo.setdefault(spec.ode_id, spec)
    if not todo:
        return {}
    t0 = time.perf_counter()
    cmds, units, tmps = [], [], {}
    for ode_id, spec in todo.items():
        so = k2_library_path(spec.functor)
        if so.exists():
            continue
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        unit = so.with_suffix(f".{os.getpid()}.cu")
        unit.write_text(traced_unit_source(spec.functor))
        units.append(unit)
        tmps[ode_id] = (tmp, so, spec.functor.name)
        cmds.append([nvcc, *NVCC_FLAGS, *K2_TRACED_FLAGS, "-I", str(CSRC),
                     "-shared", "-o", str(tmp), str(unit)])
    log = ""
    try:
        if cmds:
            log = _run_at_once(cmds)
    finally:
        for unit in units:
            unit.unlink(missing_ok=True)
    for tmp, so, name in tmps.values():
        os.replace(tmp, so)
        for stale in BUILD_DIR.glob(f"libgpmpc_rk4_{name}_*.so"):
            if stale != so:
                stale.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    out = {}
    for ode_id, spec in todo.items():
        so = k2_library_path(spec.functor)
        lib = ctypes.CDLL(str(so))
        _bind_k2_traced(lib)
        out[ode_id] = seconds if ode_id in tmps else 0.0
        K2_BUILDS[ode_id] = dict(lib=lib, seconds=out[ode_id], path=str(so),
                                 log=log)
    return out


def k2_entry(spec: K2Spec):
    """The C entry that launches K2 for ``spec``: the main library's
    ``gpmpc_rk4_substeps_f32`` bound to a hand-written functor's ode_id, or
    a traced functor's ``gpmpc_rk4_traced_f32`` from its own library,
    built at its first use.  Both take (x, u, out, batch, n_sub, h,
    stream)."""
    if spec.functor is None:
        fn = build_library().gpmpc_rk4_substeps_f32
        return lambda *a: fn(spec.ode_id, *a)
    if spec.ode_id not in K2_BUILDS:
        prebuild([spec])
    return K2_BUILDS[spec.ode_id]["lib"].gpmpc_rk4_traced_f32


def rk4_substeps_reference(ode, x, u, h: float, n_sub: int):
    """Plain PyTorch version of the RK4 substep kernel: ``n_sub`` RK4 steps
    of size ``h`` of ``ode(x, u)``; x (..., nx), u (..., nu)."""
    for _ in range(n_sub):
        k1 = ode(x, u)
        k2 = ode(x + 0.5 * h * k1, u)
        k3 = ode(x + 0.5 * h * k2, u)
        k4 = ode(x + h * k3, u)
        x = x + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    return x


def rk4_substeps_rollouts(ode, x, u, h: float, n_sub: int):
    """The plain version as the kernel maps it: over each rollout of a
    batch (B, nx), (B, nu) on its own (an ODE written for one point
    serves), else on the one point."""
    if x.ndim == 2:
        return torch.func.vmap(
            lambda a, b: rk4_substeps_reference(ode, a, b, h, n_sub))(x, u)
    return rk4_substeps_reference(ode, x, u, h, n_sub)


#: a traced functor's id is a number of this process: an exported graph
#: cannot carry it
TRACED_EXPORT_LIMIT = (
    "a traced ODE's K2 cannot be recorded into an exported graph: its "
    "ode_id names a functor traced and built in this process and means "
    "nothing in another (ROADMAP §2 item 2, traced K2 under export); "
    "export a step without the plant, or a plant with a hand-written "
    "functor")


def rk4_substeps(ode, x, u, h: float, n_sub: int, spec: K2Spec = None):
    """K2 wrapper: the plain version for CPU tensors (over each rollout of
    a batch, as the kernel maps it), the CUDA kernel for CUDA tensors.
    x (nx,) or (B, nx), u (nu,) or (B, nu); on CUDA both
    contiguous float32 on the card; ``ode`` any ODE, its functor ``spec``
    from :func:`register_ode` (hand-written for a tagged ODE, else traced,
    and built at its first launch), registered here when not given.  Under ``torch.func.vmap`` on the card the call
    goes through the custom operator ``gpmpc::rk4_substeps``, whose vmap
    rule makes one batched launch; while a trace records (:func:`tracing`)
    it goes through the operator on either device for a hand-written
    functor, raises for a traced one on the card, and runs the plain
    version on the CPU otherwise."""
    traced = tracing()
    tag = getattr(ode, "cuda_ode", None)
    if x.device.type == "cpu" and not (traced and tag in CUDA_ODES):
        return rk4_substeps_rollouts(ode, x, u, h, n_sub)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rk4_substeps: no kernel for device {x.device}")
    if spec is None:
        spec = register_ode(ode, x.shape[-1], u.shape[-1], x.device)
    if traced and spec.functor is not None:
        raise RuntimeError(f"rk4_substeps: {TRACED_EXPORT_LIMIT}")
    if traced or _functorch_wrapped(x, u):
        return rk4_substeps_op(x, u, spec.ode_id, float(h), int(n_sub))
    return _rk4_substeps_launch(spec, x, u, h, n_sub)


def _rk4_substeps_launch(spec, x, u, h: float, n_sub: int):
    """Launch K2 on plain CUDA tensors for the functor ``spec``."""
    batched = x.ndim == 2
    bsz = x.shape[0] if batched else 1
    lead = (bsz,) if batched else ()
    _check_cuda("rk4_substeps", (x, u),
                dict(x=lead + (spec.nx,), u=lead + (spec.nu,)))
    _refuse_launch_under_trace("rk4_substeps")
    entry = k2_entry(spec)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = entry(x.data_ptr(), u.data_ptr(), out.data_ptr(), bsz,
                     int(n_sub), float(h), stream)
    _raise_on_error("rk4_substeps", code)
    LAUNCHES["rk4_substeps"] += 1
    K2_LAUNCHES[spec.ode_id] = K2_LAUNCHES.get(spec.ode_id, 0) + 1
    return out


def is_traced_ode_id(ode_id: int) -> bool:
    """Whether ``ode_id`` names a traced functor (one of this process), not
    a hand-written one."""
    return ode_id not in {i for i, _, _ in CUDA_ODES.values()}


def _spec_of_id(ode_id: int) -> K2Spec:
    """The functor registered as ``ode_id``."""
    for tag, (i, _, _) in CUDA_ODES.items():
        if i == ode_id:
            return _compiled_in_spec(tag)
    if ode_id not in K2_SPECS:
        raise ValueError(f"rk4_substeps: no functor with ode_id {ode_id} in "
                         f"this process")
    return K2_SPECS[ode_id]


@torch.library.custom_op("gpmpc::rk4_substeps", mutates_args=())
def rk4_substeps_op(x: torch.Tensor, u: torch.Tensor, ode_id: int, h: float,
                    n_sub: int) -> torch.Tensor:
    """K2 as a custom operator over the functor ``ode_id``, the form
    :func:`rk4_substeps` takes under ``torch.func.vmap`` on the card and in
    a traced step: the kernel for CUDA tensors; for CPU tensors the plain
    version of the registered callable (a traced functor's over each
    rollout of a batch, as its kernel maps it: its ODE may be written for
    one point; a hand-written functor's ODE takes the batch as it is)."""
    spec = _spec_of_id(ode_id)
    if x.device.type == "cpu":
        plain = (rk4_substeps_reference if spec.functor is None
                 else rk4_substeps_rollouts)
        return plain(spec.ode, x, u, h, n_sub).clone()
    return _rk4_substeps_launch(spec, x, u, h, n_sub)


@rk4_substeps_op.register_fake
def _rk4_substeps_fake(x, u, ode_id, h, n_sub):
    """The output: the state's shape and dtype."""
    return torch.empty_like(x)


@rk4_substeps_op.register_vmap
def _rk4_substeps_vmap(info, in_dims, x, u, ode_id, h, n_sub):
    """One call (one K2 launch on the card) for the whole batch."""
    xb, ub = _to_front(info, in_dims[:2], (x, u))
    return rk4_substeps_op(xb, ub, ode_id, h, n_sub), 0


# ------------------------------------------ kernels against plain versions

def stage_qp_inputs(nt, nx, nu, seed, batch=None, device=None):
    """Random well-posed stage QPs, those of the JAX package's kernel test:
    the eleven f32 array arguments of :func:`riccati_sweep` before ``reg``,
    with a leading batch dim when ``batch`` is given."""
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    a = 0.9 * np.eye(nx) + 0.05 * rng.standard_normal(lead + (nt, nx, nx))
    m = rng.standard_normal(lead + (nt, nx, nx))
    arrays = (a, 0.3 * rng.standard_normal(lead + (nt, nx, nu)),
              0.02 * rng.standard_normal(lead + (nt, nx)),
              0.5 * (m @ np.swapaxes(m, -1, -2)) + 2.0 * np.eye(nx),
              0.5 * np.broadcast_to(np.eye(nu), lead + (nt, nu, nu)),
              0.1 * rng.standard_normal(lead + (nt, nx, nu)),
              0.1 * rng.standard_normal(lead + (nt, nx)),
              0.1 * rng.standard_normal(lead + (nt, nu)),
              5.0 * np.broadcast_to(np.eye(nx), lead + (nx, nx)),
              0.1 * rng.standard_normal(lead + (nx,)),
              0.3 * rng.standard_normal(lead + (nx,)))
    return [torch.tensor(np.ascontiguousarray(x), dtype=torch.float32,
                         device=device) for x in arrays]


def rk4_inputs(batch, seed, device=None):
    """Plant states and inputs for K2's checks: tank levels |N(0,1)| * 4 +
    0.5, the first rollout's fourth tank drained to 0 (the 1e-6 clamp) when
    ``batch`` is given, pump voltages |N(0,1)| * 3; f32 (4,) and (2,) for
    one rollout when ``batch`` is None, else (batch, 4) and (batch, 2)."""
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    x = np.abs(rng.standard_normal(lead + (4,))) * 4 + 0.5
    if batch is not None:
        x[0, 3] = 0.0
    kw = dict(dtype=torch.float32, device=device)
    return (torch.tensor(x, **kw),
            torch.tensor(np.abs(rng.standard_normal(lead + (2,))) * 3, **kw))


def car_inputs(batch, seed, device=None):
    """Car states and inputs for K2's checks: positions in [-2, 20] x
    [-2, 2], headings in [-4, 4] (past +-pi), speeds in [0, 8],
    accelerations in [-3, 3] and steering in [-0.5, 0.5] rad; with a batch
    the first four rollouts steer at +0.5 and -0.5 rad and head at
    +-(pi + 0.3).  f32 (4,) and (2,) for one rollout when ``batch`` is
    None, else (batch, 4) and (batch, 2)."""
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    x = rng.uniform([-2.0, -2.0, -4.0, 0.0], [20.0, 2.0, 4.0, 8.0],
                    lead + (4,))
    u = rng.uniform([-3.0, -0.5], [3.0, 0.5], lead + (2,))
    if batch is not None and batch >= 4:
        u[:4, 1] = [0.5, -0.5, 0.5, -0.5]
        x[:4, 2] = [np.pi + 0.3, -np.pi - 0.3, -np.pi - 0.3, np.pi + 0.3]
    kw = dict(dtype=torch.float32, device=device)
    return torch.tensor(x, **kw), torch.tensor(u, **kw)


def riccati_check_tolerances(args, reg, ref, widen: bool = True):
    """The tolerances :func:`check_riccati_sweep` holds K1 to, given the
    plain version's outputs ``ref`` on ``args``: dx and du within 1e-5 x
    (1 + max|dx|), the gains and feedforwards within 2e-5 and the
    predicted decrease within rtol 1e-4 (atol 1e-6), the JAX package's
    kernel-test tolerances.  With ``widen``, on the block path
    (:func:`riccati_path`) the first four widen to 3x the plain version's
    own f32-versus-f64 gap on the same inputs where that is larger (two
    f32 sweeps that round in other orders part by up to twice it; at (40,
    40) the gap reaches 1.6e-5 in the gains), never past 1e-4 x (1 +
    max|dx|)."""
    scale = float(ref[0].abs().max()) + 1.0
    tols = [1e-5 * scale, 1e-5 * scale, 2e-5, 2e-5,
            1e-6 + 1e-4 * float(ref[4].abs().max())]
    nx, nu = args[1].shape[-2:]
    if widen and riccati_path(nx, nu) == "block":
        ref64 = riccati_sweep_reference(*(a.double() for a in args),
                                        reg.double())
        for i in range(4):
            gap = float((ref[i].double() - ref64[i]).abs().max())
            tols[i] = min(max(tols[i], 3.0 * gap), 1e-4 * scale)
    return tols


def check_riccati_sweep(args, reg, vmapped: bool = False) -> float:
    """Launch K1 on CUDA tensors and its plain version on the same tensors;
    raise unless they agree within :func:`riccati_check_tolerances` (its
    f64 run only where the unwidened tolerances are passed).  With
    ``vmapped`` the batched arguments go through ``torch.func.vmap`` of
    the wrapper (its custom operator's vmap rule).  Returns the largest
    absolute difference."""
    got = (torch.func.vmap(riccati_sweep)(*args, reg) if vmapped
           else riccati_sweep(*args, reg))
    ref = riccati_sweep_reference(*args, reg)
    errs = [float((g - r).abs().max()) for g, r in zip(got, ref)]
    tols = riccati_check_tolerances(args, reg, ref, widen=False)
    if not all(e <= t for e, t in zip(errs, tols)):
        # the f64 run that may widen them, only where they are passed
        tols = riccati_check_tolerances(args, reg, ref)
    if not all(g.shape == r.shape for g, r in zip(got, ref)) or not all(
            e <= t for e, t in zip(errs, tols)):
        raise AssertionError(
            f"riccati_sweep disagrees with its plain version at (Nt, nx, "
            f"nu)={tuple(args[1].shape[-3:])}: max|err| of dx, du, gains, "
            f"ffs, exp_dec {errs} > {tols}")
    return max(errs)


def check_riccati_sweep_bad_pivot(kind: str, device=None,
                                  shape=None) -> None:
    """Launch K1 at reg = 0 on stage QPs whose H_uu has a bad pivot, and
    raise unless the gains come out non-finite: ``kind="indefinite"`` sets
    q_uu to -(0.5 + 5 |B_t|_F^2) I (by default Nt=8, nx=2, nu=1), so that
    the last stage's H_uu = q_uu + B'(5 I)B is negative definite at any
    width (a negated q_uu alone is outweighed by B'VB once nx is wide);
    ``kind="zero"`` sets B and q_uu to 0, so H_uu = 0 (by default Nt=20,
    nx=4, nu=2).  ``shape`` (Nt, nx, nu) overrides the default."""
    if kind not in ("indefinite", "zero"):
        raise ValueError(f"unknown bad-pivot case {kind!r}")
    nt, nx, nu = shape or ((8, 2, 1) if kind == "indefinite" else (20, 4, 2))
    args = stage_qp_inputs(nt, nx, nu, 2 if kind == "indefinite" else 5,
                           device=device)
    if kind == "indefinite":
        frob = (args[1] ** 2).sum(dim=(-2, -1))
        args[4] = -(0.5 + 5.0 * frob)[:, None, None] * torch.eye(
            nu, device=args[4].device)
    else:
        args[1] = torch.zeros_like(args[1])
        args[4] = torch.zeros_like(args[4])
    gains = riccati_sweep(*args, torch.zeros((), device=device))[2]
    if bool(torch.all(torch.isfinite(gains))):
        raise AssertionError(f"riccati_sweep gave finite gains for a {kind} "
                             f"H_uu pivot")


def check_rk4_substeps(ode, x, u, h: float, n_sub: int,
                       spec: K2Spec = None) -> float:
    """Launch K2 on CUDA tensors and its plain version on the same tensors
    (over each rollout of a batch, as the kernel maps it); raise unless
    they agree within rtol 1e-5, atol 1e-6 (looser than on the CPU: the
    hand-written functors combine the RK4 stages by FMAs and FourTank
    takes its square roots by MUFU.RSQ; a traced functor divides where
    PyTorch's CUDA kernel multiplies by a scalar divisor's reciprocal).
    ``spec`` as :func:`rk4_substeps` takes it.  Returns the largest
    absolute difference."""
    got = rk4_substeps(ode, x, u, h, n_sub, spec=spec)
    ref = rk4_substeps_rollouts(ode, x, u, h, n_sub)
    err = float((got - ref).abs().max())
    if got.shape != ref.shape or not bool(
            torch.all((got - ref).abs() <= 1e-6 + 1e-5 * ref.abs())):
        raise AssertionError(f"rk4_substeps disagrees with its plain version:"
                             f" max|err| {err} (rtol 1e-5, atol 1e-6)")
    return err
