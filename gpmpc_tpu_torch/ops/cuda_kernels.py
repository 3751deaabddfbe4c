"""Hand-written CUDA kernels of the control path, their plain PyTorch
versions, the wrappers that choose between them by the device of the
tensors, and the build of the one library that holds every kernel.

Counterpart of ``gpmpc_tpu/ops/pallas_kernels.py``.  Two kernels here, both
CUDA C++ for ``sm_90a`` in ``gpmpc_tpu_torch/csrc/``:

* K1 ``riccati_sweep`` replaces ``pallas_kernels.py:riccati_sweep_pallas``:
  the whole backward Riccati factorization of the stage-QP KKT system plus
  the forward rollout, in one launch.
* K2 ``rk4_substeps`` replaces ``pallas_kernels.py:rk4_substeps_pallas``:
  ``n_sub`` RK4 substeps of the plant ODE in one launch.

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
state in registers, its square roots by one MUFU.RSQ each and the main
path's n_sub = 10 compiled in.  The source files say more.

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
other pair the kernel admits (:func:`riccati_layout`) is built at its
first launch into a library of its own (:func:`riccati_entry`).
``LAUNCHES`` counts kernel launches, one per launch (a vmapped call of a
whole batch is one).
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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

#: ODE functors compiled into the RK4 kernel: id name -> (ode_id, nx, nu)
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


def build_library() -> ctypes.CDLL:
    """Build (if its sources changed) and load the kernels' shared library:
    one ``nvcc`` per source, all at once, then one link."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    so = BUILD_DIR / f"libgpmpc_cuda_{digest.hexdigest()[:16]}.so"
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
    """K1's shared memory at (nx, nu), as ``csrc/riccati_sweep.cu`` lays it
    out: (stages a chunk, bytes a warp, warps a block).  The chunk is
    RICCATI_CHUNK, halved while one warp would pass RICCATI_SMEM_OPTIN,
    down to 4; up to 4 warps share a block within 200 KB.  At 4 stages
    every pair within the lane limits fits (the largest, (30, 32), in
    206592 bytes), so those limits are the only ones: a pair past them
    raises ``ValueError`` naming the limit."""
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
    """K1's C entry for (nx, nu), the one lookup of every launch: the main
    library's for :data:`RICCATI_SHAPES`, else that of the pair's own
    library, built at its first use.  A pair past the kernel's limits
    raises ``ValueError`` (:func:`riccati_layout`) before any build."""
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

def kernel_ode_id(ode):
    """``(ode_id, nx, nu)`` of the functor compiled for ``ode``, or None
    when the RK4 kernel has no functor for it."""
    return CUDA_ODES.get(getattr(ode, "cuda_ode", None))


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


def rk4_substeps(ode, x, u, h: float, n_sub: int):
    """K2 wrapper: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors.  x (nx,) or (B, nx), u (nu,) or (B, nu); on CUDA both
    contiguous float32 on the card and ``ode`` one with a compiled functor
    (:data:`CUDA_ODES`).  Under ``torch.func.vmap`` on the card the call
    goes through the custom operator ``gpmpc::rk4_substeps``, whose vmap
    rule makes one batched launch; while a trace records (:func:`tracing`)
    it goes through the operator on either device."""
    traced = tracing()
    if x.device.type == "cpu" and not (traced and kernel_ode_id(ode)):
        return rk4_substeps_reference(ode, x, u, h, n_sub)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rk4_substeps: no kernel for device {x.device}")
    spec = kernel_ode_id(ode)
    if spec is None:
        raise ValueError(
            f"rk4_substeps: no CUDA functor for ODE {ode!r}; the kernel "
            f"compiles its ODEs in (have {sorted(CUDA_ODES)}; a quadrotor "
            "functor is ROADMAP §2 item 2)")
    if traced or _functorch_wrapped(x, u):
        return rk4_substeps_op(x, u, spec[0], float(h), int(n_sub))
    return _rk4_substeps_launch(spec, x, u, h, n_sub)


def _rk4_substeps_launch(spec, x, u, h: float, n_sub: int):
    """Launch K2 on plain CUDA tensors for the functor ``spec``."""
    ode_id, nx, nu = spec
    batched = x.ndim == 2
    bsz = x.shape[0] if batched else 1
    lead = (bsz,) if batched else ()
    _check_cuda("rk4_substeps", (x, u), dict(x=lead + (nx,), u=lead + (nu,)))
    _refuse_launch_under_trace("rk4_substeps")
    lib = build_library()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.gpmpc_rk4_substeps_f32(ode_id, x.data_ptr(), u.data_ptr(),
                                          out.data_ptr(), bsz, int(n_sub),
                                          float(h), stream)
    _raise_on_error("rk4_substeps", code)
    LAUNCHES["rk4_substeps"] += 1
    return out


def _spec_of_id(ode_id: int):
    """``(ode_id, nx, nu)`` and the ODE name of a compiled functor id."""
    for name, spec in CUDA_ODES.items():
        if spec[0] == ode_id:
            return name, spec
    raise ValueError(f"rk4_substeps: no functor with ode_id {ode_id}")


@torch.library.custom_op("gpmpc::rk4_substeps", mutates_args=())
def rk4_substeps_op(x: torch.Tensor, u: torch.Tensor, ode_id: int, h: float,
                    n_sub: int) -> torch.Tensor:
    """K2 as a custom operator over the compiled functor ``ode_id``, the
    form :func:`rk4_substeps` takes under ``torch.func.vmap`` on the card
    and in a traced step: the kernel for CUDA tensors, the plain version
    (the port's ODE of that name) for CPU tensors."""
    name, spec = _spec_of_id(ode_id)
    if x.device.type == "cpu":
        from gpmpc_tpu_torch import systems
        return rk4_substeps_reference(getattr(systems, f"{name}_ode"),
                                      x, u, h, n_sub).clone()
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


def check_riccati_sweep(args, reg, vmapped: bool = False) -> float:
    """Launch K1 on CUDA tensors and its plain version on the same tensors;
    raise unless dx and du agree within 1e-5 x (1 + max|dx|), the gains and
    feedforwards within 2e-5 and the predicted decrease within rtol 1e-4
    (atol 1e-6): the JAX package's kernel-test tolerances.  With
    ``vmapped`` the batched arguments go through ``torch.func.vmap`` of
    the wrapper (its custom operator's vmap rule).  Returns the largest
    absolute difference."""
    got = (torch.func.vmap(riccati_sweep)(*args, reg) if vmapped
           else riccati_sweep(*args, reg))
    ref = riccati_sweep_reference(*args, reg)
    scale = float(ref[0].abs().max()) + 1.0
    errs = [float((g - r).abs().max()) for g, r in zip(got, ref)]
    tols = [1e-5 * scale, 1e-5 * scale, 2e-5, 2e-5,
            1e-6 + 1e-4 * float(ref[4].abs().max())]
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
    raise unless the gains come out non-finite: ``kind="indefinite"``
    negates q_uu (by default Nt=8, nx=2, nu=1); ``kind="zero"`` sets B and
    q_uu to 0, so H_uu = 0 (by default Nt=20, nx=4, nu=2).  ``shape``
    (Nt, nx, nu) overrides the default."""
    if kind not in ("indefinite", "zero"):
        raise ValueError(f"unknown bad-pivot case {kind!r}")
    nt, nx, nu = shape or ((8, 2, 1) if kind == "indefinite" else (20, 4, 2))
    args = stage_qp_inputs(nt, nx, nu, 2 if kind == "indefinite" else 5,
                           device=device)
    if kind == "indefinite":
        args[4] = -args[4]
    else:
        args[1] = torch.zeros_like(args[1])
        args[4] = torch.zeros_like(args[4])
    gains = riccati_sweep(*args, torch.zeros((), device=device))[2]
    if bool(torch.all(torch.isfinite(gains))):
        raise AssertionError(f"riccati_sweep gave finite gains for a {kind} "
                             f"H_uu pivot")


def check_rk4_substeps(ode, x, u, h: float, n_sub: int) -> float:
    """Launch K2 on CUDA tensors and its plain version on the same tensors;
    raise unless they agree within rtol 1e-5, atol 1e-6 (looser than on the
    CPU: the kernel takes its square roots by MUFU.RSQ and fuses products
    into FMAs, which round differently from the plain version's ops).
    Returns the largest absolute difference."""
    got = rk4_substeps(ode, x, u, h, n_sub)
    ref = rk4_substeps_reference(ode, x, u, h, n_sub)
    err = float((got - ref).abs().max())
    if got.shape != ref.shape or not bool(
            torch.all((got - ref).abs() <= 1e-6 + 1e-5 * ref.abs())):
        raise AssertionError(f"rk4_substeps disagrees with its plain version:"
                             f" max|err| {err} (rtol 1e-5, atol 1e-6)")
    return err
