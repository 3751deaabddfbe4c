"""ctypes binding of the host DOPRI5 integrator ``csrc/integrator.cpp``.

Counterpart of ``gpmpc_tpu/native/__init__.py``, with the same
``integrate``/``sim`` signatures and systems (``four_tank``, ``car`` and
``callback``, an arbitrary Python ``ode(x, u)`` called through ctypes).  It
is the port's independent truth source for the adaptive integrator: an
embedded Dormand-Prince RK5(4) pair with PI step-size control, in double,
on the host.

The source is read where it stands in the repository (``csrc/``, beside
the two packages) and built with ``g++`` at first use into this package's
own ``build/`` directory, named by a hash of the source and the flags (a
changed source builds anew).  If the compiler is missing or fails, the
first call raises with its words.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Optional

import numpy as np

SRC = Path(__file__).resolve().parents[2] / "csrc" / "integrator.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

SYSTEMS = {"callback": 0, "four_tank": 1, "car": 2}

_ODE_CB = ctypes.CFUNCTYPE(None, ctypes.POINTER(ctypes.c_double),
                           ctypes.POINTER(ctypes.c_double),
                           ctypes.POINTER(ctypes.c_double), ctypes.c_void_p)
_NULL_CB = _ODE_CB()

_lib = None


def library_path() -> Path:
    """Where the library is built: keyed by a hash of the source and the
    flags."""
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    digest.update(SRC.read_bytes())
    return BUILD_DIR / f"libgpmpc_host_{digest.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: cannot build the host "
                           f"integrator from {SRC}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *FLAGS, "-o", str(tmp), str(SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}) building {SRC}:"
                           f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    for stale in BUILD_DIR.glob("libgpmpc_host_*.so"):
        if stale != so:
            stale.unlink(missing_ok=True)


def load():
    """Build (if needed) and load the library; returns the ctypes handle."""
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.exists():
        _build(so)
    lib = ctypes.CDLL(str(so))
    dp = ctypes.POINTER(ctypes.c_double)
    lib.gpmpc_integrate.restype = ctypes.c_int
    lib.gpmpc_integrate.argtypes = [
        ctypes.c_int, dp, _ODE_CB, ctypes.c_void_p,
        dp, ctypes.c_int, dp, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, dp]
    lib.gpmpc_sim.restype = ctypes.c_int
    lib.gpmpc_sim.argtypes = [
        ctypes.c_int, dp, _ODE_CB, ctypes.c_void_p,
        dp, ctypes.c_int, dp, ctypes.c_int,
        ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_int, dp]
    _lib = lib
    return lib


def _as_c(a):
    a = np.ascontiguousarray(np.asarray(a, dtype=np.float64))
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _make_cb(ode: Callable, nx: int, nu: int):
    def raw(x_ptr, u_ptr, dx_ptr, _ctx):
        x = np.ctypeslib.as_array(x_ptr, (nx,))
        u = np.ctypeslib.as_array(u_ptr, (nu,))
        dx = np.asarray(ode(x, u), dtype=np.float64)
        for i in range(nx):
            dx_ptr[i] = dx[i]
    return _ODE_CB(raw)


def _params(system: str, params):
    if system not in SYSTEMS:
        raise ValueError(f"unknown system {system!r}; have {sorted(SYSTEMS)}")
    return _as_c(params if params is not None else [0.0])


def integrate(x0, u, dt: float, *, system: str = "callback",
              params=None, ode: Optional[Callable] = None,
              rtol: float = 1e-10, atol: float = 1e-12) -> np.ndarray:
    """Adaptive one-step integration over ``dt`` with constant input.

    ``system`` in {'four_tank', 'car'} uses the native ODE with ``params``
    (a flat float array: :func:`tank_params`, :func:`car_params`);
    'callback' integrates an arbitrary Python ``ode(x, u) -> dx`` (numpy
    in, array-like out)."""
    lib = load()
    pa, pp = _params(system, params)
    x0a, x0p = _as_c(x0)
    ua, up = _as_c(u)
    out = np.empty_like(x0a)
    cb = (_make_cb(ode, x0a.size, ua.size)
          if system == "callback" else _NULL_CB)
    rc = lib.gpmpc_integrate(
        SYSTEMS[system], pp, cb, None, x0p, x0a.size, up, ua.size,
        float(dt), float(rtol), float(atol),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if rc:
        raise RuntimeError(f"native integrator failed (rc={rc})")
    return out


def sim(x0, u_seq, dt: float, *, system: str = "callback", params=None,
        ode: Optional[Callable] = None, rtol: float = 1e-10,
        atol: float = 1e-12, clip_negative: bool = False) -> np.ndarray:
    """Adaptive multi-step simulation under the inputs ``u_seq`` (T, Nu);
    returns the (T+1, Nx) trajectory."""
    lib = load()
    pa, pp = _params(system, params)
    x0a, x0p = _as_c(x0)
    useq = np.ascontiguousarray(np.asarray(u_seq, dtype=np.float64))
    n_steps, nu = useq.shape
    traj = np.empty((n_steps + 1, x0a.size), dtype=np.float64)
    cb = (_make_cb(ode, x0a.size, nu) if system == "callback" else _NULL_CB)
    rc = lib.gpmpc_sim(
        SYSTEMS[system], pp, cb, None, x0p, x0a.size,
        useq.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), nu,
        n_steps, float(dt), float(rtol), float(atol), int(clip_negative),
        traj.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if rc:
        raise RuntimeError(f"native simulator failed (rc={rc})")
    return traj


def tank_params(p: Optional[dict] = None) -> np.ndarray:
    """``systems.TANK_PARAMS`` in the native layout."""
    from gpmpc_tpu_torch.systems import TANK_PARAMS
    p = p or TANK_PARAMS
    return np.array([p["A1"], p["A2"], p["A3"], p["A4"],
                     p["a1"], p["a2"], p["a3"], p["a4"],
                     p["g"], p["k1"], p["k2"], p["gamma1"], p["gamma2"]])


def car_params(p: Optional[dict] = None) -> np.ndarray:
    """``systems.CAR_PARAMS`` in the native layout."""
    from gpmpc_tpu_torch.systems import CAR_PARAMS
    p = p or CAR_PARAMS
    return np.array([p["lf"], p["lr"]])
