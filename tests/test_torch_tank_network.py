"""The four-tank network under output feedback: units of the four-tank
process side by side, each ``four_tank_ode`` on its own slice of the state
and the input, an MHE measuring each unit's two lower levels feeding an
rk4 MPC whose state weight couples every unit.  At ten units (nx = 40,
nu = 20) its KKT solves are K1 at (40, 20) (the MPC) and (40, 40) (the
MHE), both on K1's block path on the card (``chip_smoke.py`` phase 22).

Here, on the CPU against the JAX package on the same numpy inputs:

* at two units (nx = 8) two steps of ``simulate_output_feedback`` in f64
  with the sequential KKT solve on both sides, within 1e-6;
* the ten-unit ODE traced by ``ops/ode_trace.py``, its functor built with
  the host ``g++`` behind the RK4 chain the kernel runs, against the plain
  version and ``rk4_substeps_pallas(interpret=True)``;
* (``tests/test_torch_tank_network_f32.py``, a file of its own so that a
  second worker takes its JAX compiles) one step in f32 with
  ``fused_kkt=True`` on both sides.
"""

import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmpc_tpu import MHE as JMHE, MPC as JMPC, Model as JModel
from gpmpc_tpu import simulate_output_feedback as jsimulate
from gpmpc_tpu.ops.pallas_kernels import rk4_substeps_pallas
from gpmpc_tpu.systems import four_tank_ode as jtank
from gpmpc_tpu_torch import MHE, MPC, Model, simulate_output_feedback
from gpmpc_tpu_torch.ops import cuda_kernels as ck
from gpmpc_tpu_torch.ops import ode_trace as ot
from gpmpc_tpu_torch.systems import four_tank_ode

#: one unit's configuration: chip_smoke.py phase 16 (a) (tank_mhe_ofb)
X0 = np.array([8.0, 9.0, 1.0, 1.0])
XBAR = X0 + np.array([0.5, -0.5, 0.2, 0.2])
XSP = np.array([12.4, 12.7, 1.8, 1.4])
Q_UNIT = np.array([10.0, 10.0, 0.1, 0.1])
DT = 3.0


def network_ode(units, tank):
    """``units`` four-tank processes side by side: unit i's ODE ``tank``
    on x[4i:4i+4] and u[2i:2i+2], concatenated."""
    if tank is four_tank_ode:
        return lambda x, u: torch.cat(
            [tank(x[..., 4 * i:4 * i + 4], u[..., 2 * i:2 * i + 2])
             for i in range(units)], dim=-1)
    return lambda x, u: jnp.concatenate(
        [tank(x[..., 4 * i:4 * i + 4], u[..., 2 * i:2 * i + 2])
         for i in range(units)], axis=-1)


def network_setup(units, seed=22):
    """Each unit's start, prior and setpoint (phase 16 (a)'s plus small
    numpy-seeded offsets), the coupled state weight kron(I, Q_unit) +
    0.1 mean(Q_unit) 11'/nx (positive definite, and dense, so that K1's
    matrices are full) and the measurement matrix (each unit's two lower
    levels)."""
    rng = np.random.default_rng(seed)
    off = rng.uniform(-0.4, 0.4, (units, 4))
    nx = 4 * units
    x0 = (X0 + off).ravel()
    x_bar = (XBAR + off).ravel()
    x_sp = (XSP + 0.5 * off).ravel()
    q = np.kron(np.eye(units), np.diag(Q_UNIT)) + 0.1 * Q_UNIT.mean() \
        * np.ones((nx, nx)) / nx
    c = np.zeros((2 * units, nx))
    for i in range(units):
        c[2 * i, 4 * i] = c[2 * i + 1, 4 * i + 1] = 1.0
    return x0, x_bar, x_sp, q, c


def noise(units, n, seed=23):
    """Process and measurement noise for ``n`` steps, phase 16 (a)'s draws
    (numpy, seed 23) at the network's widths."""
    rng = np.random.default_rng(seed)
    return (0.01 * rng.standard_normal((n, 4 * units)),
            0.05 * rng.standard_normal((n, 2 * units)))


def controllers(units, pkg, dtype, fused, nt=20):
    """The network's MHE (window 4, the arrival update, levels >= 0, rk4)
    and MPC (rk4, no GP, horizon ``nt`` steps, R = 0.01 I, phase 16 (a)'s
    bounds per unit) in ``pkg`` ("jax" or "torch") at ``dtype``; budgets
    phase 16 (a)'s: the MHE al2 x mi5, the MPC the main path's RTI after an
    al2 x mi10 cold start, ``fused_kkt`` as given."""
    nx, nu = 4 * units, 2 * units
    _, _, _, q, c = network_setup(units)
    model_kw = dict(Nx=nx, Nu=nu, dt=DT, R=np.diag([1e-3] * nx),
                    clip_negative=True, integrator_substeps=10,
                    fused_integrator=fused)
    mhe_opts = dict(al_iters=2, max_iters=5, fused_kkt=fused)
    rti = dict(al_iters=2, max_iters=2, ls_steps=8, penalty_init=1e3,
               fused_kkt=fused)
    init = dict(al_iters=2, max_iters=10, fused_kkt=fused)
    if pkg == "jax":
        model = JModel(ode=network_ode(units, jtank), dtype=dtype, **model_kw)
        h = lambda x: jnp.asarray(c, x.dtype) @ x            # noqa: E731
        m_cls, p_cls = JMHE, JMPC
        dev = {}
    else:
        model = Model(ode=network_ode(units, four_tank_ode), dtype=dtype,
                      device="cpu", **model_kw)
        ct = torch.as_tensor(c, dtype=dtype)
        h = lambda x: ct @ x                                 # noqa: E731
        m_cls, p_cls = MHE, MPC
        dev = dict(device="cpu")
    mhe = m_cls(model, window=4, Q_noise=model_kw["R"],
                R_meas=np.diag([2.5e-3] * 2 * units),
                P_arrival=np.diag([0.5] * nx), h=h, xlb=[0.0] * nx,
                discrete_method="rk4", arrival_update=True,
                solver_opts=mhe_opts)
    mpc = p_cls(horizon=nt * DT, model=model, gp=None, gp_method="ME",
                discrete_method="rk4", Q=q, R=0.01 * np.eye(nu),
                ulb=[0.0] * nu, uub=[8.0] * nu,
                xlb=[0.5, 0.5, 0.1, 0.1] * units,
                xub=[14.0, 25.0, 8.0, 8.0] * units, feedback=False,
                percentile=None, cov_updates=1, solver_opts=rti,
                init_solver_opts=init, **dev)
    return mhe, mpc


def run_loop(units, pkg, dtype, fused, n, nt=20):
    """``n`` steps of the network's output-feedback loop at ``units``
    units in ``pkg``, the MPC's horizon ``nt`` steps: its true states,
    estimates and inputs (numpy)."""
    x0, x_bar, x_sp, _, _ = network_setup(units)
    w, v = noise(units, n)
    mhe, mpc = controllers(units, pkg, dtype, fused, nt)
    run = jsimulate if pkg == "jax" else simulate_output_feedback
    res = run(mpc, mhe, x0, x_bar, n * DT, x_sp, noise_w=w, noise_v=v)
    return [np.asarray(getattr(res, k)) for k in ("x_true", "x_hat", "u")]


def test_network_loop_matches_jax_x64():
    """Two units, two output-feedback steps in f64, the sequential KKT
    solve on both sides (both packages refuse f64 with fused_kkt): true
    states, estimates and inputs within 1e-6."""
    got = run_loop(2, "torch", torch.float64, False, 2)
    ref = run_loop(2, "jax", jnp.float64, False, 2)
    for g, r, name in zip(got, ref, ("x_true", "x_hat", "u")):
        assert np.all(np.isfinite(g)), name
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-6, err_msg=name)


@pytest.fixture(scope="module")
def network_functor(tmp_path_factory):
    """The ten-unit network ODE traced and lowered, and its functor built
    with the host ``g++`` behind the RK4 chain the kernel runs."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.fail("g++ not found: the host build of the functor needs it")
    functor = ot.compile_ode(network_ode(10, four_tank_ode), 40, 20)
    d = tmp_path_factory.mktemp("k2_network")
    (d / "unit.cpp").write_text(ot.host_unit_source([functor]))
    proc = subprocess.run(
        [cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off",
         "-Wall", "-Werror", "-Wno-unknown-pragmas", "-I", str(ck.CSRC),
         "-o", str(d / "libk2net.so"), str(d / "unit.cpp")],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    fn = getattr(ctypes.CDLL(str(d / "libk2net.so")),
                 f"gpmpc_rk4_host_{functor.name}")
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_double]
    return functor, fn


def test_network_functor_matches_plain_and_pallas(network_functor):
    """The traced ten-unit functor (nx = 40, nu = 20: slices and a cat of
    ten four-tank units) on 16 seeded points, a drained tank among them:
    against the plain version at the plant's 10 substeps, and against
    ``rk4_substeps_pallas(..., interpret=True)`` on the JAX network ODE at
    2 (its interpreter unrolls the substeps: 10 take ~18 s to compile on
    one CPU core), rtol 1e-6, atol 1e-7."""
    functor, fn = network_functor
    assert (functor.nx, functor.nu) == (40, 20)
    rng = np.random.default_rng(5)
    x = np.ascontiguousarray(np.abs(rng.standard_normal((16, 40))) * 4 + 0.5,
                             np.float32)
    x[0, 3] = 0.0
    u = np.ascontiguousarray(np.abs(rng.standard_normal((16, 20))) * 3,
                             np.float32)
    h = DT / 10
    for n_sub in (10, 2):
        got = np.empty_like(x)
        fn(x.ctypes.data, u.ctypes.data, got.ctypes.data, 16, n_sub, h)
        plain = ck.rk4_substeps_rollouts(
            network_ode(10, four_tank_ode), torch.from_numpy(x),
            torch.from_numpy(u), h, n_sub).numpy()
        np.testing.assert_allclose(got, plain, rtol=1e-6, atol=1e-7)
    ref = np.asarray(jax.vmap(lambda a, b: rk4_substeps_pallas(
        network_ode(10, jtank), a, b, h, 2, interpret=True))(
            jnp.asarray(x), jnp.asarray(u)))
    assert ref.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
