"""Port parity for the slice as a whole: the four-tank GP-MPC closed loop of
gpmpc_tpu_torch against gpmpc_tpu on the same fixture GP, bounds and
budgets (cut to Nt=5, 30 training points, 4 steps)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from benchmarks.bench_spec import (DT, MODEL_R, Q_W, R_W, ULB, UUB, X0, XLB,
                                   XSP, XUB)
from gpmpc_tpu import GP as JGP, MPC as JMPC, Model as JModel
from gpmpc_tpu.models.gp_core import GPHypers as JHypers
from gpmpc_tpu.systems import four_tank_ode as jode
from gpmpc_tpu_torch import MPC, Model
from gpmpc_tpu_torch.models.convert import FIXTURE, gp_from_fixture
from gpmpc_tpu_torch.systems import four_tank_ode

N_TRAIN, NT, STEPS = 30, 5, 4
GP_OPTS = dict(jitter=1e-5, min_noise=1e-4)
MPC_KW = dict(Q=Q_W, R=R_W, ulb=ULB, uub=UUB, xlb=XLB, xub=XUB,
              percentile=0.95, feedback=True, cov_updates=1, op_x=XSP,
              op_u=np.array([3.0, 3.0]))


def _jax_side(dtype, gp_method, discrete_method, fused, nt=NT,
              n_train=N_TRAIN, **kw):
    f = np.load(FIXTURE)
    jm = JModel(Nx=4, Nu=2, ode=lambda x, u: jode(x, u), dt=DT, R=MODEL_R,
                clip_negative=True, dtype=dtype, integrator_substeps=10,
                fused_integrator=fused)
    hyper = JHypers(*(jnp.asarray(f[f"tank_{k}"], dtype)
                      for k in ("log_ell", "log_sf2", "log_sn2")),
                    mean_w=jnp.zeros((4, 0), dtype))
    jg = JGP(jnp.asarray(f["tank_X"][:n_train], dtype),
             jnp.asarray(f["tank_Y"][:n_train], dtype), mean_func="zero",
             hyper=hyper, gp_method=gp_method, optimizer_opts=GP_OPTS)
    return JMPC(horizon=nt * DT, model=jm, gp=jg, gp_method=gp_method,
                discrete_method=discrete_method, dtype=dtype, **MPC_KW, **kw)


def _port_side(dtype, gp_method, discrete_method, fused, nt=NT,
               n_train=N_TRAIN, **kw):
    m = Model(Nx=4, Nu=2, ode=four_tank_ode, dt=DT, R=MODEL_R,
              clip_negative=True, dtype=dtype, integrator_substeps=10,
              fused_integrator=fused, device="cpu")
    g = gp_from_fixture(n=n_train, dtype=dtype, gp_method=gp_method,
                        optimizer_opts=GP_OPTS, device="cpu")
    return MPC(horizon=nt * DT, model=m, gp=g, gp_method=gp_method,
               discrete_method=discrete_method, device="cpu", **MPC_KW, **kw)


def closed_loop_parity(gp_method, discrete_method):
    """JAX x64 vs port f64 closed loop, fused flags off on both sides and
    noise=False: trajectories within 1e-6 (the ROADMAP parity rule)."""
    budget = dict(solver_opts=dict(al_iters=2, max_iters=3),
                  init_solver_opts=dict(al_iters=2, max_iters=6))
    jmpc = _jax_side(jnp.float64, gp_method, discrete_method, False, **budget)
    tmpc = _port_side(torch.float64, gp_method, discrete_method, False,
                      **budget)
    np.testing.assert_allclose(tmpc.K_fb.numpy(), np.asarray(jmpc.K_fb),
                               atol=1e-8)
    jx, ju = jmpc.solve(jnp.asarray(X0), STEPS * DT, jnp.asarray(XSP),
                        noise=False)
    tx, tu = tmpc.solve(X0, STEPS * DT, XSP, noise=False)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-6)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=1e-6)
    jr, tr = jmpc.last_run, tmpc.last_run
    np.testing.assert_array_equal(tr["iters"], jr["iters"])
    np.testing.assert_allclose(tr["sigmas"], jr["sigmas"], atol=1e-6)
    np.testing.assert_allclose(tr["obj"], jr["obj"], rtol=1e-6)
    assert np.all(np.isfinite(tr["x_sim"]))


@pytest.mark.parametrize("gp_method", ["TA", "ME"])
def test_closed_loop_matches_jax_x64(gp_method):
    closed_loop_parity(gp_method, "gp")


def test_closed_loop_explicit_noise_matches_jax_x64():
    """With process noise the two sides draw different random streams, so
    both get one explicit noise sequence (the JAX side through its closed
    loop program)."""
    budget = dict(solver_opts=dict(al_iters=1, max_iters=2),
                  init_solver_opts=dict(al_iters=1, max_iters=4))
    jmpc = _jax_side(jnp.float64, "TA", "gp", False, **budget)
    tmpc = _port_side(torch.float64, "TA", "gp", False, **budget)
    w = 0.05 * np.random.default_rng(0).standard_normal((3, 4))
    ref = jmpc._prep_ref_windows(jnp.asarray(XSP), 3)
    jx = jmpc._closed_loop_jit(jnp.asarray(X0), ref, None,
                               jnp.zeros((3, 0)), jnp.asarray(w),
                               jmpc.consts, None, n_steps=3, noise=True)[0]
    tx, _ = tmpc.solve(X0, 3 * DT, XSP, noise_w=w)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-6)


def test_unported_options_raise():
    """Every option still unported raises and names its ROADMAP item: soft
    constraints, the terminal constraint, UT/GH propagation, solve_mc and
    reference windows.  The online GP is ported (slice D): its capacity
    is checked against the training set instead."""
    m = Model(Nx=4, Nu=2, ode=four_tank_ode, dt=DT, device="cpu")
    g = gp_from_fixture(n=10, device="cpu")
    for kw in (dict(lam=1.0), dict(lam_state=1.0),
               dict(terminal_constraint=1.0),
               dict(gp_method="UT"), dict(gp_method="GH")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            MPC(horizon=3 * DT, model=m, gp=g, device="cpu", **kw)
    with pytest.raises(ValueError, match="capacity 5 < training size 10"):
        MPC(horizon=3 * DT, model=m, gp=g, device="cpu", online_capacity=5)
    assert MPC(horizon=3 * DT, model=m, gp=g, device="cpu",
               online_capacity=16).online_post0.inv_k.shape == (4, 16, 16)
    mpc = MPC(horizon=3 * DT, model=m, gp=g, feedback=False, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mpc.solve_mc(X0, DT, XSP, 2)
    for call in (lambda r: mpc.solve(X0, 3 * DT, r, noise=False),
                 lambda r: mpc.solve_step(X0, r)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call(np.tile(XSP, (4, 1)))
    with pytest.raises(ValueError, match="fused_kkt"):
        MPC(horizon=3 * DT, model=Model(Nx=4, Nu=2, ode=four_tank_ode, dt=DT,
                                        dtype=torch.float64, device="cpu"),
            gp=gp_from_fixture(n=10, dtype=torch.float64, device="cpu"),
            solver_opts=dict(fused_kkt=True), device="cpu")
