"""The last two x64 goldens through the port: ``tank_mhe_ofb`` (the MHE
output-feedback loop) and ``quad_hybrid_mismatch`` (the planar quadrotor's
hybrid GP-residual MPC against a 30%-heavier plant).

Each rebuilds its ``tests/golden_configs.py`` configuration in
gpmpc_tpu_torch at f64 on the CPU, as ``tests/test_torch_goldens.py`` does
for the others: the GP fitted by the JAX package as that file fits it
(the quadrotor's 40 training points drawn by ``jax.random`` on the JAX
side and handed over as numpy, since the port cannot reproduce that
stream), passed to the port's ``GP(hyper=...)``, with the same estimator
and controller options and the golden's own noise draws.  States,
estimates and inputs must lie within atol 1e-6 of the stored ones, the
gate ``tests/test_goldens.py`` holds the JAX package to."""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import golden_configs as gcfg
from gpmpc_tpu import GP as JGP, Model as JModel
from gpmpc_tpu.systems import planar_quadrotor_ode as jquad
from gpmpc_tpu_torch import MHE, MPC, Model, simulate_output_feedback
from gpmpc_tpu_torch.systems import (QUAD_PARAMS, four_tank_ode,
                                     planar_quadrotor_ode)
from test_torch_goldens import _port_gp

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
F64 = torch.float64
TANK_MPC = dict(gp_method="TA", discrete_method="gp",
                Q=np.diag([10.0, 10.0, 0.1, 0.1]), R=0.01 * np.eye(2),
                ulb=[0.0, 0.0], uub=[8.0, 8.0], xlb=[0.5, 0.5, 0.1, 0.1],
                xub=[14.0, 25.0, 8.0, 8.0], percentile=0.95, feedback=True,
                cov_updates=2)


def _golden(name):
    return np.load(os.path.join(GOLDENS, f"{name}.npz"))


def test_golden_mhe_output_feedback():
    """``golden_configs.run_mhe_golden``: two of four tank levels measured
    with noise, MHE (window 4, GP dynamics, the filtered arrival cost,
    estimates bounded below by 0) feeding the TA MPC with tightening and
    feedback, 8 steps of simulate_output_feedback on the golden's noise
    (numpy, seed 23); the golden's xs are the plant states after each step
    beside the estimates the MPC acted on."""
    gp = _port_gp(gcfg.tank_gp(gcfg.tank_model()), "TA")
    model = Model(Nx=4, Nu=2, ode=four_tank_ode, dt=gcfg.DT,
                  R=np.diag([1e-3] * 4), clip_negative=True, dtype=F64,
                  integrator_substeps=10, device="cpu")
    c = torch.tensor([[1.0, 0.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0]],
                     dtype=F64)
    mhe = MHE(model, gp, window=4, Q_noise=model.R,
              R_meas=np.diag([2.5e-3, 2.5e-3]), P_arrival=np.diag([0.5] * 4),
              h=lambda x: c @ x, xlb=[0.0] * 4, discrete_method="gp",
              arrival_update=True)
    mpc = MPC(horizon=5 * gcfg.DT, model=model, gp=gp, device="cpu",
              **TANK_MPC)
    n = 8
    rng = np.random.default_rng(23)
    noise_w = 0.01 * rng.standard_normal((n, 4))
    noise_v = 0.05 * rng.standard_normal((n, 2))
    res = simulate_output_feedback(
        mpc, mhe, x0=gcfg.X0, x_bar=gcfg.X0 + np.array([0.5, -0.5, 0.2, 0.2]),
        sim_time=n * gcfg.DT, x_sp=gcfg.XSP, noise_w=noise_w,
        noise_v=noise_v)
    ref = _golden("tank_mhe_ofb")
    xs = np.concatenate([res.x_true[1:], res.x_hat], axis=1)
    np.testing.assert_allclose(xs, ref["xs"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(res.u, ref["us"], rtol=0, atol=1e-6)
    assert res.mhe_converged.all()


def quad_training_set():
    """The quadrotor golden's residual training set, drawn and integrated
    on the JAX side as ``golden_configs.run_quad_golden`` does: 40 states
    and thrusts uniform in its box (``jax.random``, key 0), targets the
    1.3 kg plant's step minus the nominal model's RK4 step."""
    dt = 0.05
    p_true = dict(QUAD_PARAMS, m=1.3)
    kw = dict(Nx=6, Nu=2, dt=dt, R=np.diag([1e-8] * 6), dtype=jnp.float64,
              integrator_substeps=4)
    nominal = JModel(ode=lambda x, u: jquad(x, u), **kw)
    plant = JModel(ode=lambda x, u: jquad(x, u, p_true), **kw)
    kx, ku = jax.random.split(jax.random.PRNGKey(0))
    x_lo = np.array([-2.0, 0.0, -0.4, -1.5, -1.5, -1.0])
    x_hi = np.array([3.0, 3.0, 0.4, 1.5, 1.5, 1.0])
    xs_s = jax.random.uniform(kx, (40, 6), minval=x_lo, maxval=x_hi,
                              dtype=jnp.float64)
    us_s = jax.random.uniform(ku, (40, 2), minval=2.0, maxval=9.0,
                              dtype=jnp.float64)
    resid = (jax.vmap(plant.integrate)(xs_s, us_s)
             - jax.vmap(nominal.rk4)(xs_s, us_s))
    return jnp.concatenate([xs_s, us_s], axis=1), resid


@pytest.fixture(scope="module")
def quad_gp():
    x, y = quad_training_set()
    return _port_gp(JGP(x, y, mean_func="zero", gp_method="TA",
                        multistart=2, max_iters=150, seed=1), "TA")


def quad_loop(gp, steps=10):
    """``golden_configs.run_quad_golden`` in the port: the nominal model
    (QUAD_PARAMS) with the GP's residual (hybrid, TA, no tightening or
    feedback) controls the 1.3 kg plant through ``solve_step`` for
    ``steps`` steps from hover at (0, 1) towards (1.5, 2)."""
    dt = 0.05
    p_true = dict(QUAD_PARAMS, m=1.3)
    kw = dict(Nx=6, Nu=2, dt=dt, R=np.diag([1e-8] * 6), dtype=F64,
              integrator_substeps=4, device="cpu")
    nominal = Model(ode=planar_quadrotor_ode, **kw)
    plant = Model(ode=lambda x, u: planar_quadrotor_ode(x, u, p_true), **kw)
    mpc = MPC(horizon=8 * dt, model=nominal, gp=gp, gp_method="TA",
              discrete_method="hybrid",
              Q=np.diag([10.0, 30.0, 2.0, 1.0, 1.0, 0.2]),
              R=0.02 * np.eye(2), ulb=[0.0, 0.0], uub=[10.0, 10.0],
              xlb=[-5.0, 0.2, -1.0, -5.0, -5.0, -6.0],
              xub=[5.0, 5.0, 1.0, 5.0, 5.0, 6.0], feedback=False,
              percentile=None, cov_updates=1, dtype=F64, device="cpu")
    x = torch.tensor([0.0, 1.0, 0.0, 0.0, 0.0, 0.0], dtype=F64)
    x_sp = np.array([1.5, 2.0, 0.0, 0.0, 0.0, 0.0])
    warm, u_prev = None, None
    traj, inputs = [x], []
    for _ in range(steps):
        u0, warm, _, _ = mpc.solve_step(x, x_sp, warm=warm, u_prev=u_prev)
        u_prev = u0
        x = plant.integrate(x, u0)
        traj.append(x)
        inputs.append(u0)
    return torch.stack(traj).numpy(), torch.stack(inputs).numpy()


def test_golden_quad_hybrid_mismatch(quad_gp):
    """All 10 steps of the quadrotor golden: states and thrusts within
    1e-6 of the stored ones."""
    xs, us = quad_loop(quad_gp)
    ref = _golden("quad_hybrid_mismatch")
    np.testing.assert_allclose(xs, ref["xs"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(us, ref["us"], rtol=0, atol=1e-6)
