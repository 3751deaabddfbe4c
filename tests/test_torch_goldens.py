"""The x64 golden trajectories (``tests/goldens/``) through the port.

Each case rebuilds its ``tests/golden_configs.py`` configuration in
gpmpc_tpu_torch at f64 on the CPU: the GP fitted by the JAX package as
that file fits it (one module-scoped fit per family) and passed to the
port's ``GP(hyper=...)``, the same controller options, and the JAX closed
loop's own process-noise draw passed as ``noise_w``.  The port's
states and inputs must lie within atol 1e-6 of the stored ones, the gate
``tests/test_goldens.py`` holds the JAX package to.

``car_em_hybrid_obs`` is left out: the port follows it to ~1e-10 for five
steps, then a solver choice flips on that difference and the trajectories
part by up to 0.16 (ROADMAP §3).  ``PYTHONPATH=. python
tests/test_torch_goldens.py`` runs that case and prints the per-step
divergence (~8 min on a CPU); ``tests/test_torch_car.py`` holds the car
step by step instead."""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import golden_configs as gcfg
from gpmpc_tpu import GP as JGP, Model as JModel
from gpmpc_tpu.systems import car_ode as jcar_ode
from gpmpc_tpu_torch import GP, MPC, Model
from gpmpc_tpu_torch.models.gp_core import GPHypers
from gpmpc_tpu_torch.systems import (car_ode, ellipse_obstacle_constraints,
                                     four_tank_ode)

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
F64 = torch.float64


def _port_gp(jg, gp_method):
    """The port's GP on the JAX GP's training set and fitted hypers."""
    hyper = GPHypers(*(np.asarray(h) for h in jg.hyper))
    return GP(np.asarray(jg.X_raw), np.asarray(jg.Y_raw), mean_func="zero",
              gp_method=gp_method, hyper=hyper, dtype=F64, device="cpu")


def _noise(key, n, r):
    """The JAX closed loop's noise draw (gpmpc_tpu MPC.solve): N(0, I)
    from ``key`` through the Cholesky factor of the model's R."""
    r = jnp.asarray(r, jnp.float64)
    chol = jnp.linalg.cholesky(r + 1e-32 * jnp.eye(r.shape[0]))
    return np.asarray(jax.random.normal(key, (n, r.shape[0]), jnp.float64)
                      @ chol.T)


@pytest.fixture(scope="module")
def tank_gp():
    """The tank family's GP, fitted once as golden_configs.tank_gp does."""
    return gcfg.tank_gp(gcfg.tank_model())


def car_jax_gp():
    """The car golden's residual GP, fitted as run_car_golden does
    (golden_configs.py:233-246)."""
    m = JModel(Nx=4, Nu=2, ode=lambda x, u: jcar_ode(x, u), dt=0.1,
               R=np.diag([1e-5, 1e-5, 1e-6, 1e-5]), dtype=jnp.float64,
               integrator_substeps=10)
    kx, ku = jax.random.split(jax.random.PRNGKey(4))
    x_s = jax.random.uniform(kx, (40, 4), minval=np.array([-1.0, -1.0, -0.6,
                                                           0.0]),
                             maxval=np.array([1.0, 1.0, 0.6, 8.0]),
                             dtype=jnp.float64)
    u_s = jax.random.uniform(ku, (40, 2), minval=np.array([-3.0, -0.5]),
                             maxval=np.array([3.0, 0.5]), dtype=jnp.float64)
    resid = (jax.vmap(m.integrate)(x_s, u_s) - jax.vmap(m.rk4)(x_s, u_s))
    return JGP(jnp.concatenate([x_s, u_s], axis=1), resid, mean_func="zero",
               gp_method="EM", multistart=2, max_iters=200, seed=3)


def _run_tank(name, jg):
    """golden_configs.run_config for a tank-family config, in the port."""
    kw = dict(gcfg.CONFIGS[name])
    horizon_steps = kw.pop("horizon_steps", 5)
    extra = {}
    if kw.pop("with_du", False):
        extra.update(S=0.1 * np.eye(2), u_sp=np.array([3.0, 3.0]))
    if kw.get("costFunc") == "sat":
        q, r = np.diag([0.05, 0.05, 0.01, 0.01]), 0.001 * np.eye(2)
    else:
        q, r = np.diag([10.0, 10.0, 0.1, 0.1]), 0.01 * np.eye(2)
    rmat = np.diag([1e-3] * 4)
    model = Model(Nx=4, Nu=2, ode=four_tank_ode, dt=gcfg.DT, R=rmat,
                  clip_negative=True, dtype=F64, integrator_substeps=10,
                  device="cpu")
    gp = (_port_gp(jg, kw["gp_method"]) if kw["discrete_method"] != "rk4"
          else None)
    mpc = MPC(horizon=horizon_steps * gcfg.DT, model=model, gp=gp, Q=q, R=r,
              ulb=[0.0, 0.0], uub=[8.0, 8.0], xlb=[0.5, 0.5, 0.1, 0.1],
              xub=[14.0, 25.0, 8.0, 8.0], cov_updates=2, device="cpu", **kw,
              **extra)
    return mpc.solve(gcfg.X0, 8 * gcfg.DT, gcfg.XSP,
                     noise_w=_noise(jax.random.PRNGKey(11), 8, rmat))


def _run_car(jg):
    """golden_configs.run_car_golden in the port."""
    rmat = np.diag([1e-5, 1e-5, 1e-6, 1e-5])
    model = Model(Nx=4, Nu=2, ode=car_ode, dt=0.1, R=rmat, dtype=F64,
                  integrator_substeps=10, device="cpu")
    obstacles = np.array([[6.0, 0.3, 1.5, 1.0], [12.0, -0.6, 1.5, 1.2]])
    cb, n_par = ellipse_obstacle_constraints(2, scale=2.0)
    mpc = MPC(horizon=8 * 0.1, model=model, gp=_port_gp(jg, "EM"),
              gp_method="EM", discrete_method="hybrid",
              Q=np.diag([5.0, 20.0, 0.5, 1.0]), R=np.diag([0.1, 1.0]),
              S=np.diag([0.05, 0.5]), ulb=np.array([-3.0, -0.5]),
              uub=np.array([3.0, 0.5]), xlb=[-5.0, -4.0, -2.0, 0.0],
              xub=[25.0, 4.0, 2.0, 10.0], percentile=0.95, feedback=True,
              op_x=np.array([0.0, 0.0, 0.0, 2.0]),
              inequality_constraints=cb, num_con_par=n_par, cov_updates=2,
              device="cpu")
    return mpc.solve(np.array([0.0, 0.0, 0.0, 2.0]), 12 * 0.1,
                     np.array([18.0, 0.0, 0.0, 2.0]),
                     noise_w=_noise(jax.random.PRNGKey(0), 12, rmat),
                     con_par_func=lambda k: obstacles.reshape(-1))


@pytest.mark.parametrize("name", ["tank_rk4_me", "tank_gp_ta_tight",
                                  "tank_gp_ta_nt20", "tank_gp_em_tight",
                                  "tank_sat_du"])
def test_golden_trajectory(name, tank_gp):
    xs, us = _run_tank(name, tank_gp)
    ref = np.load(os.path.join(GOLDENS, f"{name}.npz"))
    np.testing.assert_allclose(xs.numpy(), ref["xs"], atol=1e-6)
    np.testing.assert_allclose(us.numpy(), ref["us"], atol=1e-6)


if __name__ == "__main__":
    # the car golden through the port: per-step distance to the stored run
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    xs, us = _run_car(car_jax_gp())
    ref = np.load(os.path.join(GOLDENS, "car_em_hybrid_obs.npz"))
    np.set_printoptions(precision=3, linewidth=120)
    print("car_em_hybrid_obs, max |x - golden| per step:",
          np.abs(xs.numpy() - ref["xs"]).max(axis=1))
    print("car_em_hybrid_obs, max |u - golden| per step:",
          np.abs(us.numpy() - ref["us"]).max(axis=1))
