"""The x64 goldens of slice F's first part through the port:
``tank_gp_ut_tight`` (UT propagation), ``tank_gp_gh_tight`` (GH, the
order-3 tensor grid) and ``tank_matern52_ta`` (a Matérn-5/2 GP with TA).

Each rebuilds its ``tests/golden_configs.py`` configuration in
gpmpc_tpu_torch at f64 on the CPU, as ``tests/test_torch_goldens.py`` does
for the others: the GP fitted by the JAX package as that file fits it,
passed to the port's ``GP(hyper=...)`` with the same kernel family, the
same controller options, and the JAX closed loop's own process-noise draw
as ``noise_w``.  States and inputs must lie within atol 1e-6 of the stored
ones, the gate ``tests/test_goldens.py`` holds the JAX package to."""

import os

import numpy as np
import pytest
import torch
import jax

import golden_configs as gcfg
from gpmpc_tpu import GP as JGP
from gpmpc_tpu_torch import GP, MPC, Model
from gpmpc_tpu_torch.models.gp_core import GPHypers
from gpmpc_tpu_torch.systems import four_tank_ode
from test_torch_goldens import _noise, _run_tank

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
F64 = torch.float64


@pytest.fixture(scope="module")
def tank_gp():
    """The tank family's SE GP, fitted once as golden_configs.tank_gp."""
    return gcfg.tank_gp(gcfg.tank_model())


def _check(name, xs, us):
    ref = np.load(os.path.join(GOLDENS, f"{name}.npz"))
    np.testing.assert_allclose(xs.numpy(), ref["xs"], atol=1e-6)
    np.testing.assert_allclose(us.numpy(), ref["us"], atol=1e-6)


@pytest.mark.parametrize("name", ["tank_gp_ut_tight", "tank_gp_gh_tight"])
def test_golden_trajectory(name, tank_gp):
    """UT and GH (order 3, 3^6 = 729 points a stage: the tensor grid)
    through ``golden_configs.run_config``'s controller."""
    _check(name, *_run_tank(name, tank_gp))


def test_golden_matern52_ta():
    """``golden_configs.run_matern_golden``: the same data and seeds as the
    tank GP with ``kernel="matern52"``, TA propagation, tightening and
    feedback; the JAX-fitted Matérn hypers are passed to the port."""
    model = gcfg.tank_model()
    x, y = model.generate_training_data(
        50, uub=[6.0, 6.0], ulb=[0.0, 0.0],
        xub=[20.0, 20.0, 6.0, 6.0], xlb=[1.0, 1.0, 0.5, 0.5],
        key=jax.random.PRNGKey(7))
    jg = JGP(x, y, kernel="matern52", mean_func="zero", gp_method="TA",
             multistart=2, max_iters=150, seed=5)
    gp = GP(np.asarray(jg.X_raw), np.asarray(jg.Y_raw), mean_func="zero",
            gp_method="TA", kernel="matern52",
            hyper=GPHypers(*(np.asarray(h) for h in jg.hyper)), dtype=F64,
            device="cpu")
    rmat = np.diag([1e-3] * 4)
    m = Model(Nx=4, Nu=2, ode=four_tank_ode, dt=gcfg.DT, R=rmat,
              clip_negative=True, dtype=F64, integrator_substeps=10,
              device="cpu")
    mpc = MPC(horizon=5 * gcfg.DT, model=m, gp=gp, gp_method="TA",
              discrete_method="gp", Q=np.diag([10.0, 10.0, 0.1, 0.1]),
              R=0.01 * np.eye(2), ulb=[0.0, 0.0], uub=[8.0, 8.0],
              xlb=[0.5, 0.5, 0.1, 0.1], xub=[14.0, 25.0, 8.0, 8.0],
              percentile=0.95, feedback=True, cov_updates=2, device="cpu")
    xs, us = mpc.solve(gcfg.X0, 8 * gcfg.DT, gcfg.XSP,
                       noise_w=_noise(jax.random.PRNGKey(11), 8, rmat))
    _check("tank_matern52_ta", xs, us)
