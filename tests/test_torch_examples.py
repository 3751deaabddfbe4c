"""The port's walkthroughs (``gpmpc_tpu_torch/examples``) on the CPU in
f64: the four-tank slice (its fit and a TA closed loop) against the JAX
package on the JAX example's own training arrays, and the batched-study
walkthrough run through its ``main`` with its self-checks, in a
temporary directory, where it writes its checkpoint.  The pendulum
walkthrough's --quick run takes minutes on a CPU: ``chip_smoke.py``
runs it (phase 20, at full settings on the card) instead."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gpmpc_tpu import GP as JGP
from gpmpc_tpu import MPC as JMPC
from gpmpc_tpu.models.dynamics import Model as JModel
from gpmpc_tpu.systems import four_tank_ode as jode
from gpmpc_tpu_torch.examples import batched_study, four_tank
from gpmpc_tpu_torch.models.convert import gp_from_numpy, hypers_to_numpy
from gpmpc_tpu_torch.parallel import load_study

CPU = dict(device="cpu", dtype=torch.float64)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch's CPU ops on one thread while this file runs: their many
    small ops lose ~15x to the thread pool's contention when the suite's
    workers share the cores (81 s against 5 s for the batched study)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: the TA closed loop's steps in this test: the example's --quick loop
#: runs 10, each ~15 s in f64 on a CPU core (the default budget, ~290 inner
#: SQP steps a control step); cut to keep the file within a minute, the
#: sizes unchanged
LOOP_STEPS = 1


@pytest.fixture(scope="module")
def tank_slice():
    """The JAX example's --quick training set (PRNGKey(2), 40 points),
    fitted by the JAX package's GP and by the port example's ``fit`` with
    the example's recipe."""
    jm = JModel(Nx=4, Nu=2, ode=lambda x, u: jode(x, u), dt=four_tank.DT,
                R=np.diag([1e-3] * 4), clip_negative=True,
                dtype=jnp.float64, integrator_substeps=10)
    X, Y = jm.generate_training_data(40, **four_tank.BOUNDS,
                                     key=jax.random.PRNGKey(2))
    X, Y = np.asarray(X), np.asarray(Y)
    jgp = JGP(X, Y, mean_func="zero", gp_method="TA", multistart=2,
              max_iters=200, seed=1)
    tgp = four_tank.fit(X, Y, **CPU)
    return jm, jgp, tgp, X, Y


def test_four_tank_fit_matches_jax(tank_slice):
    """The example's fit on the JAX arrays: NLL per dim and every log
    hyperparameter within rtol 1e-6 of the JAX fit."""
    _, jgp, tgp, _, _ = tank_slice
    np.testing.assert_allclose(tgp.nll.numpy(), np.asarray(jgp.nll),
                               rtol=1e-6)
    got = hypers_to_numpy(tgp.hyper)
    for k, ref in jgp.hyper._asdict().items():
        np.testing.assert_allclose(got[k], np.asarray(ref), rtol=1e-6,
                                   atol=1e-12)


def test_four_tank_ta_loop_matches_jax(tank_slice):
    """The example's TA controller (percentile 0.95, feedback, --quick
    horizon) on the JAX fit's GP, noise off: LOOP_STEPS closed-loop steps
    within 1e-6 of the JAX controller's, states and inputs."""
    jm, jgp, _, X, Y = tank_slice
    h = {k: np.asarray(v) for k, v in jgp.hyper._asdict().items()}
    tgp = gp_from_numpy(X, Y, h["log_ell"], h["log_sf2"], h["log_sn2"],
                        mean_func="zero", gp_method="TA", **CPU)
    model = four_tank.build_model(**CPU)
    mpc = four_tank.build_mpc(model, tgp, "TA", 0.95, quick=True)
    jmpc = JMPC(horizon=5 * four_tank.DT, model=jm, gp=jgp,
                Q=four_tank.Q, R=0.05 * np.eye(2), ulb=[0.0, 0.0],
                uub=[8.0, 8.0], xlb=[0.5, 0.5, 0.1, 0.1],
                xub=[16.0, 16.0, 8.0, 8.0], discrete_method="gp",
                gp_method="TA", percentile=0.95, feedback=True)
    sim_time = LOOP_STEPS * four_tank.DT
    xs, us = mpc.solve(four_tank.X0, sim_time, four_tank.X_SP, noise=False)
    jxs, jus = jmpc.solve(four_tank.X0, sim_time, four_tank.X_SP,
                          noise=False)
    np.testing.assert_allclose(xs.numpy(), np.asarray(jxs), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(us.numpy(), np.asarray(jus), rtol=0,
                               atol=1e-6)


def test_batched_study_quick_passes_its_self_checks(tmp_path, monkeypatch):
    """batched_study --quick --cpu through main (no process group: the
    plain study): finite costs, the checkpoint written and read back
    bitwise, and a study resumed from it."""
    monkeypatch.chdir(tmp_path)
    r = batched_study.main(quick=True, device="cpu")
    assert r["checkpoint_bitwise"] and np.isfinite(r["mean_cost"])
    assert r["gp_points"] >= batched_study.N_TRAIN
    model = batched_study.build_model(**CPU)
    study = batched_study.build_study(model, batched_study.fit(model), 5,
                                      None)
    back = load_study(str(tmp_path / batched_study.CHECKPOINT), study.post0)
    assert back.x_traj.shape == (16, 6, 4)
    res = study.run(back.x_traj[:, -1], batched_study.X_SP, 1, noise=False,
                    init_post=back.post)
    assert torch.isfinite(res.x_traj).all()
