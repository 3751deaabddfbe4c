"""Port parity for ``MPC.solve_mc`` (the Monte-Carlo ensemble of closed
loops) and the chance-constraint calibration audit built on it: every lane
of the port's ensemble against the same lane of the JAX package's vmapped
``_solve_mc_jit`` at f64 on the CPU, the noise JAX draws from its key
passed to both sides, within 1e-6 (the ROADMAP parity rule); with TA, with
UT (K3's plain version under ``vmap``), with user constraints through
``con_par_func`` and with per-lane online posteriors.  Also K3's vmap rule
(``gpmpc::gp_predict_batch``) on CPU tensors against its plain version, in
both of its batching cases."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from torch.func import vmap

from benchmarks.bench_spec import DT, X0, XSP
from gpmpc_tpu import MPC as JMPC, Model as JModel
from gpmpc_tpu.systems import four_tank_ode as jode
from gpmpc_tpu.utils import calibration as jcal
from gpmpc_tpu_torch import MPC, Model
from gpmpc_tpu_torch.ops import gp_cuda
from gpmpc_tpu_torch.systems import four_tank_ode
from gpmpc_tpu_torch.utils import (chance_calibration, violation_rates)

from test_torch_mpc import MPC_KW
from test_torch_online_mpc import BUDGET, NT, _gps, _models
from test_torch_soft_constraints import _pair as _user_pair

N_MC, STEPS = 3, 4


def _jax_noise(jmpc, key, n_mc, n_steps):
    """The noise ``solve_mc`` draws from ``key`` in the JAX package."""
    w = (jax.random.normal(key, (n_mc, n_steps, 4), jnp.float64)
         @ jmpc._noise_chol().T)
    return np.array(w)


def _gp_pair(gp_method, **kw):
    jm, tm = _models()
    jg, tg = _gps(jm, gp_method, residual=False)
    kw = dict(MPC_KW, horizon=NT * DT, gp_method=gp_method,
              discrete_method="gp", **BUDGET, **kw)
    return JMPC(model=jm, gp=jg, **kw), MPC(model=tm, gp=tg, device="cpu",
                                            **kw)


def _assert_lanes(tmpc, txs, tus, jmpc, jxs, jus):
    np.testing.assert_allclose(txs.numpy(), np.asarray(jxs), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tus.numpy(), np.asarray(jus), rtol=0,
                               atol=1e-6)
    got, ref = tmpc.last_mc, jmpc.last_mc
    assert sorted(got) == sorted(ref)
    np.testing.assert_array_equal(got["converged"], ref["converged"])
    np.testing.assert_allclose(got["sigmas"], ref["sigmas"], rtol=0,
                               atol=1e-6 * max(1.0, np.abs(ref["sigmas"]).max()))
    np.testing.assert_allclose(got["x_sp"], ref["x_sp"], rtol=0, atol=0)


@pytest.mark.parametrize("gp_method", ["TA", "UT"])
def test_solve_mc_matches_jax(gp_method):
    """Three lanes, four steps of the fixture GP's tightened, feedback
    controller (Nt = 5, 25 training points): each lane's states, inputs,
    stage-1 covariances and convergence flags against JAX's.  With UT the
    sigma points of all lanes go through K3's plain version under
    ``vmap``."""
    jmpc, tmpc = _gp_pair(gp_method)
    key = jax.random.PRNGKey(3)
    jxs, jus = jmpc.solve_mc(X0, STEPS * DT, XSP, N_MC, key=key)
    txs, tus = tmpc.solve_mc(X0, STEPS * DT, XSP, N_MC,
                             noise_ws=_jax_noise(jmpc, key, N_MC, STEPS))
    assert txs.shape == (N_MC, STEPS + 1, 4) and tus.shape == (N_MC, STEPS, 2)
    _assert_lanes(tmpc, txs, tus, jmpc, jxs, jus)
    # the lanes are distinct closed loops
    assert float(txs[:, -1, 0].std()) > 1e-4


def test_solve_mc_with_user_constraints_matches_jax():
    """``con_par_func`` is threaded through every lane, the per-step
    parameters shared across lanes (``tests/test_soft_constraints.py::
    test_solve_mc_with_user_constraints``, at 3 lanes and 4 steps): per
    lane within 1e-6 of JAX, and the cap binds the ensemble."""
    jmpc, tmpc = _user_pair(user=True)
    cap = 12.0
    key = jax.random.PRNGKey(11)
    x0 = np.array([8.0, 9.0, 1.0, 1.0])
    x_sp = np.array([12.4, 12.7, 1.8, 1.4])
    jxs, jus = jmpc.solve_mc(x0, STEPS * DT, x_sp, N_MC, key=key,
                             con_par_func=lambda k: np.array([cap]))
    txs, tus = tmpc.solve_mc(x0, STEPS * DT, x_sp, N_MC,
                             noise_ws=_jax_noise(jmpc, key, N_MC, STEPS),
                             con_par_func=lambda k: np.array([cap]))
    _assert_lanes(tmpc, txs, tus, jmpc, jxs, jus)
    assert float(txs[:, :, 0].max()) < cap + 0.15


@pytest.mark.parametrize("gp_method", ["ME", "UT"])
def test_solve_mc_with_online_conditioning_matches_jax(gp_method):
    """``online_capacity``: the posterior goes in shared and every lane
    conditions its own copy (``tests/test_online_mpc.py::
    test_solve_mc_with_online_conditioning``, cut to 3 lanes and 4 steps),
    each lane from its own initial state.  With UT every lane's sigma
    points are predicted from its own posterior (on the card one K3
    launch with a problem dim over the lanes)."""
    jmpc, tmpc = _gp_pair(gp_method, online_capacity=40, percentile=None,
                          feedback=False)
    key = jax.random.PRNGKey(9)
    x0s = X0 + np.array([[0.0] * 4, [0.5, -0.5, 0.1, 0.0],
                         [-0.5, 0.3, 0.0, 0.1]])
    jxs, jus = jmpc.solve_mc(x0s, STEPS * DT, XSP, N_MC, key=key)
    txs, tus = tmpc.solve_mc(x0s, STEPS * DT, XSP, N_MC,
                             noise_ws=_jax_noise(jmpc, key, N_MC, STEPS))
    _assert_lanes(tmpc, txs, tus, jmpc, jxs, jus)
    np.testing.assert_allclose(txs[:, 0].numpy(), x0s, rtol=0, atol=0)


def test_solve_mc_lane_is_the_closed_loop_of_solve():
    """A lane of the ensemble is the single closed loop ``solve`` runs with
    that lane's noise row (what ``chip_smoke.py`` replays on the CPU),
    within 1e-10: the masked budget under the batch takes the iterates of
    the loop that exits early."""
    _, tmpc = _gp_pair("TA")
    w = np.random.default_rng(4).normal(0.0, 0.03, (2, STEPS, 4))
    txs, tus = tmpc.solve_mc(X0, STEPS * DT, XSP, 2, noise_ws=w)
    for lane in range(2):
        xs, us = tmpc.solve(X0, STEPS * DT, XSP, noise_w=w[lane])
        np.testing.assert_allclose(txs[lane].numpy(), xs.numpy(), rtol=0,
                                   atol=1e-10)
        np.testing.assert_allclose(tus[lane].numpy(), us.numpy(), rtol=0,
                                   atol=1e-10)


def test_solve_mc_draws_its_noise_from_the_generator():
    """Without ``noise_ws`` the normals come from ``generator`` (default: a
    generator seeded with 0) times chol(R)': the same seed gives the same
    ensemble."""
    _, tmpc = _gp_pair("TA")
    a, _ = tmpc.solve_mc(X0, 2 * DT, XSP, 2)
    b, _ = tmpc.solve_mc(X0, 2 * DT, XSP, 2,
                         generator=torch.Generator().manual_seed(0))
    c, _ = tmpc.solve_mc(X0, 2 * DT, XSP, 2,
                         generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="noise_ws must be"):
        tmpc.solve_mc(X0, 2 * DT, XSP, 2, noise_ws=np.zeros((2, 3, 4)))


def test_violation_rates_unit():
    """``tests/test_mpc.py::test_violation_rates_unit`` on the port's copy:
    the initial state excluded, unbounded dims masked out; and the same
    numbers as the JAX package's module."""
    xlb = np.array([0.0, -1e10])
    xub = np.array([1.0, 1e10])
    xs = np.zeros((4, 3, 2))
    xs[:, :, 1] = 5.0
    xs[:, 0, 0] = 2.0
    xs[0, 1, 0] = 2.0
    xs[1, 1, 0] = -1.0
    rate, worst, active = violation_rates(xs, xlb, xub)
    assert active.tolist() == [True, False]
    assert rate[0] == pytest.approx(2.0 / 8.0)
    assert worst[0] == pytest.approx(0.5)
    assert rate[1] == 0.0
    for g, r in zip((rate, worst, active), jcal.violation_rates(xs, xlb, xub)):
        np.testing.assert_array_equal(g, r)


def test_chance_calibration_matches_jax():
    """``tests/test_mpc.py::test_chance_constraint_empirical_calibration``
    at 8 lanes and 6 steps: the exact model with the upper bound of tank 1
    0.02 above the setpoint.  The percentile-0.95 controller audited in
    both packages on the same noise: the rates, the worst-step rates, the
    bound and the ``calibrated`` flag are JAX's; the untightened
    controller (audited against alpha = 0.05) violates more often."""
    n_mc, n_steps = 8, 6
    jm = JModel(Nx=4, Nu=2, ode=lambda x, u: jode(x, u), dt=DT,
                R=np.diag([1e-3] * 4), clip_negative=True,
                dtype=jnp.float64, integrator_substeps=10)
    tm = Model(Nx=4, Nu=2, ode=four_tank_ode, dt=DT, R=np.diag([1e-3] * 4),
               clip_negative=True, dtype=torch.float64,
               integrator_substeps=10, device="cpu")
    kw = dict(horizon=5 * DT, gp=None, discrete_method="rk4", gp_method="ME",
              Q=np.diag([10.0, 10.0, 0.1, 0.1]), R=0.01 * np.eye(2),
              ulb=[0.0, 0.0], uub=[8.0, 8.0], xlb=[0.5, 0.5, 0.1, 0.1],
              xub=[float(XSP[0]) + 0.02, 25.0, 8.0, 8.0], feedback=False,
              cov_updates=1, solver_opts=dict(al_iters=2, max_iters=4),
              init_solver_opts=dict(al_iters=2, max_iters=8))
    x0 = np.array([8.0, 9.0, 1.0, 1.0])
    key = jax.random.PRNGKey(5)
    jmpc = JMPC(model=jm, percentile=0.95, **kw)
    tmpc = MPC(model=tm, percentile=0.95, device="cpu", **kw)
    w = _jax_noise(jmpc, key, n_mc, n_steps)
    ref = jcal.chance_calibration(jmpc, x0, n_steps * DT, XSP, n_mc=n_mc,
                                  key=key)
    got = chance_calibration(tmpc, x0, n_steps * DT, XSP, n_mc=n_mc,
                             noise_ws=w)
    assert sorted(got) == sorted(ref)
    for k in ("alpha", "bound", "n_mc", "calibrated"):
        assert got[k] == ref[k], k
    for k in ("rate", "worst_step_rate", "active"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_allclose(tmpc.last_mc["x_sim"], jmpc.last_mc["x_sim"],
                               rtol=0, atol=1e-6)
    plain = MPC(model=tm, percentile=None, device="cpu", **kw)
    loose = chance_calibration(plain, x0, n_steps * DT, XSP, n_mc=n_mc,
                               noise_ws=w, alpha=0.05)
    assert loose["rate"][0] > got["rate"][0]
    with pytest.raises(ValueError, match="no percentile"):
        chance_calibration(plain, x0, DT, XSP, n_mc=2)


def _predict_args(lanes, b=5, n=7, d=6, ny=4, seed=0):
    rng = np.random.default_rng(seed)
    t = torch.float64
    return (torch.tensor(rng.uniform(-2, 2, (lanes, b, d)), dtype=t),
            torch.tensor(rng.uniform(-2, 2, (lanes, n, d)), dtype=t),
            torch.tensor(np.exp(0.2 * rng.standard_normal((lanes, ny, d))),
                         dtype=t),
            torch.tensor(rng.uniform(0.5, 1.5, (lanes, ny)), dtype=t),
            torch.tensor(rng.standard_normal((lanes, ny, n)), dtype=t))


@pytest.mark.parametrize("case", ["queries", "posteriors", "nested"])
def test_predict_vmap_rule_matches_plain_version(case):
    """K3's custom operator under ``vmap`` on CPU tensors (its plain version
    inside, so the rule itself is what is tested): only the queries
    batched (the lanes fold into the query dim), every argument batched
    (the lanes become the leading problem dim), and a vmap of vmaps (a
    problem dim merged with the outer lanes).  Each lane equals the plain
    version on its own inputs."""
    z, x, ell, sf2, alpha = _predict_args(3)
    if case == "queries":
        mu, ks = vmap(lambda zz: gp_cuda.gp_predict_batch_op(
            zz, x[0], ell[0], sf2[0], alpha[0]))(z)
        refs = [gp_cuda.gp_predict_batch_reference(z[i], x[0], ell[0],
                                                   sf2[0], alpha[0])
                for i in range(3)]
    elif case == "posteriors":
        mu, ks = vmap(gp_cuda.gp_predict_batch_op)(z, x, ell, sf2, alpha)
        refs = [gp_cuda.gp_predict_batch_reference(z[i], x[i], ell[i],
                                                   sf2[i], alpha[i])
                for i in range(3)]
    else:
        z2 = torch.stack([z, 2.0 * z])
        inner = vmap(gp_cuda.gp_predict_batch_op,
                     in_dims=(0, 0, None, None, 0))
        mu, ks = vmap(inner, in_dims=(0, None, None, None, None))(
            z2, x, ell[0], sf2[0], alpha)
        mu, ks = mu.flatten(0, 1), ks.flatten(0, 1)
        refs = [gp_cuda.gp_predict_batch_reference(z2[j, i], x[i], ell[0],
                                                   sf2[0], alpha[i])
                for j in range(2) for i in range(3)]
    assert mu.shape == (len(refs), 4, 5) and ks.shape == (len(refs), 4, 5, 7)
    for i, (m, k) in enumerate(refs):
        torch.testing.assert_close(mu[i], m, rtol=0, atol=1e-13)
        torch.testing.assert_close(ks[i], k, rtol=0, atol=1e-13)


def test_predict_plain_version_takes_a_problem_dim():
    """The plain version with a leading problem dim on every argument is
    each problem's own plain version."""
    z, x, ell, sf2, alpha = _predict_args(4, seed=1)
    mu, ks = gp_cuda.gp_predict_batch_reference(z, x, ell, sf2, alpha)
    for i in range(4):
        m, k = gp_cuda.gp_predict_batch_reference(z[i], x[i], ell[i], sf2[i],
                                                  alpha[i])
        assert torch.equal(mu[i], m) and torch.equal(ks[i], k)
