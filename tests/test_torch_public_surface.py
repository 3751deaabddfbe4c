"""Port parity for the JAX package's last public pieces: the rank-1
Cholesky update and the small SPD solves (``ops/chol.py``), the KKT
backend policy (``solvers/riccati.py``), ``GP.moment_map``,
``Model.predict_compare``/``plot_compare``, ``MPC.plot`` and the
packages' re-exports, each against the JAX package in f64 on the same
numpy inputs."""

import importlib
import os
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gpmpc_tpu import GP as JGP
from gpmpc_tpu.models.dynamics import Model as JModel
from gpmpc_tpu.models.gp_core import GPHypers as JHypers
from gpmpc_tpu.ops import chol as jchol
from gpmpc_tpu.solvers import riccati as jric
from gpmpc_tpu.systems import four_tank_ode as jode
from gpmpc_tpu_torch import MPC, Model
from gpmpc_tpu_torch.models.convert import FIXTURE, gp_from_numpy
from gpmpc_tpu_torch.ops import chol as tchol
from gpmpc_tpu_torch.solvers import riccati as tric
from gpmpc_tpu_torch.systems import four_tank_ode
from gpmpc_tpu_torch.utils.plotting import MatplotlibMissing

RNG = np.random.default_rng(11)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch's CPU ops on one thread while this file runs: their many
    small ops lose ~15x to the thread pool's contention when the suite's
    workers share the cores (81 s against 5 s for the batched study)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = dict(device="cpu", dtype=torch.float64)


def _spd(n, seed):
    a = np.random.default_rng(seed).standard_normal((n, n))
    return a @ a.T + n * np.eye(n)


@pytest.mark.parametrize("downdate", [False, True])
def test_cholupdate_matches_jax(downdate):
    """Update and downdate of a 12 x 12 factor (as
    tests/test_gp_core.py::test_cholupdate): within 1e-10 of the JAX sweep,
    and the factor of L L^T +/- v v^T; also over a leading batch dim."""
    n = 12
    spd, v = _spd(n, 3), RNG.standard_normal(n)
    l = np.linalg.cholesky(spd + (np.outer(v, v) if downdate else 0.0))
    ref = np.asarray(jchol.cholupdate(jnp.asarray(l), jnp.asarray(v),
                                      downdate=downdate))
    got = tchol.cholupdate(torch.tensor(l), torch.tensor(v),
                           downdate=downdate).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)
    target = spd if downdate else spd + np.outer(v, v)
    np.testing.assert_allclose(got @ got.T, target, atol=1e-8)
    batched = tchol.cholupdate(torch.tensor(np.stack([l, l])),
                               torch.tensor(np.stack([v, v])),
                               downdate=downdate).numpy()
    np.testing.assert_allclose(batched[1], got, rtol=0, atol=1e-14)


def test_spd_solve_and_inverse_small_match_jax():
    """spd_solve_small on a vector and a matrix right-hand side and
    spd_inverse_small (one matrix and a batch of two) within 1e-10 of the
    JAX unrolled forms."""
    a = np.stack([_spd(5, 4), _spd(5, 5)])
    b, bm = RNG.standard_normal(5), RNG.standard_normal((5, 3))
    for rhs in (b, bm):
        ref = np.asarray(jchol.spd_solve_small(jnp.asarray(a[0]),
                                               jnp.asarray(rhs)))
        got = tchol.spd_solve_small(torch.tensor(a[0]), torch.tensor(rhs))
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-10)
    for aa in (a[0], a):
        ref = np.asarray(jchol.spd_inverse_small(jnp.asarray(aa)))
        got = tchol.spd_inverse_small(torch.tensor(aa)).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)
        np.testing.assert_allclose(aa @ got, np.broadcast_to(np.eye(5),
                                                             aa.shape),
                                   atol=1e-10)


def _gp_pair(log_sn2=None, perm=None):
    """The fixture GP cut to 40 points in both packages, f64; ``log_sn2``
    replaces its noise, ``perm`` permutes the JAX side's training points."""
    f = np.load(FIXTURE)
    x, y = (f[f"tank_{k}"][:40].astype(np.float64) for k in "XY")
    h = {k: f[f"tank_log_{k}"].astype(np.float64)
         for k in ("ell", "sf2", "sn2")}
    if log_sn2 is not None:
        h["sn2"] = np.full(4, log_sn2)
    p = np.arange(40) if perm is None else perm
    jgp = JGP(x[p], y[p], mean_func="zero", gp_method="TA",
              hyper=JHypers(*(jnp.asarray(h[k]) for k in ("ell", "sf2",
                                                           "sn2")),
                            jnp.zeros((4, 0))))
    tgp = gp_from_numpy(x, y, h["ell"], h["sf2"], h["sn2"],
                        mean_func="zero", gp_method="TA", **CPU)
    return jgp, tgp, x[3]


@pytest.fixture(scope="module")
def fixture_gps():
    return _gp_pair()


#: a noise of 1e-3 in the normalized space: the fixture's own (down to
#: 1.2e-8) makes K ill-conditioned enough that EM's output covariance
#: (sf2 minus the explicit inverse's quadratic form) moves by ~6e-7 in the
#: JAX package under a mere permutation of the training points
CONDITIONED = float(np.log(1e-3))


@pytest.mark.parametrize("method", ["TA", "EM", "UT"])
@pytest.mark.parametrize("noise", ["fixture", "conditioned"])
def test_moment_map_matches_jax(fixture_gps, method, noise):
    """GP.moment_map() at a training input with a nonzero input covariance
    (as tests/test_matern.py holds the JAX map): the mean, the output
    covariance and the input-output covariance within 1e-8 of JAX's.  At
    the fixture's noise EM's output covariance is held instead within the
    JAX package's own spread under a permutation of its training points
    (rounding, as the car golden's first difference; ROADMAP §3)."""
    jgp, tgp, z = (fixture_gps if noise == "fixture" else
                   _gp_pair(log_sn2=CONDITIONED))
    jgp.set_method(method)
    tgp.set_method(method)
    cov = 0.01 * np.eye(6) + 0.002 * np.ones((6, 6))
    ref = jgp.moment_map()(jnp.asarray(z), jnp.asarray(cov))
    got = tgp.moment_map()(torch.tensor(z), torch.tensor(cov))
    assert tgp.moment_map() is tgp._moment_map
    tol = [1e-8, 1e-8, 1e-8]
    if method == "EM" and noise == "fixture":
        jperm, _, _ = _gp_pair(perm=np.random.default_rng(0).permutation(40))
        jperm.set_method("EM")
        moved = jperm.moment_map()(jnp.asarray(z), jnp.asarray(cov))[1]
        tol[1] = float(np.abs(np.asarray(moved) - np.asarray(ref[1])).max())
        assert tol[1] > 1e-8
    for g, r, t in zip(got, ref, tol):
        assert np.all(np.isfinite(g.numpy()))
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=t)


def test_predict_compare_matches_jax(fixture_gps, tmp_path):
    """Model.predict_compare of the four-tank plant against the fixture
    GP's mean over 8 random inputs, noise off: both rollouts within 1e-8
    of JAX's; plot_compare writes a PNG.  With a generator the plant's
    rollout takes process noise and the prediction does not."""
    jgp, tgp, _ = fixture_gps
    x0 = np.array([8.0, 10.0, 1.0, 1.5])
    u_seq = RNG.uniform(0.0, 6.0, (8, 2))
    jm = JModel(Nx=4, Nu=2, ode=lambda x, u: jode(x, u), dt=3.0,
                R=np.diag([1e-3] * 4), clip_negative=True,
                dtype=jnp.float64, integrator_substeps=10)
    tm = Model(Nx=4, Nu=2, ode=four_tank_ode, dt=3.0, R=np.diag([1e-3] * 4),
               clip_negative=True, integrator_substeps=10, **CPU)
    jmean, tmean = jgp.mean_fn(), tgp.mean_fn()
    ref = jm.predict_compare(
        jnp.asarray(x0), jnp.asarray(u_seq),
        lambda x, u: jmean(jnp.concatenate([x, u])))
    got = tm.predict_compare(x0, u_seq,
                             lambda x, u: tmean(torch.cat([x, u])))
    for g, r in zip(got, ref):
        assert g.shape == (9, 4)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-8)
    noisy, pred = tm.predict_compare(
        x0, u_seq, lambda x, u: tmean(torch.cat([x, u])),
        generator=torch.Generator().manual_seed(0))
    assert torch.equal(pred, got[1]) and not torch.equal(noisy, got[0])
    f = tmp_path / "cmp.png"
    tm.plot_compare(*got, filename=str(f))
    assert f.stat().st_size > 0


def test_mpc_plot_writes_a_png_and_names_matplotlib(tmp_path, monkeypatch):
    """MPC.plot draws the last solve (states, inputs, bands, bounds) to a
    PNG; before a solve it raises; without matplotlib it raises
    MatplotlibMissing, an ImportError that names it."""
    model = Model(Nx=4, Nu=2, ode=four_tank_ode, dt=3.0,
                  R=np.diag([1e-3] * 4), clip_negative=True,
                  integrator_substeps=10, **CPU)
    mpc = MPC(horizon=3 * 3.0, model=model, gp=None, gp_method="ME",
              discrete_method="rk4", Q=np.diag([20.0, 20.0, 0.1, 0.1]),
              R=0.05 * np.eye(2), ulb=[0.0, 0.0], uub=[8.0, 8.0],
              xlb=[0.5, 0.5, 0.1, 0.1], xub=[16.0, 16.0, 8.0, 8.0],
              feedback=False, percentile=None, cov_updates=1,
              solver_opts=dict(al_iters=2, max_iters=4),
              init_solver_opts=dict(al_iters=2, max_iters=4), device="cpu")
    with pytest.raises(RuntimeError, match="solve"):
        mpc.plot()
    mpc.solve(np.array([8.0, 10.0, 1.0, 1.5]), 3 * 3.0,
              np.array([12.4, 12.7, 1.8, 1.4]), noise=False)
    f = tmp_path / "mpc.png"
    mpc.plot(filename=str(f))
    assert f.stat().st_size > 0
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(MatplotlibMissing, match="matplotlib"):
        mpc.plot(filename=str(tmp_path / "none.png"))
    with pytest.raises(ImportError, match="matplotlib"):
        model.plot_compare(np.zeros((2, 4)), np.zeros((2, 4)))


@pytest.mark.parametrize("nt,f64", [(5, False), (7, False), (8, False),
                                    (20, False), (8, True), (40, True)])
def test_set_kkt_policy_switches_select_backend_as_jax(nt, f64):
    """Under KKTPolicy(parallel_min_nt=8) set in both packages, the port
    picks the backend JAX picks at each (nt, dtype); the default policy
    (20) is the JAX default's and is back after reset."""
    assert tric.get_kkt_policy() == tric.KKTPolicy()
    assert tric.KKTPolicy().parallel_min_nt == \
        jric.KKTPolicy().parallel_min_nt
    jdt, tdt = ((jnp.float64, torch.float64) if f64 else
                (jnp.float32, torch.float32))
    default_before = tric.select_backend(nt, tdt).__name__
    jold = jric.get_kkt_policy()
    try:
        jric.set_kkt_policy(jric.KKTPolicy(parallel_min_nt=8))
        tric.set_kkt_policy(tric.KKTPolicy(parallel_min_nt=8))
        assert tric.get_kkt_policy().parallel_min_nt == 8
        assert tric.select_backend(nt, tdt).__name__ == \
            jric.select_backend(nt, jdt).__name__
    finally:
        jric.set_kkt_policy(jold)
        tric.set_kkt_policy(tric.KKTPolicy())
    assert tric.select_backend(nt, tdt).__name__ == default_before


#: the JAX package's TPU dispatch, which the port leaves out (ROADMAP "Not
#: ported"): each CUDA wrapper picks by the tensor's device
DISPATCH = {"PallasPolicy", "set_policy", "cholesky_auto",
            "kernel_gram_auto", "se_ard_gram_auto"}


@pytest.mark.parametrize("pkg", ["ops", "models", "utils"])
def test_reexports_match_jax(pkg):
    """Each subpackage's __all__ holds the JAX one's names minus the
    dispatch names (ops and models exactly; utils also its modules), and
    each name resolves."""
    jmod = importlib.import_module(f"gpmpc_tpu.{pkg}")
    tmod = importlib.import_module(f"gpmpc_tpu_torch.{pkg}")
    want = set(jmod.__all__) - DISPATCH
    got = set(tmod.__all__)
    assert want <= got and not got & DISPATCH
    if pkg != "utils":
        assert got == want
    for name in got:
        assert getattr(tmod, name) is not None
    assert os.path.dirname(tmod.__file__).endswith(
        os.path.join("gpmpc_tpu_torch", pkg))
