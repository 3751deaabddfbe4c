"""Port parity for GP training, validation and persistence: the NLL and its
gradient, the multistart initialization, the batched L-BFGS fit, the
batched prediction behind ``validate``, ``save_model`` read back by the JAX
package, and the plant's training-data generation, each against the JAX
package in f64 on the same numpy inputs.  Also the default device: the
card, and an error without one."""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gpmpc_tpu import GP as JGP
from gpmpc_tpu.models import gp_core as jcore
from gpmpc_tpu.models.dynamics import Model as JModel
from gpmpc_tpu.systems import four_tank_ode as jode
from gpmpc_tpu.utils.config import GPConfig as JConfig
from gpmpc_tpu_torch import GP, MPC, Model
from gpmpc_tpu_torch.models import gp_core, lbfgs
from gpmpc_tpu_torch.models.convert import (FIXTURE, gp_from_fixture,
                                            gp_from_numpy, hypers_to_numpy)
from gpmpc_tpu_torch.ops import cuda_kernels as ck
from gpmpc_tpu_torch.systems import four_tank_ode
from gpmpc_tpu_torch.utils.config import GPConfig

OPTS = dict(jitter=1e-5, min_noise=1e-4)
BOUNDS = dict(uub=[6.0, 6.0], ulb=[0.0, 0.0], xub=[20.0, 20.0, 6.0, 6.0],
              xlb=[1.0, 1.0, 0.5, 0.5])
CPU = dict(device="cpu", dtype=torch.float64)


def _fixture_normalized():
    """The fixture's training set normalized as GP does, f64."""
    f = np.load(FIXTURE)
    x, y = f["tank_X"].astype(np.float64), f["tank_Y"].astype(np.float64)
    return ((x - x.mean(0)) / x.std(0), (y - y.mean(0)) / y.std(0), f)


def _nll_pair(le, ls, ln, mw, x, y, mean_func, cfg_kw):
    """NLL and gradient of one output dim in both packages."""
    jcfg, tcfg = JConfig(**cfg_kw), GPConfig(**cfg_kw)

    def fj(p):
        return jcore.nll_single(*p, jnp.asarray(x), jnp.asarray(y), jcfg,
                                mean_func)

    vj, gj = jax.value_and_grad(fj)(tuple(map(jnp.asarray, (le, ls, ln, mw))))
    args = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
            for a in (le, ls, ln, mw)]
    vt = gp_core.nll_single(*args, torch.as_tensor(x), torch.as_tensor(y),
                            tcfg, mean_func)
    gt = [torch.zeros_like(a) if g is None else g for a, g in
          zip(args, torch.autograd.grad(vt, args, allow_unused=True))]
    flat = np.concatenate
    return (float(vj), float(vt.detach()),
            flat([np.ravel(g) for g in gj]),
            flat([g.numpy().ravel() for g in gt]))


@pytest.mark.parametrize("dim", [0, 1, 2, 3])
def test_nll_and_gradient_match_jax_at_fixture_hypers(dim):
    """The fixture's f32-trained hypers evaluated in f64 (N=100, D=6):
    value and gradient within 1e-8 relative (the gradient relative to its
    largest entry)."""
    x, y, f = _fixture_normalized()
    vj, vt, gj, gt = _nll_pair(f["tank_log_ell"][dim].astype(np.float64),
                               np.float64(f["tank_log_sf2"][dim]),
                               np.float64(f["tank_log_sn2"][dim]),
                               np.zeros(0), x, y[:, dim], "zero", OPTS)
    assert abs(vt - vj) <= 1e-8 * abs(vj)
    np.testing.assert_allclose(gt, gj, rtol=0,
                               atol=1e-8 * np.abs(gj).max())


@pytest.mark.parametrize("seed,mean_func", [(0, "zero"), (1, "linear"),
                                            (2, "poly"), (3, "const")])
def test_nll_and_gradient_match_jax_at_random_hypers(seed, mean_func):
    """Random hypers and mean weights on the fixture inputs with a random
    smooth target (N=100): value and gradient within 1e-8 relative, the
    mean-function weights' gradient included."""
    x, _, _ = _fixture_normalized()
    rng = np.random.default_rng(seed)
    y = np.sin(x[:, 0]) + 0.3 * x[:, 1] * x[:, 4] + 0.05 * rng.standard_normal(
        100)
    f = {"zero": 0, "const": 1, "linear": 7, "poly": 13}[mean_func]
    vj, vt, gj, gt = _nll_pair(0.4 * rng.standard_normal(6),
                               np.float64(rng.normal(0.0, 0.5)),
                               np.float64(rng.normal(-4.0, 1.0)),
                               0.3 * rng.standard_normal(f), x, y, mean_func,
                               dict(jitter=1e-8, min_noise=1e-6))
    assert abs(vt - vj) <= 1e-8 * abs(vj)
    np.testing.assert_allclose(gt, gj, rtol=0,
                               atol=1e-8 * np.abs(gj).max())


def test_nll_batch_is_the_per_problem_nll():
    x, y, f = _fixture_normalized()
    cfg = GPConfig(**OPTS)
    h = [torch.as_tensor(f[f"tank_log_{k}"], dtype=torch.float64)
         for k in ("ell", "sf2", "sn2")]
    xt, yt = torch.as_tensor(x), torch.as_tensor(y.T)
    batched = gp_core.nll_batch(*h, torch.zeros((4, 0), dtype=torch.float64),
                                xt, yt, cfg, "zero")
    for d in range(4):
        single = gp_core.nll_single(h[0][d], h[1][d], h[2][d],
                                    torch.zeros(0, dtype=torch.float64), xt,
                                    yt[d], cfg, "zero")
        assert abs(float(batched[d] - single)) <= 1e-12 * abs(float(single))


def test_init_hypers_start_zero_matches_jax():
    """Start 0 is the unperturbed heuristic in both packages (the same
    formula; torch and XLA sum the std's reductions in other orders, so
    they part in the last few ulps); the other starts are draws (from other
    generators) around it."""
    x, y, _ = _fixture_normalized()
    ref = jcore._init_hypers(jax.random.PRNGKey(0), jnp.asarray(x),
                             jnp.asarray(y), 3, "linear")
    got = gp_core._init_hypers(torch.Generator().manual_seed(0),
                               torch.as_tensor(x), torch.as_tensor(y), 3,
                               "linear")
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g[0].numpy(), np.asarray(r[0]),
                                   rtol=1e-15, atol=1e-15)
    assert not np.allclose(got.log_ell[1].numpy(), got.log_ell[0].numpy())
    assert np.all(got.mean_w.numpy() == 0.0)


def test_fit_matches_jax_x64():
    """The fixture's recipe (multistart=1, max_iters=100, jitter=1e-5,
    min_noise=1e-4) on its normalized training set: NLL per dim within 1e-6
    relative, log_ell and log_sf2 within 1e-3, log_sn2 only where the noise
    is above a tenth of its floor (below it log_sn2 is a flat direction)."""
    x, y, _ = _fixture_normalized()
    cfg_kw = dict(multistart=1, max_iters=100, **OPTS)
    h_j, nll_j = jcore.fit(jnp.asarray(x), jnp.asarray(y), JConfig(**cfg_kw),
                           jax.random.PRNGKey(1))
    h_t, nll_t, n_evals = gp_core.fit(torch.as_tensor(x), torch.as_tensor(y),
                                      GPConfig(**cfg_kw),
                                      torch.Generator().manual_seed(1))
    nll_j = np.asarray(nll_j)
    np.testing.assert_allclose(nll_t.numpy(), nll_j, rtol=1e-6)
    np.testing.assert_allclose(h_t.log_ell.numpy(), np.asarray(h_j.log_ell),
                               atol=1e-3)
    np.testing.assert_allclose(h_t.log_sf2.numpy(), np.asarray(h_j.log_sf2),
                               atol=1e-3)
    loud = np.exp(np.asarray(h_j.log_sn2)) >= 0.1 * OPTS["min_noise"]
    assert loud.any()
    np.testing.assert_allclose(h_t.log_sn2.numpy()[loud],
                               np.asarray(h_j.log_sn2)[loud], atol=1e-3)
    assert 1 < n_evals < 100 * 21


def test_fit_multistart_takes_the_best_start():
    """Two starts per dim on a small problem: each dim's result is the
    better of its two starts, as the JAX fit's argmin."""
    x, y, _ = _fixture_normalized()
    x, y = torch.as_tensor(x[:30]), torch.as_tensor(y[:30, :2])
    cfg = GPConfig(multistart=2, max_iters=30, **OPTS)
    gen = torch.Generator().manual_seed(3)
    h, nll, _ = gp_core.fit(x, y, cfg, gen)
    starts = gp_core._init_hypers(torch.Generator().manual_seed(3), x, y, 2,
                                  "zero")
    d = x.shape[1]
    theta0 = torch.cat([starts.log_ell.reshape(4, d),
                        starts.log_sf2.reshape(4, 1),
                        starts.log_sn2.reshape(4, 1)], dim=1)

    def objective(theta):
        return gp_core.nll_batch(*gp_core._unpack(theta, d), x,
                                 y.mT.repeat(2, 1), cfg, "zero")

    _, values, _ = lbfgs.minimize(objective, theta0, 30, cfg.grad_tol)
    np.testing.assert_allclose(nll.numpy(),
                               values.reshape(2, 2).min(0).values.numpy(),
                               rtol=1e-12)
    with pytest.raises(TypeError, match="DeviceMesh"):
        gp_core.fit(x, y, cfg, gen, mesh=object())


@pytest.fixture(scope="module")
def held_out():
    """100 noise-free held-out points of the four-tank plant, made by the
    JAX package (the example's recipe, PRNGKey(9))."""
    jm = JModel(Nx=4, Nu=2, ode=lambda x, u: jode(x, u), dt=3.0,
                R=np.diag([1e-3] * 4), clip_negative=True,
                dtype=jnp.float64, integrator_substeps=10)
    xt, yt = jm.generate_training_data(100, **BOUNDS, noise=False,
                                       key=jax.random.PRNGKey(9))
    return np.asarray(xt), np.asarray(yt)


def test_validate_matches_jax(held_out):
    """SMSE, MNLP and RMSE of the fixture GP on the same held-out arrays,
    through the port's batched predict (K3's plain version on the CPU):
    within 1e-6 relative of JAX's validate."""
    xt, yt = held_out
    f = np.load(FIXTURE)
    hyp = [f[f"tank_log_{k}"].astype(np.float64) for k in ("ell", "sf2",
                                                           "sn2")]
    jgp = JGP(jnp.asarray(f["tank_X"], jnp.float64),
              jnp.asarray(f["tank_Y"], jnp.float64), mean_func="zero",
              hyper=jcore.GPHypers(*map(jnp.asarray, hyp),
                                   mean_w=jnp.zeros((4, 0))),
              optimizer_opts=OPTS)
    tgp = gp_from_fixture(optimizer_opts=OPTS, **CPU)
    before = dict(ck.LAUNCHES)
    got = tgp.validate(xt, torch.tensor(yt), verbose=False)
    ref = jgp.validate(jnp.asarray(xt), yt, verbose=False)
    assert ck.LAUNCHES == before
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, np.asarray(r), rtol=1e-6)
    assert np.all(got[0] < 1e-2)         # the fixture GP has mean skill


def test_predict_batch_matches_pointwise_predict():
    tgp = gp_from_fixture(optimizer_opts=OPTS, **CPU)
    rng = np.random.default_rng(2)
    z = torch.as_tensor(rng.standard_normal((9, 6)))
    cfg = dataclasses.replace(tgp.cfg, predict_includes_noise=True)
    mu, var = gp_core.predict_batch(tgp.post, z, cfg)
    for b in range(9):
        m1, v1 = gp_core.predict(tgp.post, z[b], cfg)
        np.testing.assert_allclose(mu[b].numpy(), m1.numpy(), atol=1e-12)
        np.testing.assert_allclose(var[b].numpy(), v1.numpy(), atol=1e-12)


def test_trained_gp_saved_by_the_port_loads_in_jax(tmp_path, capsys):
    """A GP trained by the port (linear mean, two starts) saved with
    save_model, read by the JAX package's load_model: predictions within
    1e-10.  hypers_to_numpy carries the same hypers across.  The ``.npz``
    holds no jitter or noise floor, so the GP keeps the defaults."""
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (40, 3))
    y = np.stack([np.sin(2 * x[:, 0]) + x[:, 1], x[:, 2] ** 2], axis=1)
    tgp = GP(x, y, mean_func="linear", gp_method="ME", multistart=2,
             max_iters=40, seed=5, **CPU)
    assert tgp.get_size() == (40, 3, 2)
    assert tgp.nll.shape == (2,) and tgp.n_evals > 0
    tgp.print_hyper_parameters()
    assert "NLL=" in capsys.readouterr().out
    path = str(tmp_path / "gp.npz")
    tgp.save_model(path)
    jgp = JGP.load_model(path)
    assert jgp.gp_method == "ME" and jgp.cfg.mean_func == "linear"
    for k, v in hypers_to_numpy(tgp.hyper).items():
        np.testing.assert_array_equal(np.asarray(getattr(jgp.hyper, k)), v)
    back = GP.load_model(path, **CPU)
    # the variance cancels two terms of size sf2 (raw units): JAX takes the
    # explicit inverse, the port sf2 - ||L^-1 k*||^2; they part by ~1e-9
    var_scale = float((torch.exp(tgp.hyper.log_sf2) * tgp.norm.y_std ** 2
                       ).max())
    for z in rng.uniform(-1, 1, (4, 3)):
        mu_t, var_t = tgp.predict(z)
        mu_j, var_j = jgp.predict(jnp.asarray(z))
        np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j),
                                   atol=1e-10)
        np.testing.assert_allclose(var_t.numpy(), np.asarray(var_j),
                                   rtol=0, atol=1e-8 * var_scale)
        assert torch.equal(back.predict(z)[0], mu_t)
    # the JAX-side numbers served by the port again
    gp2 = gp_from_numpy(x, y, mean_func="linear", gp_method="ME",
                        **hypers_to_numpy(tgp.hyper), **CPU)
    assert torch.equal(gp2.predict(x[0])[0], tgp.predict(x[0])[0])


def test_generate_training_data_and_sim_match_the_plant():
    """Samples lie in their bounds, Y is the plant step of X without noise
    (one batched integrate), a seeded generator repeats itself, noise has
    the model's covariance scale, and sim matches the JAX rollout."""
    m = Model(Nx=4, Nu=2, ode=four_tank_ode, dt=3.0, R=np.diag([1e-3] * 4),
              clip_negative=True, integrator_substeps=10, **CPU)
    x, y = m.generate_training_data(
        200, **BOUNDS, noise=False, generator=torch.Generator().manual_seed(9))
    assert x.shape == (200, 6) and y.shape == (200, 4)
    lo = np.array(BOUNDS["xlb"] + BOUNDS["ulb"])
    hi = np.array(BOUNDS["xub"] + BOUNDS["uub"])
    assert np.all(x.numpy() >= lo) and np.all(x.numpy() <= hi)
    for k in (0, 57, 199):
        assert torch.equal(y[k], m.integrate(x[k, :4], x[k, 4:]))
    x2, _ = m.generate_training_data(
        200, **BOUNDS, noise=False, generator=torch.Generator().manual_seed(9))
    assert torch.equal(x, x2)
    _, yn = m.generate_training_data(
        2000, **BOUNDS, generator=torch.Generator().manual_seed(1))
    _, ys = m.generate_training_data(
        2000, **BOUNDS, noise=False,
        generator=torch.Generator().manual_seed(1))
    resid = (yn - ys).numpy()
    assert 0.8e-3 < resid.var(0).min() and resid.var(0).max() < 1.2e-3
    jm = JModel(Nx=4, Nu=2, ode=lambda x, u: jode(x, u), dt=3.0,
                R=np.diag([1e-3] * 4), clip_negative=True, dtype=jnp.float64,
                integrator_substeps=10)
    u_seq = np.tile([[3.0, 3.0], [6.0, 0.0]], (3, 1))
    x0 = np.array([8.0, 10.0, 1.0, 1.5])
    np.testing.assert_allclose(m.sim(x0, u_seq).numpy(),
                               np.asarray(jm.sim(jnp.asarray(x0),
                                                 jnp.asarray(u_seq))),
                               rtol=1e-12)
    noisy = m.sim(x0, u_seq, noise=True,
                  generator=torch.Generator().manual_seed(0))
    assert noisy.shape == (7, 4) and not torch.equal(noisy, m.sim(x0, u_seq))
    with pytest.raises(ValueError, match="generator"):
        m.sim(x0, u_seq, noise=True)


def test_entry_points_default_to_the_card():
    """Model, GP, MPC and the gp_from_* functions without ``device`` go to
    the card; without one they raise and point to device="cpu"."""
    f = np.load(FIXTURE)
    build = [lambda: Model(Nx=4, Nu=2, ode=four_tank_ode, dt=3.0),
             lambda: GP(f["tank_X"][:10], f["tank_Y"][:10], train=False),
             lambda: gp_from_fixture(n=10),
             lambda: gp_from_numpy(f["tank_X"][:10], f["tank_Y"][:10],
                                   f["tank_log_ell"], f["tank_log_sf2"],
                                   f["tank_log_sn2"])]
    if torch.cuda.is_available():
        for b in build:
            assert b().device.type == "cuda"
        return
    for b in build:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            b()
    m = Model(Nx=4, Nu=2, ode=four_tank_ode, dt=3.0, device="cpu")
    g = gp_from_fixture(n=10, device="cpu")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        MPC(horizon=9.0, model=m, gp=g)
    with pytest.raises(ValueError, match="lives on"):
        MPC(horizon=9.0, model=m, gp=g, device="meta")
