"""Port parity for the Matérn-5/2 and -3/2 kernel families: the kernels
(``ops/kernels.py``), the NLL and its gradient, the fit, TA's ``jacfwd``
at zero distance, the EM guard, a JAX-saved Matérn model loaded by the
port, and online conditioning of a Matérn posterior, each against the JAX
package in f64 on the same numpy inputs."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gpmpc_tpu import GP as JGP
from gpmpc_tpu.models import gp_core as jcore
from gpmpc_tpu.models.propagate import propagate_ta as jpropagate_ta
from gpmpc_tpu.ops import kernels as jk
from gpmpc_tpu.parallel import online_gp as jonline
from gpmpc_tpu.utils.config import GPConfig as JConfig
from gpmpc_tpu_torch import GP
from gpmpc_tpu_torch.models import gp_core
from gpmpc_tpu_torch.models.convert import (FIXTURE, gp_from_numpy,
                                            online_posterior_from_numpy)
from gpmpc_tpu_torch.models.propagate import propagate_em, propagate_ta
from gpmpc_tpu_torch.ops import cuda_kernels as ck
from gpmpc_tpu_torch.ops import kernels as tk
from gpmpc_tpu_torch.parallel import online_gp
from gpmpc_tpu_torch.utils.config import GPConfig

FAMILIES = ["matern52", "matern32"]
OPTS = dict(jitter=1e-5, min_noise=1e-4)


def _fixture_normalized():
    f = np.load(FIXTURE)
    x, y = f["tank_X"].astype(np.float64), f["tank_Y"].astype(np.float64)
    return (x - x.mean(0)) / x.std(0), (y - y.mean(0)) / y.std(0)


@pytest.mark.parametrize("name", FAMILIES)
def test_kernel_cross_and_gram_match_jax(name):
    """kernel_cross (a many-point and a one-point side) and kernel_gram
    (one problem, and P problems with one ell row each) within 1e-12 of
    the JAX forms; the Gram's diagonal exactly sf2 + sn2 + jitter sf2."""
    rng = np.random.default_rng(1)
    x, z = rng.standard_normal((9, 4)), rng.standard_normal((5, 4))
    ells = np.exp(0.3 * rng.standard_normal((3, 4)))
    for xx, zz in ((x, z), (x[:1], z), (x, z[:1])):
        got = tk.kernel_cross(name, torch.tensor(xx), torch.tensor(zz),
                              torch.tensor(ells[0]),
                              torch.tensor(1.7, dtype=torch.float64))
        ref = jk.kernel_cross(name, jnp.asarray(xx), jnp.asarray(zz),
                              jnp.asarray(ells[0]), 1.7)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-12)
    sf2, sn2 = np.array([1.7, 0.4, 2.2]), np.array([0.03, 0.1, 1e-4])
    got = tk.kernel_gram(name, torch.tensor(x), torch.tensor(ells),
                         torch.tensor(sf2), torch.tensor(sn2), jitter=1e-5)
    for p in range(3):
        ref = jk.kernel_gram(name, jnp.asarray(x), jnp.asarray(ells[p]),
                             sf2[p], sn2[p], jitter=1e-5)
        np.testing.assert_allclose(got[p].numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-12)
        one = tk.kernel_gram(name, torch.tensor(x), torch.tensor(ells[p]),
                             sf2[p], sn2[p], jitter=1e-5)
        assert torch.equal(one, got[p])
        np.testing.assert_array_equal(np.diag(got[p].numpy()),
                                      sf2[p] + sn2[p] + 1e-5 * sf2[p])


def test_unknown_kernel_family_raises():
    x = torch.zeros((2, 3), dtype=torch.float64)
    for call in (lambda: tk.kernel_cross("rq", x, x, torch.ones(3), 1.0),
                 lambda: tk.kernel_gram("rq", x, torch.ones(3), 1.0),
                 lambda: GP(x, x, kernel="rq", train=False, device="cpu")):
        with pytest.raises(ValueError, match="unknown kernel"):
            call()


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("dim", [0, 2])
def test_nll_and_gradient_match_jax(name, dim):
    """The fixture's inputs and targets (N=100, D=6) at fixed hypers near
    its fit: value and gradient within 1e-10 relative (the gradient to its
    largest entry)."""
    x, y = _fixture_normalized()
    f = np.load(FIXTURE)
    le = f["tank_log_ell"][dim].astype(np.float64) + 0.3
    ls, ln = np.float64(f["tank_log_sf2"][dim]), np.float64(-6.0)
    jcfg, tcfg = JConfig(kernel=name, **OPTS), GPConfig(kernel=name, **OPTS)

    def fj(p):
        return jcore.nll_single(*p, jnp.asarray(x), jnp.asarray(y[:, dim]),
                                jcfg, "zero")

    vj, gj = jax.value_and_grad(fj)(tuple(map(jnp.asarray,
                                              (le, ls, ln, np.zeros(0)))))
    args = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
            for a in (le, ls, ln)]
    vt = gp_core.nll_single(*args, torch.zeros(0, dtype=torch.float64),
                            torch.tensor(x), torch.tensor(y[:, dim]), tcfg,
                            "zero")
    gt = torch.autograd.grad(vt, args)
    assert abs(float(vt.detach()) - float(vj)) <= 1e-10 * abs(float(vj))
    g_ref = np.concatenate([np.ravel(g) for g in gj[:3]])
    g_got = np.concatenate([g.numpy().ravel() for g in gt])
    np.testing.assert_allclose(g_got, g_ref, rtol=0,
                               atol=1e-10 * np.abs(g_ref).max())


def test_matern_nll_batch_launches_no_gram_kernel(monkeypatch):
    """A Matérn NLL evaluation of P problems is one Cholesky (K5's
    wrapper) and no K4 call: its Gram is plain PyTorch, as in the JAX
    package; the SE one calls both."""
    from gpmpc_tpu_torch.ops import gp_cuda
    calls = []
    for fn in ("se_ard_gram", "cholesky"):
        inner = getattr(gp_cuda, fn)
        monkeypatch.setattr(gp_cuda, fn, lambda *a, _f=fn, _i=inner:
                            calls.append(_f) or _i(*a))
    x, y = (torch.tensor(v[:30]) for v in _fixture_normalized())
    h = [torch.zeros((4, 6), dtype=torch.float64),
         torch.zeros(4, dtype=torch.float64),
         torch.full((4,), -4.0, dtype=torch.float64),
         torch.zeros((4, 0), dtype=torch.float64)]
    for kernel, want in (("matern52", ["cholesky"]),
                         ("se", ["se_ard_gram", "cholesky"])):
        calls.clear()
        gp_core.nll_batch(*h, x, y.mT, GPConfig(kernel=kernel), "zero")
        assert calls == want


def test_init_hypers_start_zero_is_kernel_blind():
    """Start 0 depends on the data alone in both packages (the same
    heuristic, whatever the kernel): within 1e-15 of JAX's."""
    x, y = _fixture_normalized()
    ref = jcore._init_hypers(jax.random.PRNGKey(0), jnp.asarray(x),
                             jnp.asarray(y), 2, "zero")
    got = gp_core._init_hypers(torch.Generator().manual_seed(0),
                               torch.tensor(x), torch.tensor(y), 2, "zero")
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g[0].numpy(), np.asarray(r[0]),
                                   rtol=1e-15, atol=1e-15)


@pytest.mark.parametrize("name", FAMILIES)
def test_fit_matches_jax_x64(name):
    """The fixture's recipe (multistart=1, max_iters=100, jitter=1e-5,
    min_noise=1e-4) with a Matérn kernel on the fixture's normalized
    training set: the fitted NLL per dim within 1e-6 relative of the JAX
    package's, as the SE fit's test holds it."""
    x, y = _fixture_normalized()
    cfg_kw = dict(multistart=1, max_iters=100, kernel=name, **OPTS)
    _, nll_j = jcore.fit(jnp.asarray(x), jnp.asarray(y), JConfig(**cfg_kw),
                         jax.random.PRNGKey(1))
    _, nll_t, n_evals = gp_core.fit(torch.tensor(x), torch.tensor(y),
                                    GPConfig(**cfg_kw),
                                    torch.Generator().manual_seed(1))
    np.testing.assert_allclose(nll_t.numpy(), np.asarray(nll_j), rtol=1e-6)
    assert 1 < n_evals < 100 * 21


@pytest.mark.parametrize("name", FAMILIES)
def test_ta_jacfwd_at_zero_distance_is_finite_and_matches_jax(name):
    """TA at a training input (r = 0 to that point, where sqrt's floor
    keeps the tangent finite), with and without an input covariance: mu,
    Sigma and C finite and within 1e-10 of the JAX package's."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-2, 2, (20, 3))
    y = np.stack([np.sin(x[:, 0]) * x[:, 1], np.abs(x[:, 2])], axis=1)
    hyp = dict(log_ell=np.zeros((2, 3)), log_sf2=np.zeros(2),
               log_sn2=np.full(2, -5.0))
    jg = JGP(jnp.asarray(x), jnp.asarray(y), kernel=name,
             hyper=jcore.GPHypers(*map(jnp.asarray, hyp.values()),
                                  mean_w=jnp.zeros((2, 0))))
    tg = gp_from_numpy(x, y, **hyp, kernel=name, device="cpu",
                       dtype=torch.float64)
    for cov in (np.zeros((3, 3)), 0.05 * np.eye(3)):
        ref = jpropagate_ta(jg.post, jg.norm, jg.cfg, jnp.asarray(x[4]),
                            jnp.asarray(cov))
        got = propagate_ta(tg.post, tg.norm, tg.cfg, torch.tensor(x[4]),
                           torch.tensor(cov))
        for g, r in zip(got, ref):
            r = np.asarray(r)
            assert np.all(np.isfinite(g.numpy()))
            np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                       atol=1e-10 * max(np.abs(r).max(), 1.0))
    jac = torch.func.jacfwd(tg.mean_fn())(torch.tensor(x[4]))
    assert bool(torch.all(torch.isfinite(jac)))


def test_em_guard_names_ut_and_gh():
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (10, 2))
    tg = gp_from_numpy(x, x, np.zeros((2, 2)), np.zeros(2), np.zeros(2),
                       kernel="matern32", device="cpu", dtype=torch.float64)
    with pytest.raises(ValueError, match="kernel='se'.*UT/GH"):
        tg.set_method("EM")
    with pytest.raises(ValueError, match="SE-specific"):
        propagate_em(tg.post, tg.norm, tg.cfg, torch.zeros(2),
                     torch.zeros((2, 2)))
    for m in ("ME", "TA", "UT", "GH"):
        tg.set_method(m)


def test_jax_saved_matern_model_loads_in_the_port(tmp_path):
    """A Matérn-5/2 GP trained and saved by the JAX package, read by the
    port's load_model: the kernel carried, the mean within 1e-10 and the
    variance within 1e-8 of its scale (it cancels two terms of size sf2:
    JAX takes the explicit inverse, the port sf2 - ||L^-1 k*||^2, as in
    tests/test_torch_gp_train.py's SE case; measured 1.2e-9); and the
    port's save_model read back by the JAX package keeps the kernel."""
    rng = np.random.default_rng(5)
    x = rng.uniform(-2, 2, (40, 3))
    y = np.stack([np.abs(x[:, 0]) + np.sin(x[:, 1]), x[:, 2] ** 2], axis=1)
    jg = JGP(jnp.asarray(x), jnp.asarray(y), kernel="matern52",
             gp_method="TA", multistart=1, max_iters=60, seed=1)
    path = str(tmp_path / "m52.npz")
    jg.save_model(path)
    tg = GP.load_model(path, device="cpu", dtype=torch.float64)
    assert tg.cfg.kernel == "matern52"
    scale = float((torch.exp(tg.hyper.log_sf2) * tg.norm.y_std ** 2).max())
    for z in rng.uniform(-2, 2, (5, 3)):
        mu_t, var_t = tg.predict(z)
        mu_j, var_j = jg.predict(jnp.asarray(z))
        np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j),
                                   atol=1e-10)
        np.testing.assert_allclose(var_t.numpy(), np.asarray(var_j),
                                   rtol=0, atol=1e-8 * scale)
    back = str(tmp_path / "back.npz")
    tg.save_model(back)
    assert JGP.load_model(back).cfg.kernel == "matern52"


def test_validate_of_a_matern_gp_matches_jax(monkeypatch):
    """GP.validate of a Matérn GP predicts through the vmapped predict (K3
    is SE-only; no K3 call): SMSE, MNLP and RMSE within 1e-8 relative of
    the JAX package's."""
    from gpmpc_tpu_torch.ops import gp_cuda
    monkeypatch.setattr(gp_cuda, "gp_predict_batch", None)
    rng = np.random.default_rng(6)
    x = rng.uniform(-2, 2, (30, 3))
    y = np.stack([np.abs(x[:, 0]), np.sin(x[:, 1] * x[:, 2])], axis=1)
    hyp = dict(log_ell=np.zeros((2, 3)), log_sf2=np.zeros(2),
               log_sn2=np.full(2, -4.0))
    jg = JGP(jnp.asarray(x), jnp.asarray(y), kernel="matern32",
             hyper=jcore.GPHypers(*map(jnp.asarray, hyp.values()),
                                  mean_w=jnp.zeros((2, 0))))
    tg = gp_from_numpy(x, y, **hyp, kernel="matern32", device="cpu",
                       dtype=torch.float64)
    xt = rng.uniform(-2, 2, (25, 3))
    yt = np.stack([np.abs(xt[:, 0]), np.sin(xt[:, 1] * xt[:, 2])], axis=1)
    for g, r in zip(tg.validate(xt, yt, verbose=False),
                    jg.validate(jnp.asarray(xt), yt, verbose=False)):
        np.testing.assert_allclose(g, np.asarray(r), rtol=1e-8)


def test_online_condition_on_a_matern_posterior_matches_jax():
    """Six inserts into a 15-point Matérn-3/2 posterior of capacity 24,
    both packages started from the JAX package's posterior: inv_k and
    alpha within 1e-8 of their scale (the bordered update's rounding, as
    for SE in tests/test_torch_parallel.py) and the conditioned
    predictions within 1e-8 relative."""
    rng = np.random.default_rng(9)
    d, ny = 3, 2
    x = rng.uniform(-2, 2, (15, d))
    y = np.stack([np.sin(x @ np.ones(d)), np.cos(x @ np.ones(d))], axis=1)
    hyper = jcore.GPHypers(log_ell=jnp.zeros((ny, d)), log_sf2=jnp.zeros(ny),
                           log_sn2=jnp.full(ny, -4.0),
                           mean_w=jnp.zeros((ny, 0)))
    jg = JGP(x, y, hyper=hyper, kernel="matern32",
             optimizer_opts=dict(min_noise=0.0, jitter=0.0))
    jpost, jnorm = jonline.from_gp(jg, capacity=24)
    tpost, norm = online_posterior_from_numpy(
        [np.asarray(leaf) for leaf in jpost],
        [np.asarray(s) for s in jnorm], device="cpu")
    for _ in range(6):
        z = rng.uniform(-2, 2, d)
        yv = np.array([np.sin(z.sum()), np.cos(z.sum())])
        jpost = jonline.condition(jpost, jnorm, jnp.asarray(z),
                                  jnp.asarray(yv), kernel="matern32")
        tpost = online_gp.condition(tpost, norm, torch.tensor(z),
                                    torch.tensor(yv), kernel="matern32")
        assert int(tpost.count) == int(jpost.count)
    assert int(tpost.count) == 21
    for leaf in ("inv_k", "alpha"):
        r = np.asarray(getattr(jpost, leaf))
        np.testing.assert_allclose(getattr(tpost, leaf).numpy(), r, rtol=0,
                                   atol=1e-8 * np.abs(r).max())
    for zq in rng.standard_normal((4, d)):
        mu_t, var_t = online_gp.predict(tpost, norm, torch.tensor(zq),
                                        kernel="matern32")
        mu_j, var_j = jonline.predict(jpost, jnorm, jnp.asarray(zq),
                                      kernel="matern32")
        np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j),
                                   rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(var_t.numpy(), np.asarray(var_j),
                                   rtol=1e-8, atol=1e-12)


def test_matern_gp_on_the_cpu_launches_nothing():
    """A Matérn GP fitted and used on CPU tensors runs the plain versions
    only: no launch is counted."""
    before = dict(ck.LAUNCHES)
    x, y = (v[:20, :2] for v in _fixture_normalized())
    g = GP(x, y, kernel="matern52", multistart=1, max_iters=5, device="cpu",
           dtype=torch.float64)
    g.predict(x[0], cov=0.01 * np.eye(2))
    assert ck.LAUNCHES == before
