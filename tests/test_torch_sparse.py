"""Port parity for sparse variational GPs (``models/sparse.py`` and
``GP(inducing=, optimize_inducing=)``): the k-center inducing set, the
Titsias free energy and its gradient, the VFE posterior and its
predictions, against the JAX package at f64 on the CPU within 1e-8 on the
same numpy inputs; the fits (VFE, the Z-step and the refit) at the
tolerances of ``tests/test_torch_gp_train.py`` (NLL rtol 1e-6, variables
atol 1e-3); save/load across the packages; the sparse posterior in a
closed loop."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from benchmarks.bench_spec import DT, X0, XSP
from gpmpc_tpu import GP as JGP, MPC as JMPC
from gpmpc_tpu.models import gp_core as jcore, sparse as jsparse
from gpmpc_tpu.utils.config import GPConfig as JConfig
from gpmpc_tpu_torch import GP, MPC
from gpmpc_tpu_torch.models import gp_core, sparse
from gpmpc_tpu_torch.models.convert import FIXTURE
from gpmpc_tpu_torch.ops import gp_cuda
from gpmpc_tpu_torch.utils.config import GPConfig

from test_torch_mpc import GP_OPTS, MPC_KW
from test_torch_online_mpc import _models

F64 = torch.float64
CPU = dict(device="cpu", dtype=F64)


def _toy(n=120, seed=3):
    """``tests/test_sparse.py``'s smooth 2-output problem (D = 3)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, (n, 3))
    f = np.stack([np.sin(x[:, 0]) * x[:, 1], np.cos(x[:, 2])], axis=1)
    return x, f + 0.05 * rng.normal(size=(n, 2))


def _fixture():
    f = np.load(FIXTURE)
    x, y = f["tank_X"].astype(np.float64), f["tank_Y"].astype(np.float64)
    return (x - x.mean(0)) / x.std(0), (y - y.mean(0)) / y.std(0)


@pytest.mark.parametrize("m", [1, 7, 32])
def test_select_inducing_matches_jax(m):
    """The greedy k-center indices are JAX's, on the fixture's normalized
    inputs and on the toy set; no duplicates."""
    for x in (_fixture()[0], _toy()[0]):
        got = sparse.select_inducing(torch.tensor(x), m).numpy()
        ref = np.asarray(jsparse.select_inducing(jnp.asarray(x), m))
        np.testing.assert_array_equal(got, ref)
        assert len(np.unique(got)) == m
    with pytest.raises(ValueError, match="inducing count"):
        sparse.select_inducing(torch.tensor(x), 0)


@pytest.mark.parametrize("kernel,mean_func", [("se", "zero"),
                                              ("se", "linear"),
                                              ("matern52", "zero")])
def test_vfe_value_and_gradient_match_jax(kernel, mean_func):
    """The free energy of one output dim and its gradient in every hyper
    (the mean weights included), M = 24 of the fixture's 100 points:
    within 1e-8 relative; the batched form is the per-problem one."""
    x, y = _fixture()
    z = x[np.asarray(jsparse.select_inducing(jnp.asarray(x), 24))]
    rng = np.random.default_rng(5)
    f = {"zero": 0, "linear": 7}[mean_func]
    vals = (0.3 * rng.standard_normal(6), np.float64(0.2),
            np.float64(-4.0), 0.3 * rng.standard_normal(f))
    cfg = dict(GP_OPTS, kernel=kernel)

    def fj(p):
        return jsparse.vfe_nll_single(*p, jnp.asarray(z), jnp.asarray(x),
                                      jnp.asarray(y[:, 1]), JConfig(**cfg),
                                      mean_func)

    vj, gj = jax.value_and_grad(fj)(tuple(map(jnp.asarray, vals)))
    args = [torch.tensor(a, dtype=F64, requires_grad=True) for a in vals]
    vt = sparse.vfe_nll_single(*args, torch.tensor(z), torch.tensor(x),
                               torch.tensor(y[:, 1]), GPConfig(**cfg),
                               mean_func)
    gt = torch.autograd.grad(vt, args, allow_unused=True)
    assert abs(float(vt) - float(vj)) <= 1e-8 * abs(float(vj))
    for g, r in zip(gt, gj):
        g = torch.zeros(np.shape(r), dtype=F64) if g is None else g
        np.testing.assert_allclose(
            g.numpy(), np.asarray(r), rtol=0,
            atol=1e-8 * max(1.0, np.abs(np.asarray(r)).max(initial=0.0)))
    batch = sparse.vfe_nll_batch(
        *(torch.tensor(np.stack([a, a])) for a in vals), torch.tensor(z),
        torch.tensor(x), torch.tensor(y[:, [1, 1]].T), GPConfig(**cfg),
        mean_func)
    np.testing.assert_allclose(batch.detach().numpy(),
                               [float(vt)] * 2, rtol=1e-14)


def test_vfe_bounds_the_exact_nll():
    """The bound property on the port (``tests/test_sparse.py``): F(Z) >=
    the exact NLL for an inducing subset, and F(X) = NLL up to the jitter
    scale."""
    x, y = _toy()
    cfg = GPConfig(multistart=1, max_iters=150)
    h = [torch.tensor(v) for v in (0.2 * np.ones(3), 0.1, -4.5)]
    xt, yt = torch.tensor(x), torch.tensor(y[:, 0])
    w = torch.zeros(0, dtype=F64)
    ex = gp_core.nll_single(*h, w, xt, yt, cfg, "zero")
    z = xt[sparse.select_inducing(xt, 20).long()]
    assert float(sparse.vfe_nll_single(*h, w, z, xt, yt, cfg, "zero")) >= \
        float(ex) - 1e-8
    full = sparse.vfe_nll_single(*h, w, xt, xt, yt, cfg, "zero")
    assert abs(float(full - ex)) < 1e-4 * (1.0 + abs(float(ex)))


def test_sparse_posterior_and_predictions_match_jax():
    """The VFE posterior at the fixture's hypers (M = 32): L_M, beta and
    Lambda within 1e-8 of their scale; the predictive mean and variance
    at 20 points through ``predict`` and through ``predict_points`` (K3's
    plain version; the variance by two triangular solves, JAX's by the
    explicit Lambda) within 1e-8."""
    x, y = _fixture()
    f = np.load(FIXTURE)
    hyp = [np.asarray(f[f"tank_{k}"], np.float64)
           for k in ("log_ell", "log_sf2", "log_sn2")]
    z = x[np.asarray(jsparse.select_inducing(jnp.asarray(x), 32))]
    jcfg, tcfg = JConfig(**GP_OPTS), GPConfig(**GP_OPTS)
    jp = jsparse.sparse_posterior(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(z),
        jcore.GPHypers(*map(jnp.asarray, hyp), jnp.zeros((4, 0))), jcfg)
    tp = sparse.sparse_posterior(
        torch.tensor(x), torch.tensor(y), torch.tensor(z),
        gp_core.GPHypers(*map(torch.tensor, hyp), torch.zeros((4, 0),
                                                              dtype=F64)),
        tcfg)
    assert isinstance(tp, gp_core.SparsePosterior)
    for name in ("chol", "alpha", "inv_k"):
        ref = np.asarray(getattr(jp, name))
        np.testing.assert_allclose(getattr(tp, name).numpy(), ref, rtol=0,
                                   atol=1e-8 * np.abs(ref).max(),
                                   err_msg=name)
    zq = np.random.default_rng(7).uniform(-1.5, 1.5, (20, 6))
    mj, vj = jax.vmap(lambda q: jcore.predict(jp, q, jcfg))(jnp.asarray(zq))
    mt, vt = gp_core.predict_points(tp, torch.tensor(zq), tcfg)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=0, atol=1e-8)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=1e-8)
    m1, v1 = gp_core.predict(tp, torch.tensor(zq[3]), tcfg)
    np.testing.assert_allclose(m1.numpy(), np.asarray(mj[3]), atol=1e-8)
    np.testing.assert_allclose(v1.numpy(), np.asarray(vj[3]), atol=1e-8)


def _gp_pair(x, y, **kw):
    kw = dict(dict(multistart=1, max_iters=60, optimizer_opts=GP_OPTS), **kw)
    return JGP(x, y, **kw), GP(x, y, **CPU, **kw)


def _assert_fit(tg, jg):
    np.testing.assert_allclose(tg.nll.numpy(), np.asarray(jg.nll),
                               rtol=1e-6)
    for k in ("log_ell", "log_sf2", "log_sn2"):
        np.testing.assert_allclose(getattr(tg.hyper, k).numpy(),
                                   np.asarray(getattr(jg.hyper, k)),
                                   atol=1e-3, err_msg=k)


def test_sparse_fit_matches_jax():
    """``GP(X, Y, inducing=16)`` on the fixture's first 60 points (one
    start plus the exact subset fit's, 40 iterations): the bounds within
    rtol 1e-6 and the hypers within 1e-3 of JAX's; its evaluations
    counted by leg; validate's SMSE (one K3 call) within rtol 1e-6 of
    JAX's on the other 40."""
    f = np.load(FIXTURE)
    x, y = f["tank_X"].astype(np.float64), f["tank_Y"].astype(np.float64)
    jg, tg = _gp_pair(x[:60], y[:60], inducing=16, max_iters=40)
    _assert_fit(tg, jg)
    np.testing.assert_array_equal(tg.z_idx.numpy(), np.asarray(jg.z_idx))
    assert set(tg.fit_evals) == {"exact", "vfe"} and tg.n_evals == \
        sum(tg.fit_evals.values())
    calls = []
    inner = gp_cuda.gp_predict_batch

    def counted(*args):
        calls.append(args[0].shape)
        return inner(*args)

    xt, yt = x[60:], y[60:]
    try:
        gp_cuda.gp_predict_batch = counted
        got = tg.validate(xt, yt, verbose=False)
    finally:
        gp_cuda.gp_predict_batch = inner
    assert calls == [(len(xt), 6)]
    for g, r in zip(got, jg.validate(xt, yt, verbose=False)):
        np.testing.assert_allclose(g, np.asarray(r), rtol=1e-6)


def test_optimize_inducing_matches_jax_and_round_trips(tmp_path):
    """``optimize_inducing=True`` (fit, Z-step, warm refit) on the toy
    set at M = 12: the moved inducing set and the refit hypers within
    1e-3, the bounds within rtol 1e-6 of JAX's; the set moved off the
    k-center subset.  Saved by the port, the JAX package and the
    port load the moved set and predict the same (1e-10; a saved model
    carries no optimizer options, so both load the defaults); loaded with
    the training's options the port predicts what it trained; and a JAX
    save loads in the port."""
    x, y = _toy(n=80)
    jg, tg = _gp_pair(x, y, inducing=12, optimize_inducing=True,
                      max_iters=30)
    _assert_fit(tg, jg)
    np.testing.assert_allclose(tg.Zn.numpy(), np.asarray(jg.Zn), atol=1e-3)
    assert set(tg.fit_evals) == {"exact", "vfe", "inducing", "refit"}
    kcenter = tg.Xn[tg.z_idx.long()]
    assert not torch.allclose(tg.Zn, kcenter)
    path = str(tmp_path / "sparse.npz")
    tg.save_model(path)
    back = JGP.load_model(path)
    mine = GP.load_model(path, **CPU)
    same = GP.load_model(path, optimizer_opts=GP_OPTS, **CPU)
    assert back.inducing == mine.inducing == 12
    np.testing.assert_array_equal(np.asarray(back.Zn), tg.Zn.numpy())
    np.testing.assert_array_equal(mine.Zn.numpy(), tg.Zn.numpy())
    for q in np.random.default_rng(2).uniform(-1.5, 1.5, (3, 3)):
        mj, vj = back.predict(jnp.asarray(q))
        mt, vt = mine.predict(q)
        np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=1e-10)
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-10)
        assert torch.equal(same.predict(q)[0], tg.predict(q)[0])
    jpath = str(tmp_path / "sparse_jax.npz")
    jg.save_model(jpath)
    tl = GP.load_model(jpath, **CPU)
    jl = JGP.load_model(jpath)
    np.testing.assert_array_equal(tl.Zn.numpy(), np.asarray(jg.Zn))
    q = np.array([0.4, -0.2, 0.9])
    np.testing.assert_allclose(tl.predict(q)[0].numpy(),
                               np.asarray(jl.predict(jnp.asarray(q))[0]),
                               atol=1e-10)


def test_sparse_guards_and_online_rejection():
    """The JAX package's guards (M in [1, N), ``optimize_inducing`` needs
    ``inducing``), and the online GP refuses a sparse posterior."""
    from gpmpc_tpu_torch.parallel import online_gp
    x, y = _toy(n=40)
    for m in (0, 40):
        with pytest.raises(ValueError, match="inducing"):
            GP(x, y, inducing=m, train=False, **CPU)
    with pytest.raises(ValueError, match="optimize_inducing"):
        GP(x, y, optimize_inducing=True, train=False, **CPU)
    gp = GP(x, y, inducing=8, multistart=1, max_iters=20, **CPU)
    with pytest.raises(ValueError, match="non-sparse"):
        online_gp.from_gp(gp, capacity=64)


def test_sparse_gp_closed_loop_matches_jax():
    """The sparse posterior in the TA controller (tightening and feedback
    on its explicit-inverse variance): M = 12 of the fixture's first 40
    points at the fixture's hypers, three steps at Nt = 5 within 1e-6 of
    JAX's, noise off."""
    f = np.load(FIXTURE)
    x = f["tank_X"][:40].astype(np.float64)
    y = f["tank_Y"][:40].astype(np.float64)
    hyp = [np.asarray(f[f"tank_{k}"], np.float64)
           for k in ("log_ell", "log_sf2", "log_sn2")]
    jm, tm = _models()
    jg = JGP(x, y, inducing=12, optimizer_opts=GP_OPTS,
             hyper=jcore.GPHypers(*map(jnp.asarray, hyp),
                                  jnp.zeros((4, 0))))
    tg = GP(x, y, inducing=12, optimizer_opts=GP_OPTS,
            hyper=gp_core.GPHypers(*hyp, np.zeros((4, 0))), **CPU)
    kw = dict(MPC_KW, horizon=5 * DT, gp_method="TA", discrete_method="gp",
              solver_opts=dict(al_iters=2, max_iters=3),
              init_solver_opts=dict(al_iters=2, max_iters=6))
    jx, ju = JMPC(model=jm, gp=jg, **kw).solve(X0, 3 * DT, XSP, noise=False)
    tx, tu = MPC(model=tm, gp=tg, device="cpu", **kw).solve(X0, 3 * DT, XSP,
                                                            noise=False)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0, atol=1e-6)
