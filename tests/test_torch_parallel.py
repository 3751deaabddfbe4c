"""Port parity for slice D, the batched closed-loop study (bench config 5):
the online posterior (``parallel/online_gp.py``) and ``BatchedStudy``
(``parallel/batched.py``), each held against the JAX package at f64 on the
same numpy inputs, the study's process noise passed to both as one
explicit ``noise_ws``; and the batch mechanism: one vmapped control step
per rollout batch, with K1's and K2's custom operators batched by their
vmap rules and no functorch per-example fallback."""

import warnings

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from torch.func import vmap

from benchmarks.bench_spec import DT, MODEL_R
from gpmpc_tpu import GP as JGP, Model as JModel
from gpmpc_tpu.models.gp_core import GPHypers as JHypers
from gpmpc_tpu.parallel import batched as jbatched, online_gp as jonline
from gpmpc_tpu.systems import four_tank_ode as jtank_ode
from gpmpc_tpu_torch import Model
from gpmpc_tpu_torch.models import gp_core
from gpmpc_tpu_torch.models.convert import (FIXTURE, gp_from_fixture,
                                            online_posterior_from_numpy)
from gpmpc_tpu_torch.ops import cuda_kernels as ck
from gpmpc_tpu_torch.parallel import (BatchedStudy, load_study, online_gp,
                                      save_study)
from gpmpc_tpu_torch.solvers import al_sqp
from gpmpc_tpu_torch.systems import four_tank_ode

F64 = torch.float64
OPTS = dict(jitter=1e-5, min_noise=1e-4)
#: the bench study's solver budget (bench.py:428)
BUDGET = dict(al_iters=1, max_iters=3, ls_steps=4)
STUDY_KW = dict(Q=np.diag([10.0, 10.0, 0.1, 0.1]), R=0.01 * np.eye(2),
                ulb=[0.0, 0.0], uub=[8.0, 8.0], solver_opts=BUDGET)
XSP = np.array([12.4, 12.7, 1.8, 1.4])


def _jax_gp(n, dtype=jnp.float64):
    f = np.load(FIXTURE)
    hyper = JHypers(*(jnp.asarray(f[f"tank_{k}"], dtype)
                      for k in ("log_ell", "log_sf2", "log_sn2")),
                    mean_w=jnp.zeros((4, 0), dtype))
    return JGP(jnp.asarray(f["tank_X"][:n], dtype),
               jnp.asarray(f["tank_Y"][:n], dtype), mean_func="zero",
               hyper=hyper, optimizer_opts=OPTS)


def _gp_pair(n):
    """The fixture GP cut to its first ``n`` points, on both sides (f64)."""
    return _jax_gp(n), gp_from_fixture(n=n, device="cpu", dtype=F64,
                                       optimizer_opts=OPTS)


def _np(t):
    return t.detach().cpu().double().numpy() if torch.is_tensor(t) \
        else np.asarray(t, np.float64)


def _assert_post_close(got, ref, tol=1e-10):
    """Posterior leaves within ``tol`` of each leaf's scale (inv_k holds
    entries of ~1e4 at the fixture's noise floor), count exactly."""
    for name, g, r in zip(got._fields, got, ref):
        g, r = _np(g), _np(r)
        assert g.shape == r.shape, (name, g.shape, r.shape)
        scale = max(1.0, float(np.abs(r).max())) if r.size else 1.0
        np.testing.assert_allclose(g, r, rtol=0, atol=tol * scale,
                                   err_msg=name)


def _assert_predictions_close(post, norm, jpost, jnorm, queries, tol=1e-8):
    """Predictive means within ``tol`` relative, variances within ``tol``
    of the prior variance sf2 y_std^2 (the variance is a cancellation of
    terms of that size)."""
    prior = _np(torch.exp(post.log_sf2) * norm.y_std ** 2)
    for q in queries:
        mu, var = online_gp.predict(post, norm, torch.tensor(q))
        mu_j, var_j = jonline.predict(jpost, jnorm, jnp.asarray(q))
        np.testing.assert_allclose(_np(mu), _np(mu_j), rtol=tol)
        gap = np.abs(_np(var) - _np(var_j))
        assert np.all(gap <= tol * prior), (gap / prior, tol)


def _queries(n, seed):
    """Raw inputs on and around the fixture's data."""
    f = np.load(FIXTURE)
    x = np.asarray(f["tank_X"], np.float64)
    rng = np.random.default_rng(seed)
    pick = x[rng.integers(0, x.shape[0], n)]
    return pick + rng.normal(0.0, 0.3, pick.shape) * x.std(axis=0)


def test_from_gp_pads_like_jax_and_refuses():
    jgp, tgp = _gp_pair(20)
    jpost, _ = jonline.from_gp(jgp, 28)
    tpost, norm = online_gp.from_gp(tgp, 28)
    _assert_post_close(tpost, jpost)
    assert tpost.count.dtype == torch.int32 and int(tpost.count) == 20
    assert norm is tgp.norm
    with pytest.raises(ValueError, match="capacity 19 < training size 20"):
        online_gp.from_gp(tgp, 19)

    class Sparse:
        inducing = 8
    with pytest.raises(ValueError, match="non-sparse"):
        online_gp.from_gp(Sparse(), 28)


def test_padded_predict_equals_unpadded():
    """The sentinel-padded posterior predicts what the unpadded one does,
    and what the JAX package's online predict does, within 1e-10 (f64)."""
    jgp, tgp = _gp_pair(20)
    jpost, jnorm = jonline.from_gp(jgp, 32)
    tpost, norm = online_gp.from_gp(tgp, 32)
    for z in _queries(6, 1):
        zt = torch.tensor(z, dtype=F64)
        mu, var = online_gp.predict(tpost, norm, zt)
        mu_j, var_j = jonline.predict(jpost, jnorm, jnp.asarray(z))
        zn = (zt - norm.z_mean) / norm.z_std
        mu_u, var_u = gp_core.predict(tgp.post, zn, tgp.cfg)
        mu_u = norm.y_mean + norm.y_std * mu_u
        var_u = norm.y_std ** 2 * var_u
        for got, ref in ((mu, mu_j), (var, var_j), (mu, mu_u), (var, var_u)):
            np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-10,
                                       atol=1e-10)
        np.testing.assert_allclose(
            _np(online_gp.predict_mean(tpost, norm, zt)), _np(mu), rtol=0,
            atol=0)
    # the explicit-inverse view predicts as the online predict does
    view = online_gp.as_gp_posterior(tpost)
    assert view.chol is None
    zn = (torch.tensor(_queries(1, 2)[0]) - norm.z_mean) / norm.z_std
    mu_v, var_v = gp_core.predict(view, zn, tgp.cfg)
    mu_o, var_o = online_gp.predict(tpost, norm, norm.z_mean
                                    + norm.z_std * zn)
    np.testing.assert_allclose(_np(norm.y_std ** 2 * var_v), _np(var_o),
                               rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("policy", ["saturate", "fifo"])
def test_condition_matches_jax(policy):
    """18 inserts into a 12-point posterior of capacity 16: the buffer
    fills, then saturates (drops) or evicts its oldest points (fifo, count
    wrapping into [16, 32)), both packages started from the JAX package's
    posterior (``from_gp``'s own parity is the test above), f64.  Each
    step's count is equal, x and y within 1e-12, inv_k and alpha within
    1e-8 of their scale and the conditioned predictions within 1e-8
    relative.  Not 1e-10: the bordered update divides by s >= 3 sn2, and
    at these inserts the JAX package's own jitted and eager ``condition``
    differ by 1.3e-9 (relative inv_k) on the same inputs, as the port does
    from it.  A duplicate of the last accepted point fails the novelty
    gate and leaves the posterior untouched, bit for bit."""
    jgp, _ = _gp_pair(12)
    jpost, jnorm = jonline.from_gp(jgp, 16)
    tpost, norm = online_posterior_from_numpy(
        [np.asarray(leaf) for leaf in jpost],
        [np.asarray(s) for s in jnorm], device="cpu")
    zs = _queries(18, 3)
    rng = np.random.default_rng(4)
    f = np.load(FIXTURE)
    ys = f["tank_Y"][:18] + rng.normal(0.0, 0.05, (18, 4))
    counts = []
    jcondition = jax.jit(lambda p, z, y: jonline.condition(
        p, jnorm, z, y, policy=policy))
    for z, y in zip(zs, ys):
        jpost = jcondition(jpost, jnp.asarray(z), jnp.asarray(y))
        tpost = online_gp.condition(tpost, norm, torch.tensor(z),
                                    torch.tensor(y), policy=policy)
        assert int(tpost.count) == int(jpost.count)
        _assert_post_close(tpost._replace(inv_k=jpost.inv_k,
                                          alpha=jpost.alpha), jpost,
                           tol=1e-12)
        _assert_post_close(tpost, jpost, tol=1e-8)
        counts.append(int(tpost.count))
    # saturate stops at capacity; fifo passed it and wrapped into [16, 32)
    assert counts[-1] == 16 if policy == "saturate" else \
        16 < counts[-1] < 32, counts
    _assert_predictions_close(tpost, norm, jpost, jnorm, _queries(4, 9))
    # a duplicate of the last accepted insert: rejected by the gate, the
    # posterior untouched
    last = max(i for i in range(18) if i == 0 or counts[i] != counts[i - 1])
    dup = online_gp.condition(tpost, norm, torch.tensor(zs[last]),
                              torch.tensor(ys[last]), policy=policy)
    jdup = jcondition(jpost, jnp.asarray(zs[last]), jnp.asarray(ys[last]))
    assert int(dup.count) == int(jdup.count) == counts[-1]
    for a, b in zip(dup, tpost):
        assert torch.equal(a, b)


def _study_pair(n=30, b=3, steps=4, nt=4, capacity=40, **kw):
    jgp, tgp = _gp_pair(n)
    jm = JModel(Nx=4, Nu=2, ode=lambda x, u: jtank_ode(x, u), dt=DT,
                R=MODEL_R, clip_negative=True, dtype=jnp.float64,
                integrator_substeps=10)
    tm = Model(Nx=4, Nu=2, ode=four_tank_ode, dt=DT, R=MODEL_R,
               clip_negative=True, dtype=F64, integrator_substeps=10,
               device="cpu")
    opts = dict(STUDY_KW, horizon=nt * DT, capacity=capacity, **kw)
    rng = np.random.default_rng(0)
    x0s = np.array([8.0, 9.0, 1.0, 1.0]) + 0.5 * rng.uniform(size=(b, 4))
    noise = 0.03 * rng.standard_normal((b, steps, 4))
    return (jbatched.BatchedStudy(jm, jgp, **opts),
            BatchedStudy(tm, tgp, **opts), x0s, noise)


@pytest.fixture(scope="module")
def study():
    """The small study on both sides, built once: (JAX study, port study,
    x0s (3, 4), noise (3, 4, 4))."""
    return _study_pair()


def _jax_run(js, x0s, noise, steps, init_post=None):
    post = js.post0 if init_post is None else init_post
    return js._run_jit(jnp.asarray(x0s), jnp.asarray(XSP),
                       jnp.asarray(noise), post, js.consts, n_steps=steps,
                       batched_post=init_post is not None)


def _assert_study_close(got, ref, tol=1e-6):
    for k in ("x_traj", "u_traj", "cost", "obj", "gp_points", "mean_cost"):
        np.testing.assert_allclose(_np(getattr(got, k)),
                                   _np(getattr(ref, k)), rtol=0, atol=tol,
                                   err_msg=k)


def test_study_matches_jax(study):
    """B=3 rollouts of the bench study's configuration at a small size (the
    fixture GP's first 30 points, capacity 40, Nt=4, 4 steps) against the
    JAX package's ``_run_jit`` on the same noise: trajectories, costs,
    objectives and gp_points within 1e-6 (measured on a CPU: 5e-9)."""
    js, ts, x0s, noise = study
    ref = _jax_run(js, x0s, noise, 4)
    got = ts.run(x0s, XSP, 4, noise_ws=noise)
    _assert_study_close(got, ref)
    assert got.x_traj.shape == (3, 5, 4) and got.post.inv_k.shape == (
        3, 4, 40, 40)
    assert bool(torch.all(got.gp_points > 30))


def test_vmapped_step_equals_unbatched_step(study):
    """One vmapped control step of B=3 rollouts equals the same step of
    each rollout alone: the batch changes no number (f64, 1e-12)."""
    _, ts, x0s, noise = study
    x0s = torch.tensor(x0s)
    w = torch.tensor(noise[:, 0])
    xsp = torch.tensor(XSP)
    warm = vmap(ts._init_warm, in_dims=(0, None, None, None))(
        x0s, ts.post0, xsp, ts.consts)
    out = vmap(ts._step, in_dims=(0, 0, None, 0, None, None))(
        x0s, warm, ts.post0, w, xsp, ts.consts)
    for i in range(3):
        warm_i = al_sqp.SolverState(*(leaf[i] for leaf in warm))
        one = ts._step(x0s[i], warm_i, ts.post0, w[i], xsp, ts.consts)
        for got, ref in zip((out[0], out[3], out[4]), (one[0], one[3],
                                                       one[4])):
            np.testing.assert_allclose(_np(got[i]), _np(ref), rtol=1e-12,
                                       atol=1e-12)
        _assert_post_close(type(one[2])(*(leaf[i] for leaf in out[2])),
                           one[2], tol=1e-12)


def test_study_step_takes_no_vmap_fallback():
    """One f32 study step with the fused KKT sweep (K1) and the fused plant
    (K2), their plain versions here, under functorch's per-example
    fallback warning turned into an error: every op of the step has a
    batching rule (a fallback would loop over the rollouts in Python)."""
    tgp32 = gp_from_fixture(n=30, device="cpu", optimizer_opts=OPTS)
    tm = Model(Nx=4, Nu=2, ode=four_tank_ode, dt=DT, R=MODEL_R,
               clip_negative=True, integrator_substeps=10,
               fused_integrator=True, device="cpu")
    ts = BatchedStudy(tm, tgp32, horizon=8 * DT, capacity=40,
                      **dict(STUDY_KW,
                             solver_opts=dict(BUDGET, fused_kkt=True)))
    x0s = np.array([8.0, 9.0, 1.0, 1.0]) + 0.5 * np.random.default_rng(
        5).uniform(size=(4, 4))
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message=".*batching rule.*")
            res = ts.run(x0s, XSP, 1, generator=torch.Generator().manual_seed(
                1))
            # the warning does turn into an error here
            with pytest.raises(UserWarning, match="batching rule"):
                vmap(lambda a: torch.histc(a, 4))(torch.rand(2, 5))
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    assert res.x_traj.dtype == torch.float32
    assert bool(torch.all(torch.isfinite(res.x_traj)))


def test_kernel_ops_vmap_rules_batch_once():
    """K1's and K2's custom operators under vmap: one call of the operator
    with the batch in front (one launch on the card), unbatched arguments
    expanded, equal to the plain batched versions (the operators run those
    on CPU tensors)."""
    args = ck.stage_qp_inputs(8, 4, 2, 0, batch=5)
    reg = torch.rand(5, generator=torch.Generator().manual_seed(0))
    calls = []
    orig = ck.riccati_sweep_reference

    def spy(*a):
        calls.append(tuple(a[0].shape))
        return orig(*a)

    ck.riccati_sweep_reference = spy
    try:
        got = vmap(ck.riccati_sweep_op, in_dims=(0,) * 10 + (None, 0))(
            *args[:10], args[10][0], reg)
    finally:
        ck.riccati_sweep_reference = orig
    assert calls == [(5, 8, 4, 4)]
    ref = orig(*args[:10], args[10][0].expand(5, 4), reg)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    x, u = ck.rk4_inputs(7, 0)
    got = vmap(lambda a, b: ck.rk4_substeps_op(a, b, 0, 0.3, 10),
               in_dims=(0, None))(x, u[0])
    ref = ck.rk4_substeps_reference(four_tank_ode, x, u[0].expand(7, 2),
                                    0.3, 10)
    assert torch.equal(got, ref)


def test_jax_checkpoint_loads_and_resumes(tmp_path, study):
    """A study checkpoint the JAX package wrote (``save_study``) loads in
    the port with the same keys and posterior leaves, and the port resumed
    from it follows JAX's resumed run within 1e-6; the port's own
    checkpoint loads back bitwise and in the JAX package.  A 0.3.x
    checkpoint without ``mean_w`` gets it from the template."""
    js, ts, x0s, noise = study
    first = _jax_run(js, x0s, noise[:, :2], 2)
    path = str(tmp_path / "jax_study.npz")
    jbatched.save_study(path, first)
    loaded = load_study(path, ts.post0)
    _assert_post_close(loaded.post, first.post, tol=0.0)
    assert loaded.post.count.dtype == torch.int32
    x_mid = np.asarray(first.x_traj[:, -1])
    ref = _jax_run(js, x_mid, noise[:, 2:3], 1, init_post=first.post)
    got = ts.run(x_mid, XSP, 1, noise_ws=noise[:, 2:3],
                 init_post=loaded.post)
    _assert_study_close(got, ref)

    mine = str(tmp_path / "port_study.npz")
    save_study(mine, got)
    back = load_study(mine, ts.post0)
    for a, b in zip(back, got):
        if isinstance(a, tuple):
            for x, y in zip(a, b):
                assert torch.equal(x, y)
        else:
            assert torch.equal(a, b)
    assert sorted(np.load(mine).files) == sorted(np.load(path).files)
    jback = jbatched.load_study(mine, js.post0)
    _assert_post_close(back.post, jback.post, tol=0.0)

    old = str(tmp_path / "v03.npz")
    z = dict(np.load(path))
    z.pop("post_8")
    z["n_post_leaves"] = 8
    np.savez(old, **z)
    v03 = load_study(old, ts.post0)
    assert tuple(v03.post.mean_w.shape) == (3, 4, 0)


def test_converted_posterior_predicts_like_jax():
    """``convert.online_posterior_from_numpy`` builds the port's posterior
    and normalization from a JAX OnlinePosterior's leaves, bitwise; its
    predictions match JAX's within 1e-8 relative (the conditioned
    variance is a cancellation of terms ~1e3 times larger)."""
    jgp, _ = _gp_pair(20)
    jpost, jnorm = jonline.from_gp(jgp, 24)
    z = _queries(1, 6)[0]
    jpost = jonline.condition(jpost, jnorm, jnp.asarray(z),
                              jnp.asarray(np.load(FIXTURE)["tank_Y"][0]))
    post, norm = online_posterior_from_numpy(
        [np.asarray(leaf) for leaf in jpost],
        [np.asarray(s) for s in jnorm], device="cpu")
    _assert_post_close(post, jpost, tol=0.0)
    _assert_predictions_close(post, norm, jpost, jnorm, _queries(3, 7))


@pytest.mark.parametrize("kw,error,item", [
    pytest.param(dict(solve_precision="default"), NotImplementedError,
                 "Not ported", id="kw0-Not ported"),
    # the mesh is ported (ROADMAP §1 item 6.9; tests/test_torch_
    # distributed.py): anything but a DeviceMesh is refused
    pytest.param(dict(mesh=object()), TypeError, "DeviceMesh",
                 id="kw1-item 6.9"),
    pytest.param(dict(chunk=256), NotImplementedError, "Not ported",
                 id="kw2-Not ported")])
def test_study_options_not_ported_raise(kw, error, item):
    _, tgp = _gp_pair(12)
    tm = Model(Nx=4, Nu=2, ode=four_tank_ode, dt=DT, R=MODEL_R,
               dtype=F64, device="cpu")
    with pytest.raises(error, match=item):
        BatchedStudy(tm, tgp, horizon=4 * DT, **kw)
