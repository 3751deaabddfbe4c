"""Port parity for UT and GH propagation (``models/propagate.py``): each
scheme against the JAX package's on the same numpy-seeded GP and input
Gaussian, on SE and Matérn-5/2 posteriors, at Sigma_z = 0 and at a full
Sigma_z; the rules' nodes and weights bitwise; the K3 route of the sigma
points' predictions against the vmapped ``predict`` route; the Jacobi PSD
floor against numpy's eigh; f32 cases."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gpmpc_tpu import GP as JGP
from gpmpc_tpu.models import gp_core as jcore
from gpmpc_tpu.models import propagate as jprop
from gpmpc_tpu_torch.models import gp_core, propagate
from gpmpc_tpu_torch.models.convert import FIXTURE, gp_from_numpy
from gpmpc_tpu_torch.ops import gp_cuda

NY, N = 3, 30


def _pair(kernel, d, seed, dtype=np.float64):
    """One GP in both packages: N points in [-2, 2]^d, three smooth
    targets, log hypers from ``seed``; f64 unless ``dtype`` says f32."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, (N, d))
    y = np.stack([np.sin(x[:, 0]) + x[:, 1], np.cos(x[:, 2]) * x[:, 3],
                  x[:, 0] * x[:, -1]], axis=1)
    hyp = dict(log_ell=0.3 * rng.standard_normal((NY, d)),
               log_sf2=0.2 * rng.standard_normal(NY),
               log_sn2=np.full(NY, -4.0))
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    jg = JGP(jnp.asarray(x, jdt), jnp.asarray(y, jdt), kernel=kernel,
             hyper=jcore.GPHypers(*(jnp.asarray(v, jdt) for v in
                                    hyp.values()),
                                  mean_w=jnp.zeros((NY, 0), jdt)))
    tg = gp_from_numpy(x, y, **hyp, kernel=kernel, device="cpu",
                       dtype=torch.float64 if dtype == np.float64
                       else torch.float32)
    return jg, tg


def _gaussian(d, seed, full):
    rng = np.random.default_rng(100 + seed)
    mu = rng.uniform(-1, 1, d)
    a = 0.3 * rng.standard_normal((d, d))
    return mu, (a @ a.T if full else np.zeros((d, d)))


def _run(jg, tg, method, kw, mu, cov):
    jr = getattr(jprop, f"propagate_{method}")(
        jg.post, jg.norm, jg.cfg, jnp.asarray(mu, jg.X_raw.dtype),
        jnp.asarray(cov, jg.X_raw.dtype), **kw)
    tr = getattr(propagate, f"propagate_{method}")(
        tg.post, tg.norm, tg.cfg, torch.tensor(mu, dtype=tg.dtype),
        torch.tensor(cov, dtype=tg.dtype), **kw)
    return [np.asarray(r) for r in jr], [t.numpy() for t in tr]


#: (scheme, its keyword arguments, D): UT; GH on the tensor grid at
#: orders 2 and 3; cubature5 at D = 8 (negative axial weights, so the PSD
#: floor); 'auto' at D = 8 (3^8 > 1000 points: cubature5)
SCHEMES = [("ut", {}, 6), ("gh", dict(order=2, grid="tensor"), 6),
           ("gh", dict(order=3), 6), ("gh", dict(grid="cubature5"), 8),
           ("gh", dict(grid="auto"), 8)]


@pytest.mark.parametrize("full", [False, True], ids=["cov0", "full_cov"])
@pytest.mark.parametrize("kernel", ["se", "matern52"])
@pytest.mark.parametrize("method,kw,d", SCHEMES,
                         ids=["ut", "gh2", "gh3", "cubature5", "auto_d8"])
def test_propagate_matches_jax(method, kw, d, kernel, full):
    """mu_y, Sigma_y and C within 1e-10 of their largest entries.  At
    Sigma_z = 0 the sigma points sit 1e-6 apart (the root's jitter floor),
    so C, ~1e-13, is the rounding of mus - mu (a cancellation to 1e-6 of
    mus): there it is held within 1e-8 of its largest entry (measured on a
    CPU: up to 5.3e-10)."""
    jg, tg = _pair(kernel, d, seed=d)
    mu, cov = _gaussian(d, d, full)
    ref, got = _run(jg, tg, method, kw, mu, cov)
    for k, (r, g) in enumerate(zip(ref, got)):
        tol = 1e-10 if (full or k < 2) else 1e-8
        np.testing.assert_allclose(g, r, rtol=0, atol=tol * np.abs(r).max())
    assert np.linalg.eigvalsh(got[1]).min() >= -1e-12 * np.abs(got[1]).max()


def test_gh_auto_keeps_the_tensor_grid_up_to_1000_points():
    """'auto' at D = 6 (3^6 = 729) is the tensor grid, bitwise the same as
    grid='tensor'; at D = 8 it is cubature5, bitwise."""
    jg, tg = _pair("se", 6, seed=1)
    mu, cov = (torch.tensor(v) for v in _gaussian(6, 1, True))
    a = propagate.propagate_gh(tg.post, tg.norm, tg.cfg, mu, cov)
    b = propagate.propagate_gh(tg.post, tg.norm, tg.cfg, mu, cov,
                               grid="tensor")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    jg, tg = _pair("se", 8, seed=2)
    mu, cov = (torch.tensor(v) for v in _gaussian(8, 2, True))
    a = propagate.propagate_gh(tg.post, tg.norm, tg.cfg, mu, cov)
    b = propagate.propagate_gh(tg.post, tg.norm, tg.cfg, mu, cov,
                               grid="cubature5")
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_gh_point_cap_and_grid_errors():
    """The tensor grid's 20000-point cap raises in both packages, with the
    same message, for an explicit tensor grid and for 'auto' at an order
    above 3 (which keeps the tensor grid); an unknown grid raises."""
    jg, tg = _pair("se", 10, seed=3)
    mu, cov = _gaussian(10, 3, True)
    for kw in (dict(order=3, grid="tensor"), dict(order=4, grid="auto")):
        with pytest.raises(ValueError, match="cap 20000") as tex:
            _run(jg, tg, "gh", kw, mu, cov)
        with pytest.raises(ValueError, match="cap 20000") as jex:
            jprop.propagate_gh(jg.post, jg.norm, jg.cfg, jnp.asarray(mu),
                               jnp.asarray(cov), **kw)
        assert str(tex.value) == str(jex.value)
    with pytest.raises(ValueError, match="gh_grid"):
        propagate.propagate_gh(tg.post, tg.norm, tg.cfg, torch.tensor(mu),
                               torch.tensor(cov), grid="sparse")


@pytest.mark.parametrize("d,order", [(1, 5), (4, 2), (6, 3), (3, 7)])
def test_tensor_rule_is_jax_bitwise(d, order):
    xi, w = propagate._tensor_gh_rule(d, order)
    jxi, jw = jprop._tensor_gh_rule(d, order)
    np.testing.assert_array_equal(xi, jxi)
    np.testing.assert_array_equal(w, jw)


@pytest.mark.parametrize("d", [2, 4, 6, 8, 12])
def test_cubature5_rule_is_jax_bitwise(d):
    xi, w = propagate._cubature5_rule(d)
    jxi, jw = jprop._cubature5_rule(d)
    np.testing.assert_array_equal(xi, jxi)
    np.testing.assert_array_equal(w, jw)
    assert xi.shape == (2 * d * d + 1, d)


def _counted_k3(monkeypatch):
    calls = []
    inner = gp_cuda.gp_predict_batch

    def counted(*args):
        calls.append(args[0].shape)
        return inner(*args)

    monkeypatch.setattr(gp_cuda, "gp_predict_batch", counted)
    return calls


@pytest.mark.parametrize("method,kw", [("ut", {}), ("gh", dict(order=3))])
def test_sigma_points_go_through_k3_and_match_vmapped_predict(
        method, kw, monkeypatch):
    """An SE posterior with a Cholesky factor sends all sigma points and
    dims through ``gp_core.predict_batch`` (K3's wrapper, once per
    propagation); its predictions agree with the vmapped ``predict`` route
    within 1e-12 (both take the variance as sf2 - ||L^-1 k*||^2), and so
    does the propagation."""
    calls = _counted_k3(monkeypatch)
    _, tg = _pair("se", 6, seed=4)
    mu, cov = (torch.tensor(v) for v in _gaussian(6, 4, True))
    got = getattr(propagate, f"propagate_{method}")(tg.post, tg.norm,
                                                    tg.cfg, mu, cov, **kw)
    n_pts = 13 if method == "ut" else 729
    assert calls == [(n_pts, 6)]
    z = torch.tensor(np.random.default_rng(5).uniform(-2, 2, (n_pts, 6)))
    mu_b, var_b = gp_core.predict_batch(tg.post, z, tg.cfg)
    mu_v, var_v = torch.func.vmap(
        lambda zz: gp_core.predict(tg.post, zz, tg.cfg))(z)
    np.testing.assert_allclose(mu_b.numpy(), mu_v.numpy(), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(var_b.numpy(), var_v.numpy(), rtol=0,
                               atol=1e-12)

    def vmapped(post, zz, cfg):
        return torch.func.vmap(lambda q: gp_core.predict(post, q, cfg))(zz)

    monkeypatch.setattr(gp_core, "predict_batch", vmapped)
    ref = getattr(propagate, f"propagate_{method}")(tg.post, tg.norm,
                                                    tg.cfg, mu, cov, **kw)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0,
                                   atol=1e-12 * float(r.abs().max()))


def test_matern_and_explicit_inverse_posteriors_take_vmapped_predict(
        monkeypatch):
    """K3 computes SE-ARD only: a Matérn posterior predicts its sigma
    points through the vmapped ``predict``, with no K3 call.  An SE
    ExplicitInversePosterior (the online GP's) went the same way until K3
    got its vmap rule; it now takes K3 as well (one
    call, its variance sf2 - k* K^-1 k*'), so the lanes of
    ``MPC.solve_mc`` with per-lane online posteriors are one launch."""
    from gpmpc_tpu_torch.parallel import online_gp
    calls = _counted_k3(monkeypatch)
    _, tm = _pair("matern52", 6, seed=6)
    _, ts = _pair("se", 6, seed=6)
    post = online_gp.as_gp_posterior(online_gp.from_gp(ts, 40)[0])
    mu, cov = (torch.tensor(v) for v in _gaussian(6, 6, True))
    propagate.propagate_ut(tm.post, tm.norm, tm.cfg, mu, cov)
    assert calls == []
    out = propagate.propagate_ut(post, ts.norm, ts.cfg, mu, cov)
    assert calls == [(13, 6)]
    ref = propagate.propagate_ut(ts.post, ts.norm, ts.cfg, mu, cov)
    assert calls == [(13, 6)] * 2
    # the padded explicit-inverse posterior predicts what the factor does
    for g, r in zip(out, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0,
                                   atol=1e-9 * float(r.abs().max()))


@pytest.mark.parametrize("n", [4, 6, 8])
def test_psd_floor_matches_eigh(n):
    """The Jacobi floor V max(L, 0) V' against numpy's eigh on symmetric
    matrices with negative eigenvalues, one of them graded over eight
    decades: within 1e-12 of the largest entry, and PSD."""
    rng = np.random.default_rng(n)
    for k in range(6):
        a = rng.standard_normal((n, n))
        if k % 2:
            a = a * np.logspace(-8, 0, n)[:, None]
        a = 0.5 * (a + a.T)
        w, v = np.linalg.eigh(a)
        assert w.min() < 0.0
        ref = (v * np.maximum(w, 0.0)) @ v.T
        got = propagate.psd_floor(torch.tensor(a)).numpy()
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-12 * np.abs(a).max())
        assert np.linalg.eigvalsh(got).min() >= -1e-12 * np.abs(a).max()


@pytest.mark.parametrize("method,kw,d", [("ut", {}, 6),
                                         ("gh", dict(order=3), 6),
                                         ("gh", dict(grid="cubature5"), 8)])
def test_f32_propagation_matches_jax_f32(method, kw, d):
    """f32 in both packages on the same inputs, at the f32 kernel tests'
    tolerances (tests/test_pallas.py: k* 2e-5, mu 2e-4): mu_y within 2e-4,
    Sigma_y and C within 2e-4 of their largest entries."""
    jg, tg = _pair("se", d, seed=7, dtype=np.float32)
    mu, cov = _gaussian(d, 7, True)
    ref, got = _run(jg, tg, method, kw, mu.astype(np.float32),
                    cov.astype(np.float32))
    assert all(g.dtype == np.float32 for g in got)
    np.testing.assert_allclose(got[0], ref[0], rtol=2e-4, atol=2e-4)
    for r, g in zip(ref[1:], got[1:]):
        np.testing.assert_allclose(g, r, rtol=0, atol=2e-4 * np.abs(r).max())


def test_gp_surface_binds_the_gh_knobs():
    """``GP(gh_order=, gh_grid=)``'s moment map is propagate_gh with those
    knobs, as the JAX GP binds them; a bad grid raises in both."""
    jg, tg = _pair("se", 6, seed=8)
    for g in (jg, tg):
        g.gh_order, g.gh_grid = 2, "tensor"
        g.set_method("GH")
    mu, cov = _gaussian(6, 8, True)
    jm, jc = jg.predict(mu, cov=cov)
    tm, tc = tg.predict(mu, cov=cov)
    ref = propagate.propagate_gh(tg.post, tg.norm, tg.cfg, torch.tensor(mu),
                                 torch.tensor(cov), order=2, grid="tensor")
    assert torch.equal(tc, ref[1])
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                               atol=1e-10 * np.abs(np.asarray(jc)).max())
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-10)
    x = np.zeros((4, 2))
    for make in (lambda: JGP(x, x[:, :1], train=False, gh_grid="x"),
                 lambda: gp_from_numpy(x, x[:, :1], np.zeros((1, 2)),
                                       np.zeros(1), np.zeros(1),
                                       gh_grid="x", device="cpu")):
        with pytest.raises(ValueError, match="gh_grid"):
            make()


def _main_path_stage_inputs(dtype):
    """The UT stage inputs (z, Sigma_z) and stage covariances along the
    main path's cold-start rollout (the fixture GP, Nt=20, chance
    tightening, LQR feedback) in the port at ``dtype``, on the CPU."""
    from benchmarks.bench_spec import (DT, MODEL_R, NT, Q_W, R_W, ULB, UUB,
                                       X0, XLB, XSP, XUB)
    from gpmpc_tpu_torch import MPC, Model
    from gpmpc_tpu_torch.models.convert import gp_from_fixture
    from gpmpc_tpu_torch.systems import four_tank_ode

    m = Model(Nx=4, Nu=2, ode=four_tank_ode, dt=DT, R=MODEL_R,
              clip_negative=True, integrator_substeps=10, device="cpu",
              dtype=dtype)
    g = gp_from_fixture(device="cpu", dtype=dtype, gp_method="UT",
                        optimizer_opts=dict(jitter=1e-5, min_noise=1e-4))
    mpc = MPC(horizon=NT * DT, model=m, gp=g, gp_method="UT", Q=Q_W, R=R_W,
              ulb=ULB, uub=UUB, xlb=XLB, xub=XUB, percentile=0.95,
              feedback=True, cov_updates=1, op_x=XSP,
              op_u=np.array([3.0, 3.0]), device="cpu")
    calls, inner = [], mpc._propagator

    def prop(post, norm, cfg, z, sigma_z):
        calls.append((z.numpy(), sigma_z.numpy()))
        return inner(post, norm, cfg, z, sigma_z)

    mpc._propagator = prop
    warm = mpc._init_warm(torch.tensor(X0, dtype=dtype),
                          mpc._ref_window(XSP))
    sigmas = mpc.propagate_covariances(warm.x, warm.u,
                                       torch.zeros((4, 4), dtype=dtype),
                                       mpc.consts)
    return calls, sigmas.double().numpy()


def test_f32_sigma_point_root_on_a_singular_input_covariance():
    """ROADMAP §3, "f32 sigma-point root": with feedback the input
    covariance [S, -S K'; -K S, K S K'] is singular (du = -K dx), and in
    f32 its rounding puts eigenvalues below the JAX package's 1e-8 root
    jitter.  Along the main path's cold-start rollout the JAX package's
    f32 UT then divides by a ~1e-15 pivot at some stage (Sigma_y over 100x
    the f64 one; measured on a CPU: 19.1 at stage 10, where the f64 stage
    covariances stay below 0.02); the
    port's root jitter of 64 ulps of the largest input variance keeps its
    f32 stage covariances within 2e-2 of its f64 ones, which the tests
    above hold against JAX x64."""
    calls32, sig32 = _main_path_stage_inputs(torch.float32)
    _, sig64 = _main_path_stage_inputs(torch.float64)
    for t in range(1, sig64.shape[0]):
        np.testing.assert_allclose(sig32[t], sig64[t], rtol=0,
                                   atol=2e-2 * np.abs(sig64[t]).max())
    f = np.load(FIXTURE)
    jg = JGP(jnp.asarray(f["tank_X"], jnp.float32),
             jnp.asarray(f["tank_Y"], jnp.float32),
             hyper=jcore.GPHypers(*(jnp.asarray(f[f"tank_log_{k}"],
                                                jnp.float32)
                                    for k in ("ell", "sf2", "sn2")),
                                  mean_w=jnp.zeros((4, 0), jnp.float32)),
             optimizer_opts=dict(jitter=1e-5, min_noise=1e-4))
    worst = max(float(np.abs(np.asarray(jprop.propagate_ut(
        jg.post, jg.norm, jg.cfg, jnp.asarray(z), jnp.asarray(s))[1])).max())
        / np.abs(sig64[t + 1]).max() for t, (z, s) in enumerate(calls32))
    assert worst > 100.0, worst
