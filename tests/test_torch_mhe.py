"""The moving-horizon estimator and the output-feedback loop of
gpmpc_tpu_torch against gpmpc_tpu's on the same inputs (f64, CPU).

Each JAX test of ``tests/test_mhe.py`` has its counterpart here: the same
numpy-seeded problem goes through both packages, the port is held to the
JAX result (1e-8 on one operation, 1e-6 on a window solved to the
solver's tolerance and on a filtered record), and where the JAX test
checks a property (the RTS smoother, the Kalman filter, the state bounds,
the denoising, the host composition of the output-feedback loop) the port
is held to it too."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gpmpc_tpu import GP as JGP, MHE as JMHE, Model as JModel
from gpmpc_tpu.models.gp_core import GPHypers as JHypers
from gpmpc_tpu.systems import four_tank_ode as jtank
from gpmpc_tpu_torch import MHE, MPC, Model, simulate_output_feedback
from gpmpc_tpu_torch.models.convert import gp_from_numpy
from gpmpc_tpu_torch.systems import four_tank_ode
from test_mhe import _linear_model, _rts_smoother, _simulate

F64 = torch.float64
AC = np.array([[-0.6, 0.3, 0.0], [0.0, -0.4, 0.2], [0.1, 0.0, -0.5]])
BC = np.array([[0.5], [0.0], [0.3]])
C2 = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])


def _port_linear_model():
    """The port's twin of test_mhe._linear_model's system."""
    a, b = torch.tensor(AC), torch.tensor(BC)
    return Model(Nx=3, Nu=1, ode=lambda x, u: a @ x + b @ u, dt=0.1,
                 R=np.eye(3) * 1e-4, dtype=F64, device="cpu")


def _maps(c):
    """The measurement map x -> c x in both packages."""
    return (lambda x: jnp.asarray(c, x.dtype) @ x,
            lambda x: torch.as_tensor(c, dtype=x.dtype) @ x)


def _linear_pair(c, **kw):
    """The JAX and the port MHE on the linear model, measurement map c."""
    jm, ad, bd = _linear_model()
    jh, th = _maps(c)
    return (JMHE(jm, h=jh, discrete_method="rk4", **kw),
            MHE(_port_linear_model(), h=th, discrete_method="rk4", **kw),
            ad, bd)


def _tank_models():
    kw = dict(Nx=4, Nu=2, dt=3.0, R=np.diag([1e-4] * 4), clip_negative=True,
              integrator_substeps=10)
    return (JModel(ode=lambda x, u: jtank(x, u), dtype=jnp.float64, **kw),
            Model(ode=four_tank_ode, dtype=F64, device="cpu", **kw))


def _tank_gps(n=20, seed=3):
    """A numpy-seeded SE GP on the tank's (x, u) -> 4 outputs, in both
    packages with the same hypers."""
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.uniform(1.0, 12.0, (n, 4)),
                        rng.uniform(0.0, 6.0, (n, 2))], axis=1)
    y = 0.05 * np.sin(x[:, :4]) + 0.01 * x[:, 4:5]
    hyp = dict(log_ell=0.2 * rng.standard_normal((4, 6)) + 1.5,
               log_sf2=np.full(4, -3.0), log_sn2=np.full(4, -9.0))
    jg = JGP(jnp.asarray(x), jnp.asarray(y), mean_func="zero",
             hyper=JHypers(*(jnp.asarray(hyp[k]) for k in
                             ("log_ell", "log_sf2", "log_sn2")),
                           mean_w=jnp.zeros((4, 0))))
    tg = gp_from_numpy(x, y, **hyp, dtype=F64, device="cpu")
    return jg, tg


def _h_nonlinear():
    """A nonlinear two-output measurement map in both packages."""
    return (lambda x: jnp.stack([x[0], x[1] + 0.1 * x[2] ** 2]),
            lambda x: torch.stack([x[0], x[1] + 0.1 * x[2] ** 2]))


def _tank_pair(method, **kw):
    jm, tm = _tank_models()
    jg, tg = _tank_gps() if method in ("gp", "hybrid") else (None, None)
    jh, th = _h_nonlinear()
    bd = 0.5 * np.eye(4) if method == "hybrid" else None
    common = dict(window=3, Q_noise=np.diag([1e-4] * 4),
                  R_meas=np.diag([2.5e-3, 4e-3]), P_arrival=np.diag([0.5] * 4),
                  xlb=[0.0] * 4, discrete_method=method, hybrid_Bd=bd, **kw)
    return JMHE(jm, jg, h=jh, **common), MHE(tm, tg, h=th, **common)


def _np(v):
    return v.detach().numpy() if torch.is_tensor(v) else np.asarray(v)


# ------------------------------------------------------------- one window

def test_window_estimate_is_the_rts_smoother():
    """test_mhe.py:77: the full-window MAP estimate of a linear-Gaussian
    problem with the matching prior is the RTS smoother: the port's window
    is the smoother's within 1e-7, as the JAX package's is, and the JAX
    package's within 1e-6 (at tol_stat 1e-12 the two take 20 and 11
    iterations and stop 3e-8 apart, both inside the solver's tolerance)."""
    rng = np.random.default_rng(77)
    q, r, p0 = 1e-3 * np.eye(3), np.diag([4e-2, 1e-2]), 0.5 * np.eye(3)
    x_bar, m = np.array([0.2, -0.1, 0.3]), 8
    jmhe, tmhe, ad, bd = _linear_pair(
        C2, window=m, Q_noise=q, R_meas=r, P_arrival=p0,
        solver_opts=dict(max_iters=50, tol_stat=1e-12))
    x0 = x_bar + rng.multivariate_normal(np.zeros(3), p0) * 0.3
    _, us, ys = _simulate(ad, bd, C2, q, r, x0, m + 1, rng)
    jx, jres = jmhe.estimate(ys, us, x_bar, return_result=True)
    tx, tres = tmhe.estimate(ys, us, x_bar, return_result=True)
    assert bool(tres.converged) and bool(jres.converged)
    np.testing.assert_allclose(_np(tx), np.asarray(jx), rtol=0, atol=1e-6)
    x_smooth, _ = _rts_smoother(ad, bd, C2, q, r, x_bar, p0, ys, us)
    np.testing.assert_allclose(_np(tx), x_smooth, rtol=1e-7, atol=1e-7)


def test_estimates_respect_state_bounds():
    """test_mhe.py:128: with a biased sensor pushing past x1 <= 0.3 the
    estimates stay in the box, and the port's window is the JAX
    package's within 1e-8."""
    rng = np.random.default_rng(128)
    q, r, m = 1e-4 * np.eye(3), 1e-2 * np.eye(3), 6
    jmhe, tmhe, ad, bd = _linear_pair(
        np.eye(3), window=m, Q_noise=q, R_meas=r, P_arrival=0.1 * np.eye(3),
        xub=[0.3, 5.0, 5.0], xlb=[-5.0, -5.0, -5.0],
        solver_opts=dict(al_iters=8, max_iters=30, penalty_init=1e2))
    x0 = np.array([0.29, 0.0, 0.0])
    _, us, ys = _simulate(ad, bd, np.eye(3), q, r, x0, m + 1, rng)
    ys[:, 0] += 0.15
    tx = _np(tmhe.estimate(ys, us, x0))
    assert np.all(np.isfinite(tx))
    assert tx[:, 0].max() <= 0.3 + 1e-6, tx[:, 0]
    np.testing.assert_allclose(tx, np.asarray(jmhe.estimate(ys, us, x0)),
                               rtol=0, atol=1e-8)


def test_estimate_refuses_a_window_of_another_length():
    _, tmhe, _, _ = _linear_pair(C2, window=4, R_meas=np.eye(2))
    with pytest.raises(ValueError, match="ys must be"):
        tmhe.estimate(np.zeros((4, 2)), np.zeros((4, 1)), np.zeros(3))


# ------------------------------------------------------------- filtering

def test_online_filter_denoises_and_tracks():
    """test_mhe.py:103: ``run`` over 40 full-state measurements; past the
    fill-in transient the estimates beat the raw measurements, every
    window converges, and the record is the JAX package's within 1e-6."""
    rng = np.random.default_rng(103)
    q, r, t_total = 1e-4 * np.eye(3), 2.5e-3 * np.eye(3), 40
    jmhe, tmhe, ad, bd = _linear_pair(np.eye(3), window=6, Q_noise=q,
                                      R_meas=r, P_arrival=0.1 * np.eye(3))
    x0 = np.array([0.5, -0.3, 0.2])
    xs_true, us, ys = _simulate(ad, bd, np.eye(3), q, r, x0, t_total, rng)
    tx = _np(tmhe.run(x0, ys, us))
    assert tx.shape == (t_total, 3) and np.all(np.isfinite(tx))
    assert tmhe.last_converged.all()
    tail = slice(10, None)
    err_est = np.sqrt(np.mean((tx[tail] - xs_true[tail]) ** 2))
    err_meas = np.sqrt(np.mean((ys[tail] - xs_true[tail]) ** 2))
    assert err_est < 0.6 * err_meas, (err_est, err_meas)
    np.testing.assert_allclose(tx, np.asarray(jmhe.run(x0, ys, us)),
                               rtol=0, atol=1e-6)


def test_four_tank_partial_measurement():
    """test_mhe.py:153 (slow in the JAX suite): the unmeasured upper tanks
    recovered from noisy lower-tank levels by the window's end, the bounds
    held, the record of 25 measurements the JAX package's within 1e-6."""
    jm, tm = _tank_models()
    c = np.array([[1.0, 0, 0, 0], [0, 1.0, 0, 0]])
    r, q, t_total = np.diag([2.5e-3, 2.5e-3]), np.diag([1e-4] * 4), 25
    rng = np.random.default_rng(3)
    us = rng.uniform(2.0, 4.0, size=(t_total - 1, 2))
    xs_true = [np.array([8.0, 9.0, 2.0, 1.5])]
    for k in range(t_total - 1):
        xn = tm.integrate(torch.tensor(xs_true[-1]), torch.tensor(us[k]))
        xs_true.append(xn.numpy() + rng.multivariate_normal(np.zeros(4), q))
    xs_true = np.stack(xs_true)
    ys = xs_true @ c.T + rng.multivariate_normal(np.zeros(2), r,
                                                 size=t_total)
    jh, th = _maps(c)
    kw = dict(window=8, Q_noise=q, R_meas=r, P_arrival=np.diag([0.5] * 4),
              xlb=[0.1] * 4, xub=[25.0] * 4, discrete_method="rk4",
              solver_opts=dict(al_iters=2, max_iters=30))
    x_bar = np.array([8.0, 9.0, 1.0, 1.0])
    tx = _np(MHE(tm, h=th, **kw).run(x_bar, ys, us))
    err = np.abs(tx[12:, 2:] - xs_true[12:, 2:])
    assert err.max() < 0.25, err.max()
    assert np.all(tx >= 0.1 - 1e-9)
    np.testing.assert_allclose(
        tx, np.asarray(JMHE(jm, h=jh, **kw).run(x_bar, ys, us)), rtol=0,
        atol=1e-6)


def _kalman_run(mhe, ys, us, m, t_total):
    state = mhe.start_filter(np.zeros(3), ys[:m + 1], us[:m])
    out = []
    for k in range(m + 1, t_total):
        state, x_hat = mhe.step(state, ys[k], us[k - 1])
        out.append(_np(x_hat))
    return np.stack(out)


def test_arrival_update_equals_kalman_filter():
    """test_mhe.py:193: with the EKF-propagated arrival cost a window of
    M=2 reproduces the full-information Kalman filter at every step, the
    fixed-prior policy does not; both policies are the JAX package's
    within 1e-6."""
    rng = np.random.default_rng(193)
    m, t_total = 2, 18
    q, r, p0 = 1e-4 * np.eye(3), np.diag([2e-3, 4e-3]), 1e-2 * np.eye(3)
    _, ad, bd = _linear_model()
    _, us, ys = _simulate(ad, bd, C2, q, r, np.array([0.3, -0.2, 0.25]),
                          t_total, rng)
    _, x_filt = _rts_smoother(ad, bd, C2, q, r, np.zeros(3), p0, ys, us)
    errs = {}
    for upd in (True, False):
        jmhe, tmhe, _, _ = _linear_pair(
            C2, window=m, Q_noise=q, R_meas=r, P_arrival=p0,
            arrival_update=upd,
            solver_opts=dict(max_iters=50, tol_stat=1e-12))
        tx = _kalman_run(tmhe, ys, us, m, t_total)
        np.testing.assert_allclose(tx, _kalman_run(jmhe, ys, us, m, t_total),
                                   rtol=0, atol=1e-6)
        errs[upd] = np.abs(tx - x_filt[m + 1:]).max()
    assert errs[True] < 1e-6, errs
    assert errs[False] > 10 * max(errs[True], 1e-12), errs


@pytest.mark.parametrize("seed,nm,m", [(21, 1, 1), (22, 3, 3)])
def test_arrival_update_kalman_property_randomized(seed, nm, m):
    """test_mhe.py:301 (slow in the JAX suite): random measurement maps of
    rank 1 to full, random noise scales, windows M=1 and M=3 all reproduce
    the Kalman filter; the port's steps are the JAX package's within
    1e-6."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1.0, 1.0, size=(nm, 3))
    q = 1e-4 * np.eye(3)
    r = np.diag(rng.uniform(1e-3, 1e-2, size=nm))
    p0 = np.diag(rng.uniform(5e-3, 5e-2, size=3))
    x_bar0 = rng.uniform(-0.2, 0.2, size=3)
    t_total = 12
    _, ad, bd = _linear_model()
    _, us, ys = _simulate(ad, bd, c, q, r,
                          x_bar0 + rng.uniform(-0.1, 0.1, size=3), t_total,
                          rng)
    _, x_filt = _rts_smoother(ad, bd, c, q, r, x_bar0, p0, ys, us)
    jmhe, tmhe, _, _ = _linear_pair(
        c, window=m, Q_noise=q, R_meas=r, P_arrival=p0, arrival_update=True,
        solver_opts=dict(max_iters=50, tol_stat=1e-12))
    out = {}
    for name, mhe in (("port", tmhe), ("jax", jmhe)):
        state = mhe.start_filter(x_bar0, ys[:m + 1], us[:m])
        rows = []
        for k in range(m + 1, t_total):
            state, x_hat = mhe.step(state, ys[k], us[k - 1])
            rows.append(_np(x_hat))
        out[name] = np.stack(rows)
    assert np.abs(out["port"] - x_filt[m + 1:]).max() < 1e-6
    np.testing.assert_allclose(out["port"], out["jax"], rtol=0, atol=1e-6)


# ------------------------------------------------------------- operations

@pytest.mark.parametrize("fill", [0, 2])
def test_advance_prior_matches_jax(fill):
    """``_advance_prior`` with the EKF recursion (hybrid GP dynamics, a
    nonlinear measurement map), out of the fill-in transient (fill = 0:
    conditioned and predicted) and in it (fill = 2: the smoothed state and
    the prior covariance kept): the JAX package's within 1e-8."""
    jmhe, tmhe = _tank_pair("hybrid", arrival_update=True)
    rng = np.random.default_rng(40 + fill)
    x_bar = rng.uniform(2.0, 10.0, 4)
    a = 0.3 * rng.standard_normal((4, 4))
    p = a @ a.T + 0.1 * np.eye(4)
    xs = rng.uniform(2.0, 10.0, (5, 4))
    y_buf = rng.uniform(2.0, 10.0, (4, 2))
    u_buf = rng.uniform(0.0, 6.0, (3, 2))

    def res(x):
        return SimpleNamespace(state=SimpleNamespace(x=x))

    jx, jp = jmhe._advance_prior(
        jnp.asarray(x_bar), jnp.asarray(p), res(jnp.asarray(xs)),
        jnp.asarray(y_buf), jnp.asarray(u_buf), jnp.asarray(fill, jnp.int32))
    t = torch.tensor
    tx, tp = tmhe._advance_prior(t(x_bar), t(p), res(t(xs)), t(y_buf),
                                 t(u_buf), t(fill, dtype=torch.int32))
    np.testing.assert_allclose(_np(tx), np.asarray(jx), rtol=0, atol=1e-8)
    np.testing.assert_allclose(_np(tp), np.asarray(jp), rtol=0, atol=1e-8)
    if fill:
        np.testing.assert_array_equal(_np(tx), xs[2])
        np.testing.assert_array_equal(_np(tp), p)


@pytest.mark.parametrize("method", ["rk4", "exact", "gp", "hybrid"])
def test_mean_dynamics_matches_jax(method):
    """The window's model step for each discretization: the JAX
    package's within 1e-10 (the GP ones on the same numpy-seeded GP)."""
    jmhe, tmhe = _tank_pair(method)
    rng = np.random.default_rng(5)
    x, u = rng.uniform(2.0, 10.0, 4), rng.uniform(0.0, 6.0, 2)
    got = tmhe._mean_dynamics(torch.tensor(x), torch.tensor(u))
    ref = jmhe._mean_dynamics(jnp.asarray(x), jnp.asarray(u))
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("t", [0, 1, 3])
def test_stage_functions_match_jax(t):
    """The NLP's dynamics, stage cost and bound rows at the virtual stage
    (t = 0), the first and the last window stage, with t an int and, under
    ``torch.func.vmap``, a 0-d tensor: the JAX package's within 1e-10."""
    jmhe, tmhe = _tank_pair("gp", arrival_update=True)
    rng = np.random.default_rng(60 + t)
    z, v = rng.uniform(2.0, 10.0, 4), 0.1 * rng.standard_normal(4)
    us, ys = rng.uniform(0.0, 6.0, (3, 2)), rng.uniform(2.0, 10.0, (4, 2))
    x_bar = rng.uniform(2.0, 10.0, 4)
    jpar = jmhe._params(x_bar, us, ys)
    tpar = tmhe._params(*(torch.tensor(a) for a in (x_bar, us, ys)))
    jp, tp = jmhe._prob, tmhe._prob
    refs = [jp.dynamics(jnp.asarray(z), jnp.asarray(v), t, jpar),
            jp.stage_cost(jnp.asarray(z), jnp.asarray(v), t, jpar),
            jp.stage_ineq(jnp.asarray(z), jnp.asarray(v), t, jpar)]
    zt, vt = torch.tensor(z), torch.tensor(v)
    fns = [tp.dynamics, tp.stage_cost, tp.stage_ineq]
    for fn, ref in zip(fns, refs):
        got = fn(zt, vt, t, tpar)
        batched = torch.func.vmap(lambda zz, vv, tt: fn(zz, vv, tt, tpar))(
            zt[None], vt[None], torch.tensor([t]))[0]
        for g in (got, batched):
            np.testing.assert_allclose(_np(g), np.asarray(ref), rtol=0,
                                       atol=1e-10)
    np.testing.assert_allclose(
        _np(tp.terminal_cost(zt, tpar)),
        np.asarray(jp.terminal_cost(jnp.asarray(z), jpar)), rtol=0,
        atol=1e-10)


# ------------------------------------------------------------- contract

@pytest.mark.parametrize("case", ["identity", "partial", "nonlinear"])
def test_nm_is_taken_from_h(case):
    """Nm is the length of h at a zero state, as JAX's eval_shape gives
    it; the information matrices and the solver budget follow."""
    h = {"identity": None, "partial": _maps(C2)[1],
         "nonlinear": lambda x: torch.stack([x[0] * x[1]])}[case]
    nm = {"identity": 3, "partial": 2, "nonlinear": 1}[case]
    mhe = MHE(_port_linear_model(), h=h, window=2, R_meas=0.1)
    assert mhe.Nm == nm
    assert tuple(mhe.consts.r_inv.shape) == (nm, nm)
    torch.testing.assert_close(mhe.consts.r_inv, 10.0 * torch.eye(
        nm, dtype=F64))


@pytest.mark.parametrize("bounds,opts", [(False, None), (True, None),
                                         (True, "robust"),
                                         (False, dict(max_iters=7))])
def test_solver_budget_matches_jax(bounds, opts):
    """al_iters 3 with bounds and 1 without, max_iters 25, then the
    user's options (a preset drops fused_kkt in f64): the JAX MHE's
    SQPConfig field for field."""
    kw = dict(window=2, R_meas=0.1, solver_opts=opts,
              xlb=[-1.0] * 3 if bounds else None)
    jmhe, tmhe, _, _ = _linear_pair(np.eye(3), **kw)
    assert dataclasses.asdict(tmhe.sqp_cfg) == \
        dataclasses.asdict(jmhe.sqp_cfg)
    assert tmhe._prob.n_ineq == (6 if bounds else 0)


@pytest.mark.parametrize("kw,match", [
    (dict(solver_opts=dict(fused_kkt=True)), "fused_kkt"),
    (dict(R_meas=None), "R_meas"),
    (dict(window=0), "window"),
    (dict(discrete_method="euler"), "unknown discrete_method"),
    (dict(discrete_method="gp"), "requires a GP")])
def test_constructor_refuses(kw, match):
    """f64 with fused_kkt (the sweep kernel is f32), a missing R_meas, an
    empty window, an unknown discretization, a GP method without a GP:
    ValueError, as in the JAX package."""
    args = dict(window=2, R_meas=0.1)
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        MHE(_port_linear_model(), **args)


# ------------------------------------------------------------- output feedback

def test_output_feedback_matches_host_composition():
    """test_mhe.py:239 (slow in the JAX suite): simulate_output_feedback's
    loop (measurement, MHE window, MPC solve, plant step) is the host
    composition of ``mhe.step`` and ``mpc.solve_step`` on the same noise
    draws, within 1e-8."""
    _, model = _tank_models()
    c = np.array([[1.0, 0.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0]])
    _, th = _maps(c)
    mhe = MHE(model, window=3, Q_noise=model.R, R_meas=np.diag([2.5e-3] * 2),
              P_arrival=np.diag([0.5] * 4), h=th, xlb=[0.0] * 4,
              discrete_method="rk4")
    mpc = MPC(horizon=4 * 3.0, model=model, gp=None, gp_method="ME",
              discrete_method="rk4", Q=np.diag([10.0, 10.0, 0.1, 0.1]),
              R=0.01 * np.eye(2), ulb=[0.0, 0.0], uub=[8.0, 8.0],
              feedback=False, percentile=None, cov_updates=1, device="cpu")
    x0 = np.array([8.0, 9.0, 1.0, 1.0])
    x_bar = np.array([8.5, 8.5, 1.2, 1.2])
    x_sp = np.array([12.4, 12.7, 1.8, 1.4])
    n = 6
    rng = np.random.default_rng(12)
    noise_w = 0.01 * rng.standard_normal((n, 4))
    noise_v = 0.05 * rng.standard_normal((n, 2))
    res = simulate_output_feedback(mpc, mhe, x0, x_bar, n * 3.0, x_sp,
                                   noise_w=noise_w, noise_v=noise_v)
    assert res.x_true.shape == (n + 1, 4) and res.x_hat.shape == (n, 4)
    assert res.y.shape == (n, 2) and res.mhe_converged.shape == (n,)
    assert np.all(np.isfinite(res.x_true))
    t = torch.tensor
    est = mhe.init_filter(x_bar, mhe.h(t(x0)) + t(noise_v[0]))
    warm = mpc._init_warm(mpc._augment_x0(t(x_bar), torch.zeros(2, dtype=F64)),
                          mpc._ref_window(x_sp))
    x, u_prev = t(x0), torch.zeros(2, dtype=F64)
    for k in range(n):
        y = mhe.h(x) + t(noise_v[k])
        est, x_hat = mhe.step(est, y, u_prev)
        u0, warm, _, _ = mpc.solve_step(x_hat, x_sp, warm=warm,
                                        u_prev=u_prev)
        x = torch.clamp(model.integrate(x, u0) + t(noise_w[k]), min=0.0)
        np.testing.assert_allclose(_np(x_hat), res.x_hat[k], atol=1e-8)
        np.testing.assert_allclose(_np(u0), res.u[k], atol=1e-8)
        np.testing.assert_allclose(_np(x), res.x_true[k + 1], atol=1e-8)
        u_prev = u0


def test_output_feedback_draws_its_noise_from_a_generator():
    """Without explicit draws the loop takes w, then v, from its
    generator (seeded 0 by default): the same seed gives the same record,
    noise=False none; the adaptive controller is refused."""
    _, model = _tank_models()
    mhe = MHE(model, window=1, R_meas=np.diag([1e-2] * 4), xlb=[0.0] * 4,
              solver_opts=dict(al_iters=1, max_iters=3))
    mpc = MPC(horizon=2 * 3.0, model=model, gp=None, gp_method="ME",
              discrete_method="rk4", feedback=False, ulb=[0.0, 0.0],
              uub=[8.0, 8.0], cov_updates=1,
              solver_opts=dict(al_iters=1, max_iters=3), device="cpu")
    x0, x_sp = np.array([8.0, 9.0, 1.0, 1.0]), np.array([9.0, 9.5, 1.2, 1.1])
    runs = [simulate_output_feedback(mpc, mhe, x0, x0, 2 * 3.0, x_sp,
                                     generator=g)
            for g in (None, torch.Generator().manual_seed(0))]
    np.testing.assert_array_equal(runs[0].x_true, runs[1].x_true)
    quiet = simulate_output_feedback(mpc, mhe, x0, x0, 2 * 3.0, x_sp,
                                     noise=False)
    np.testing.assert_array_equal(quiet.y[0], x0)
    assert np.abs(runs[0].y[0] - x0).max() > 0
    mpc.online_capacity = 8
    with pytest.raises(ValueError, match="online_capacity"):
        simulate_output_feedback(mpc, mhe, x0, x0, 3.0, x_sp)
