"""Port parity for slice B, the car (bench config 4): the car ODE and its
ellipse obstacles, exact moment matching (EM), the hybrid discretization,
user inequality constraints with per-solve parameters, and the delta-u
state augmentation, each held against the JAX package on the same numpy
inputs (f64 unless a test says otherwise)."""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import bench
from benchmarks.bench_spec import (DT, MODEL_R, Q_W, R_W, ULB, UUB, X0, XLB,
                                   XSP, XUB)
from gpmpc_tpu import GP as JGP, MPC as JMPC, Model as JModel
from gpmpc_tpu.models.gp_core import GPHypers as JHypers, \
    GPPosterior as JPosterior
from gpmpc_tpu.models.propagate import Normalization as JNorm, \
    propagate_em as jpropagate_em
from gpmpc_tpu.ops.chol import chol_logdet_small as jchol_logdet_small
from gpmpc_tpu.ops.pallas_kernels import rk4_substeps_pallas
from gpmpc_tpu import systems as jsystems
from gpmpc_tpu.systems import car_ode as jcar_ode, \
    ellipse_obstacle_constraints as jellipse, four_tank_ode as jtank_ode
from gpmpc_tpu.utils.config import GPConfig as JGPConfig
from gpmpc_tpu_torch import MPC, Model
from gpmpc_tpu_torch import systems
from gpmpc_tpu_torch.models.convert import FIXTURE, gp_from_fixture
from gpmpc_tpu_torch.models.propagate import propagate_em
from gpmpc_tpu_torch.ops.chol import chol_logdet_small
from gpmpc_tpu_torch.ops.cuda_kernels import rk4_substeps_reference
from gpmpc_tpu_torch.solvers import al_sqp
from gpmpc_tpu_torch.systems import car_ode, ellipse_obstacle_constraints, \
    four_tank_ode

F64 = torch.float64
#: the car bench's solver budget (bench.py:321-325, the port's "rti"
#: preset) without the fused KKT sweep, which is f32 only
CAR_BUDGET = dict(al_iters=2, max_iters=12, penalty_init=100.0,
                  penalty_mult=30.0, merit_viol=10.0)
#: the f32-safe GP recipe of the tank fixture (bench.py:469-470)
TANK_OPTS = dict(jitter=1e-5, min_noise=1e-4)


def _jax_gp(prefix, dtype=jnp.float64, n=None, **kw):
    f = np.load(FIXTURE)
    sl = slice(None) if n is None else slice(0, n)
    hyper = JHypers(*(jnp.asarray(f[f"{prefix}_{k}"], dtype)
                      for k in ("log_ell", "log_sf2", "log_sn2")),
                    mean_w=jnp.zeros((4, 0), dtype))
    return JGP(jnp.asarray(f[f"{prefix}_X"][sl], dtype),
               jnp.asarray(f[f"{prefix}_Y"][sl], dtype), mean_func="zero",
               hyper=hyper, **kw)


def _car_pair(nt=20, n=None, solver_opts=CAR_BUDGET, **kw):
    """The car bench's controller (bench.build_car) on both sides, f64 on
    the CPU, at horizon ``nt`` with the fixture GP's first ``n`` points."""
    cb_j, n_par = jellipse(2, scale=2.0)
    cb_t, _ = ellipse_obstacle_constraints(2, scale=2.0)
    common = dict(horizon=nt * 0.1, gp_method="EM", discrete_method="hybrid",
                  Q=np.diag([5.0, 20.0, 0.5, 1.0]), R=np.diag([0.1, 1.0]),
                  S=np.diag([0.05, 0.5]), ulb=systems.CAR_U_LB,
                  uub=systems.CAR_U_UB, xlb=[-5.0, -4.0, -2.0, 0.0],
                  xub=[25.0, 4.0, 2.0, 10.0], percentile=0.95, feedback=True,
                  op_x=systems.CAR_X0, num_con_par=n_par, cov_updates=1,
                  solver_opts=solver_opts, **kw)
    r = np.diag([1e-5, 1e-5, 1e-6, 1e-5])
    jm = JModel(Nx=4, Nu=2, ode=lambda x, u: jcar_ode(x, u), dt=0.1, R=r,
                dtype=jnp.float64, integrator_substeps=10)
    jmpc = JMPC(model=jm, gp=_jax_gp("car", n=n, gp_method="EM"),
                inequality_constraints=cb_j, dtype=jnp.float64, **common)
    tm = Model(Nx=4, Nu=2, ode=car_ode, dt=0.1, R=r, dtype=F64,
               integrator_substeps=10, device="cpu")
    tmpc = MPC(model=tm, gp=gp_from_fixture(prefix="car", n=n, dtype=F64,
                                            gp_method="EM", device="cpu"),
               inequality_constraints=cb_t, device="cpu", **common)
    return jmpc, tmpc


def test_car_constants_equal_bench():
    for name in ("CAR_X_LB", "CAR_X_UB", "CAR_U_LB", "CAR_U_UB"):
        np.testing.assert_array_equal(getattr(systems, name),
                                      getattr(bench, name))
    mpc, x0, x_sp, con_par, obstacles, dt = bench.build_car(
        jnp.float64, solver_opts=CAR_BUDGET)
    np.testing.assert_array_equal(systems.CAR_OBSTACLES, obstacles)
    np.testing.assert_array_equal(systems.CAR_X0, x0)
    np.testing.assert_array_equal(systems.CAR_XSP, x_sp)
    assert dt == 0.1 and systems.CAR_PARAMS == jsystems.CAR_PARAMS


def test_car_ode_and_obstacles_match_jax():
    """car_ode over headings past +-pi and steering to +-0.5 rad, and the
    obstacle callback with a nonzero covariance, at 1e-12."""
    rng = np.random.default_rng(0)
    x = rng.uniform([-2, -2, -4.0, 0], [20, 2, 4.0, 8], (64, 4))
    u = rng.uniform([-3, -0.5], [3, 0.5], (64, 2))
    got = car_ode(torch.tensor(x), torch.tensor(u)).numpy()
    want = np.stack([np.asarray(jcar_ode(jnp.asarray(a), jnp.asarray(b)))
                     for a, b in zip(x, u)])
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    cb_j, n_par = jellipse(2, scale=2.0)
    cb_t, n_par_t = ellipse_obstacle_constraints(2, scale=2.0)
    assert n_par == n_par_t == 8
    par = systems.CAR_OBSTACLES.reshape(-1)
    for i in range(16):
        a = rng.standard_normal((4, 4)) * 0.3
        cov = a @ a.T
        g_t = cb_t(torch.tensor(x[i]), torch.tensor(cov),
                   torch.tensor(u[i]), torch.tensor(par)).numpy()
        g_j = np.asarray(cb_j(jnp.asarray(x[i]), jnp.asarray(cov),
                              jnp.asarray(u[i]), jnp.asarray(par)))
        np.testing.assert_allclose(g_t, g_j, rtol=1e-12, atol=1e-12)


def test_chol_logdet_small_matches_jax():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((5, 6, 6))
    spd = a @ np.swapaxes(a, -1, -2) + 6 * np.eye(6)
    l = np.linalg.cholesky(spd)
    np.testing.assert_allclose(chol_logdet_small(torch.tensor(l)).numpy(),
                               np.asarray(jchol_logdet_small(jnp.asarray(l))),
                               rtol=1e-12)


def _em_inputs(prefix, rng, k, scale):
    x = np.load(FIXTURE)[f"{prefix}_X"].astype(np.float64)
    mu = x[k] + 0.2 * rng.standard_normal(6) * x.std(0)
    a = rng.standard_normal((6, 6)) * x.std(0) * scale
    return mu, a @ a.T


def _to_jax(post, norm):
    hyp = JHypers(*(jnp.asarray(v.numpy()) for v in post.hypers))
    return (JPosterior(*(jnp.asarray(v.numpy()) for v in post[:4]),
                       hypers=hyp),
            JNorm(*(jnp.asarray(v.numpy()) for v in norm)))


@pytest.mark.parametrize("prefix,opts,scales", [
    ("car", {}, (1e-3, 0.1)), ("tank", TANK_OPTS, (0.1, 0.3))])
def test_propagate_em_matches_jax(prefix, opts, scales):
    """mu, Sigma and C of EM at the car and the tank fixture (zero mean),
    the same posterior arrays on both sides, over input Gaussians around
    the training points whose spread is ``scales`` of the data's: <= 1e-8
    relative to each output's largest entry.  Measured on a CPU: ~1e-15 at
    the car; ~5e-9 at the tank, whose Sigma there is a difference of
    beta' Q2 beta terms ~1e9 times larger (alpha ~ 1e4 at its 1e-4 noise
    floor): at an input spread of 1e-3 of the data's the two packages'
    f64 summation orders part by 7.7e-9 there, 7e-6 of the largest
    entry."""
    g = gp_from_fixture(prefix=prefix, dtype=F64, gp_method="EM",
                        optimizer_opts=opts, device="cpu")
    jpost, jnorm = _to_jax(g.post, g.norm)
    rng = np.random.default_rng(2)
    for k in range(4):
        mu, cov = _em_inputs(prefix, rng, k, scales[k % 2])
        got = propagate_em(g.post, g.norm, g.cfg, torch.tensor(mu),
                           torch.tensor(cov))
        want = jpropagate_em(jpost, jnorm, JGPConfig(**opts),
                             jnp.asarray(mu), jnp.asarray(cov))
        for a, b in zip(got, want):
            b = np.asarray(b)
            assert a.shape == b.shape
            np.testing.assert_allclose(a.numpy(), b,
                                       atol=1e-8 * np.abs(b).max())


def test_f32_em_covariance_matches_jax_x64():
    """The car's f32 EM covariance (fixture GP, explicit-inverse diagonal
    term as in the JAX package) against JAX x64 at the closed loop's
    covariance scale: every entry within 1e-3 of the largest, the diagonal
    within 1e-3 relative.  Measured on a CPU: <= 8.3e-5 relative on the
    diagonal, as close as JAX's own f32 (7.3e-5)."""
    g = gp_from_fixture(prefix="car", dtype=torch.float32, gp_method="EM",
                        device="cpu")
    jg = _jax_gp("car", gp_method="EM")
    rng = np.random.default_rng(3)
    for k in range(6):
        mu, _ = _em_inputs("car", rng, k, 0.0)
        a = rng.standard_normal((6, 6)) * 1e-3
        cov = a @ a.T
        mu_t, sig_t, c_t = propagate_em(
            g.post, g.norm, g.cfg, torch.tensor(mu, dtype=torch.float32),
            torch.tensor(cov, dtype=torch.float32))
        mu_j, sig_j, c_j = jpropagate_em(jg.post, jg.norm, jg.cfg,
                                         jnp.asarray(mu), jnp.asarray(cov))
        sig_t, sig_j = sig_t.double().numpy(), np.asarray(sig_j)
        np.testing.assert_allclose(sig_t, sig_j,
                                   atol=1e-3 * np.abs(sig_j).max())
        np.testing.assert_allclose(np.diag(sig_t), np.diag(sig_j),
                                   rtol=1e-3)
        np.testing.assert_allclose(mu_t.double().numpy(), np.asarray(mu_j),
                                   atol=1e-3 * np.abs(mu_j).max())
        np.testing.assert_allclose(c_t.double().numpy(), np.asarray(c_j),
                                   atol=1e-3 * np.abs(c_j).max() + 1e-30)


def test_em_guards():
    g = gp_from_fixture(prefix="car", n=10, device="cpu")
    g.cfg = dataclasses.replace(g.cfg, mean_func="linear")
    with pytest.raises(ValueError, match="mean_func='zero'"):
        g.set_method("EM")
    g.cfg = dataclasses.replace(g.cfg, mean_func="zero", kernel="matern52")
    with pytest.raises(ValueError, match="kernel='se'"):
        g.set_method("EM")
    g.cfg = dataclasses.replace(g.cfg, kernel="se")
    g.set_method("EM")
    g.set_method("UT")          # ported with slice F (part 1)


def test_hybrid_dynamics_and_covariance_match_jax():
    """The car's hybrid mean map rk4 + Bd mu_gp and its covariance step
    (linearized known part, EM residual part, cross terms through C, with
    the LQR feedback gain from the known model at op_x) at full width
    (fixture GP, N=80): within 1e-10 of each output's largest entry."""
    jmpc, tmpc = _car_pair()
    np.testing.assert_allclose(tmpc.K_fb.numpy(), np.asarray(jmpc.K_fb),
                               atol=1e-10)
    np.testing.assert_array_equal(tmpc.Bd.numpy(), np.asarray(jmpc.Bd))
    rng = np.random.default_rng(4)
    for _ in range(4):
        x = rng.uniform([-1, -1, -0.6, 0.5], [1, 1, 0.6, 8])
        u = rng.uniform([-3, -0.5], [3, 0.5])
        a = rng.standard_normal((4, 4)) * 0.05
        sig = a @ a.T
        got = tmpc._mean_dynamics(torch.tensor(x), torch.tensor(u),
                                  tmpc.consts).numpy()
        want = np.asarray(jmpc._mean_dynamics(jnp.asarray(x), jnp.asarray(u),
                                              jmpc.consts))
        np.testing.assert_allclose(got, want, atol=1e-10 * np.abs(want).max())
        got = tmpc._cov_step(torch.tensor(x), torch.tensor(u),
                             torch.tensor(sig), tmpc.consts).numpy()
        want = np.asarray(jmpc._cov_step(jnp.asarray(x), jnp.asarray(u),
                                         jnp.asarray(sig), jmpc.consts))
        np.testing.assert_allclose(got, want, atol=1e-10 * np.abs(want).max())


def test_constrained_car_solve_step_matches_jax():
    """A cold and a warm solve_step of the car (EM, hybrid, Delta-u, the
    two obstacles through con_par) at test scale, Nt=8 and the fixture
    GP's first 40 points, from a state the horizon carries into the first
    obstacle: u0 and the warm iterate within 1e-6."""
    init = dict(al_iters=2, max_iters=8)
    jmpc, tmpc = _car_pair(nt=8, n=40, init_solver_opts=init)
    x0 = np.array([3.2, 0.1, 0.05, 2.0])
    par = systems.CAR_OBSTACLES.reshape(-1)
    ju0, jwarm, _, jinfo = jmpc.solve_step(jnp.asarray(x0),
                                           jnp.asarray(systems.CAR_XSP),
                                           con_par=jnp.asarray(par))
    tu0, twarm, _, tinfo = tmpc.solve_step(x0, systems.CAR_XSP, con_par=par)
    np.testing.assert_allclose(tu0.numpy(), np.asarray(ju0), atol=1e-6)
    np.testing.assert_allclose(twarm.x.numpy(), np.asarray(jwarm.x),
                               atol=1e-6)
    # the obstacle is active: a multiplier of the user rows is positive
    assert float(twarm.lam[:, -2:].max()) > 0
    x1 = x0 + 0.1 * np.array([2.0, 0.0, 0.0, 0.0])
    ju1, jwarm1, _, _ = jmpc.solve_step(
        jnp.asarray(x1), jnp.asarray(systems.CAR_XSP), warm=jwarm,
        u_prev=ju0, con_par=jnp.asarray(par))
    tu1, twarm1, _, _ = tmpc.solve_step(x1, systems.CAR_XSP, warm=twarm,
                                        u_prev=tu0, con_par=par)
    np.testing.assert_allclose(tu1.numpy(), np.asarray(ju1), atol=1e-6)
    for a, b in zip(twarm1, jwarm1):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    np.testing.assert_array_equal(tinfo.iters.numpy(),
                                  np.asarray(jinfo.iters))


def test_tank_closed_loop_with_delta_u_matches_jax():
    """The four-tank TA loop with the Delta-u penalty S and hard rate
    bounds dulb/duub (state augmented with the previous input, rate rows in
    the NLP, rate clip of the applied input), Nt=5, 4 steps, noise off:
    trajectories within 1e-6."""
    f = np.load(FIXTURE)
    hyper = JHypers(*(jnp.asarray(f[f"tank_{k}"], jnp.float64)
                      for k in ("log_ell", "log_sf2", "log_sn2")),
                    mean_w=jnp.zeros((4, 0), jnp.float64))
    kw = dict(horizon=5 * DT, gp_method="TA", discrete_method="gp", Q=Q_W,
              R=R_W, S=np.diag([0.5, 0.2]), dulb=[-0.6, -0.6],
              duub=[0.6, 0.6], ulb=ULB, uub=UUB, xlb=XLB, xub=XUB,
              percentile=0.95, feedback=True, cov_updates=1, op_x=XSP,
              op_u=np.array([3.0, 3.0]),
              solver_opts=dict(al_iters=2, max_iters=3),
              init_solver_opts=dict(al_iters=2, max_iters=6))
    jm = JModel(Nx=4, Nu=2, ode=lambda x, u: jtank_ode(x, u), dt=DT,
                R=MODEL_R, clip_negative=True, dtype=jnp.float64,
                integrator_substeps=10)
    jg = JGP(jnp.asarray(f["tank_X"][:30]), jnp.asarray(f["tank_Y"][:30]),
             mean_func="zero", hyper=hyper, gp_method="TA",
             optimizer_opts=TANK_OPTS)
    jmpc = JMPC(model=jm, gp=jg, dtype=jnp.float64, **kw)
    tm = Model(Nx=4, Nu=2, ode=four_tank_ode, dt=DT, R=MODEL_R,
               clip_negative=True, dtype=F64, integrator_substeps=10,
               device="cpu")
    tg = gp_from_fixture(n=30, dtype=F64, gp_method="TA",
                         optimizer_opts=TANK_OPTS, device="cpu")
    tmpc = MPC(model=tm, gp=tg, device="cpu", **kw)
    assert tmpc.Nxa == jmpc.Nxa == 6
    jx, ju = jmpc.solve(jnp.asarray(X0), 4 * DT, jnp.asarray(XSP),
                        noise=False)
    tx, tu = tmpc.solve(X0, 4 * DT, XSP, noise=False)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-6)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=1e-6)
    # the rate window binds in the saturated transient
    du = np.abs(np.diff(np.vstack([np.zeros(2), tu.numpy()]), axis=0))
    assert du.max() <= 0.6 + 1e-9 and np.isclose(du.max(), 0.6)


@pytest.mark.parametrize("case", ["car_step", "tank_delta_u_loop"])
def test_masked_inner_loop_matches_jax(case, monkeypatch):
    """The two constrained parity checks above with the AL-SQP inner loop
    run as the card runs it, its whole masked budget (no early exit on the
    CPU), at the same tolerances against JAX."""
    monkeypatch.setattr(al_sqp, "CPU_EARLY_EXIT", False)
    {"car_step": test_constrained_car_solve_step_matches_jax,
     "tank_delta_u_loop": test_tank_closed_loop_with_delta_u_matches_jax,
     }[case]()


@pytest.mark.parametrize("gp_method,extra", [
    ("TA", {}),
    ("EM", dict(S=np.diag([0.5, 0.2]), dulb=[-0.6, -0.6], duub=[0.6, 0.6]))])
def test_early_exit_is_the_masked_loop_bit_for_bit(gp_method, extra,
                                                   monkeypatch):
    """The CPU's early exit against the masked budget, bit for bit (u0, the
    warm iterate, the iteration count): a cold four-tank step at the
    converged default budget (al6 x mi30), where the exit skips most
    steps; TA, and EM with the delta-u augmentation.  (The car at test
    scale runs its whole budget from the obstacle state, so the exit
    skips nothing there.)"""
    tm = Model(Nx=4, Nu=2, ode=four_tank_ode, dt=DT, R=MODEL_R,
               clip_negative=True, dtype=F64, integrator_substeps=10,
               device="cpu")
    mpc = MPC(horizon=5 * DT, model=tm,
              gp=gp_from_fixture(n=30, dtype=F64, gp_method=gp_method,
                                 optimizer_opts=TANK_OPTS, device="cpu"),
              gp_method=gp_method, discrete_method="gp", Q=Q_W, R=R_W,
              ulb=ULB, uub=UUB, xlb=XLB, xub=XUB, percentile=0.95,
              feedback=True, cov_updates=1, op_x=XSP,
              op_u=np.array([3.0, 3.0]), device="cpu", **extra)
    runs = []
    for early_exit in (True, False):
        monkeypatch.setattr(al_sqp, "CPU_EARLY_EXIT", early_exit)
        u0, warm, _, info = mpc.solve_step(X0, XSP)
        runs.append((u0, *warm, info.iters))
    cfg = mpc.init_sqp_cfg
    assert int(runs[0][-1]) < cfg.al_iters * cfg.max_iters // 2
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_car_rk4_plain_matches_pallas_interpret():
    """K2's plain version with the car ODE against the JAX package's fused
    RK4 kernel in interpret mode (f32, n_sub=10, h = dt/10), over headings
    past +-pi and steering at +-0.5 rad: the Pallas test's rtol 1e-6,
    atol 1e-7."""
    rng = np.random.default_rng(5)
    xs = rng.uniform([-2, -2, -4.0, 0], [20, 2, 4.0, 8], (12, 4))
    us = rng.uniform([-3, -0.5], [3, 0.5], (12, 2))
    us[0, 1], us[1, 1] = 0.5, -0.5
    xs[2, 2], xs[3, 2] = np.pi + 0.3, -np.pi - 0.3
    xs, us = xs.astype(np.float32), us.astype(np.float32)
    got = rk4_substeps_reference(car_ode, torch.tensor(xs), torch.tensor(us),
                                 0.01, 10).numpy()
    for x, u, g in zip(xs, us, got):
        want = np.asarray(rk4_substeps_pallas(
            lambda a, b: jcar_ode(a, b), jnp.asarray(x), jnp.asarray(u),
            0.01, 10, interpret=True))
        np.testing.assert_allclose(g, want, rtol=1e-6, atol=1e-7)


def test_car_validation_matches_jax():
    """The car residual GP's validate (fixture GP) on 200 held-out points
    of the training box, targets integrate - rk4 of the car in f64 (the
    check of benchmarks/r5_car_seeds.py): SMSE, MNLP and RMSE per dim
    within 1e-8 relative of JAX's on the same numpy points."""
    rng = np.random.default_rng(6)
    x = rng.uniform(systems.CAR_X_LB, systems.CAR_X_UB, (200, 4))
    u = rng.uniform(systems.CAR_U_LB, systems.CAR_U_UB, (200, 2))
    tm = Model(Nx=4, Nu=2, ode=car_ode, dt=0.1, dtype=F64,
               integrator_substeps=10, device="cpu")
    xt, ut = torch.tensor(x), torch.tensor(u)
    y = (tm.integrate(xt, ut) - tm.rk4(xt, ut)).numpy()
    z = np.concatenate([x, u], axis=1)
    tg = gp_from_fixture(prefix="car", dtype=F64, gp_method="EM",
                         device="cpu")
    got = tg.validate(z, y, verbose=False)
    want = _jax_gp("car", gp_method="EM").validate(jnp.asarray(z), y,
                                                   verbose=False)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-8)


def test_f32_car_controller_stays_in_f32():
    """The car in f32 on the CPU (the card's dtype): the ODE's Jacobians,
    the LQR gain and a cold and a warm solve_step stay float32 and finite
    (torch.func gives float64 tangents for a 0-d slice times a Python
    float, as car_ode is written; the port brings them back)."""
    m = Model(Nx=4, Nu=2, ode=car_ode, dt=0.1, integrator_substeps=10,
              device="cpu")
    a, b = m.discrete_linearize(torch.tensor(systems.CAR_X0,
                                             dtype=torch.float32),
                                torch.zeros(2))
    assert a.dtype == b.dtype == torch.float32
    cb, n_par = ellipse_obstacle_constraints(2, scale=2.0)
    mpc = MPC(horizon=0.8, model=m,
              gp=gp_from_fixture(prefix="car", n=40, gp_method="EM",
                                 device="cpu"),
              gp_method="EM", discrete_method="hybrid",
              Q=np.diag([5.0, 20.0, 0.5, 1.0]), R=np.diag([0.1, 1.0]),
              S=np.diag([0.05, 0.5]), ulb=systems.CAR_U_LB,
              uub=systems.CAR_U_UB, percentile=0.95, feedback=True,
              op_x=systems.CAR_X0, inequality_constraints=cb,
              num_con_par=n_par, cov_updates=1, solver_opts="rti",
              init_solver_opts=dict(al_iters=1, max_iters=4), device="cpu")
    assert mpc.K_fb.dtype == torch.float32 and mpc.Nxa == 6
    par = systems.CAR_OBSTACLES.reshape(-1)
    u0, warm, sig, _ = mpc.solve_step(systems.CAR_X0, systems.CAR_XSP,
                                      con_par=par)
    u1, warm, sig, _ = mpc.solve_step(systems.CAR_X0, systems.CAR_XSP,
                                      warm=warm, u_prev=u0, con_par=par)
    for t in (u0, u1, sig, *warm):
        assert t.dtype == torch.float32 and bool(torch.all(torch.isfinite(t)))
