"""Port parity for ``MPC(online_capacity=, online_policy=)``: the closed
loop that conditions its GP on every observed transition (raw next state
in ``gp`` mode, the model residual through the pseudo-inverse of Bd in
``hybrid`` mode), held against the JAX package's closed loop at f64 on the
same fixture GP with one explicit noise draw passed to both; and the f32
explicit-inverse variance the online posterior predicts with, against JAX
x64."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from benchmarks.bench_spec import DT, MODEL_R, X0, XSP
from gpmpc_tpu import GP as JGP, MPC as JMPC, Model as JModel
from gpmpc_tpu.models.gp_core import GPHypers as JHypers
from gpmpc_tpu.parallel import online_gp as jonline
from gpmpc_tpu.systems import four_tank_ode as jode
from gpmpc_tpu_torch import GP, MPC, Model
from gpmpc_tpu_torch.models.convert import FIXTURE, gp_from_fixture
from gpmpc_tpu_torch.models.gp_core import GPHypers
from gpmpc_tpu_torch.parallel import online_gp
from gpmpc_tpu_torch.systems import four_tank_ode

from test_torch_mpc import GP_OPTS, MPC_KW
from test_torch_tightening import U_HOLD, X_MID

F64 = torch.float64
N_TRAIN, NT, STEPS, CAPACITY = 25, 5, 6, 40
BUDGET = dict(solver_opts=dict(al_iters=2, max_iters=3),
              init_solver_opts=dict(al_iters=2, max_iters=6))


def _models():
    jm = JModel(Nx=4, Nu=2, ode=lambda x, u: jode(x, u), dt=DT, R=MODEL_R,
                clip_negative=True, dtype=jnp.float64, integrator_substeps=10)
    tm = Model(Nx=4, Nu=2, ode=four_tank_ode, dt=DT, R=MODEL_R,
               clip_negative=True, dtype=F64, integrator_substeps=10,
               device="cpu")
    return jm, tm


def _gps(jm, gp_method, residual):
    """The fixture's first N_TRAIN points and hypers on both sides; with
    ``residual`` the targets are the residuals x+ - rk4(x, u) a hybrid
    controller's GP models."""
    f = np.load(FIXTURE)
    x = np.asarray(f["tank_X"][:N_TRAIN], np.float64)
    y = np.asarray(f["tank_Y"][:N_TRAIN], np.float64)
    if residual:
        y = y - np.asarray(jax.vmap(jm.rk4)(jnp.asarray(x[:, :4]),
                                            jnp.asarray(x[:, 4:])))
    logs = [np.asarray(f[f"tank_{k}"], np.float64)
            for k in ("log_ell", "log_sf2", "log_sn2")]
    jg = JGP(jnp.asarray(x), jnp.asarray(y), mean_func="zero",
             gp_method=gp_method,
             hyper=JHypers(*(jnp.asarray(v) for v in logs),
                           mean_w=jnp.zeros((4, 0))),
             optimizer_opts=GP_OPTS)
    tg = GP(x, y, mean_func="zero", gp_method=gp_method,
            hyper=GPHypers(*logs, np.zeros((4, 0))), optimizer_opts=GP_OPTS,
            dtype=F64, device="cpu")
    return jg, tg


@pytest.mark.parametrize("discrete_method,gp_method,policy", [
    ("gp", "TA", "saturate"), ("hybrid", "ME", "fifo")])
def test_online_closed_loop_matches_jax(discrete_method, gp_method, policy):
    """Six steps of the online closed loop (capacity 40 over 25 training
    points, chance tightening and LQR feedback in ``gp`` mode), port f64
    against JAX x64 on one noise draw: states and inputs within 1e-6, the
    conditioned posterior's count equal, its leaves within 1e-6 of their
    scale.  In ``gp`` mode the solves' TA variance comes from the online
    posterior's explicit inverse (its type selects the form)."""
    jm, tm = _models()
    jg, tg = _gps(jm, gp_method, residual=discrete_method == "hybrid")
    kw = dict(MPC_KW, horizon=NT * DT, gp_method=gp_method,
              discrete_method=discrete_method, online_capacity=CAPACITY,
              online_policy=policy, **BUDGET)
    jmpc = JMPC(model=jm, gp=jg, **kw)
    tmpc = MPC(model=tm, gp=tg, device="cpu", **kw)
    noise_w = np.random.default_rng(2).normal(0.0, 0.05, (STEPS, 4))
    jx, ju, _, _, jpost = jmpc._closed_loop_jit(
        jnp.asarray(X0), jmpc._prep_ref_windows(XSP, STEPS), None,
        jmpc._prep_con_pars(None, STEPS), jnp.asarray(noise_w), jmpc.consts,
        jmpc.online_post0, n_steps=STEPS, noise=True)
    tx, tu = tmpc.solve(X0, STEPS * DT, XSP, noise_w=noise_w)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-6)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=1e-6)
    assert tmpc.last_run["gp_points"] == int(jpost.count) > N_TRAIN
    for name, got, ref in zip(jpost._fields, tmpc.online_post, jpost):
        ref = np.asarray(ref, np.float64)
        scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-6 * scale, err_msg=name)
    if discrete_method == "hybrid":
        # conditioned on residuals (O(noise)), not on raw next states (O(10))
        m = int(tmpc.online_post.count)
        y = tmpc.online_post.y[N_TRAIN:m] * tg.norm.y_std + tg.norm.y_mean
        assert float(y.abs().max()) < 1.0


def test_online_options_checked():
    jm, tm = _models()
    _, tg = _gps(jm, "TA", residual=False)
    kw = dict(horizon=NT * DT, model=tm, device="cpu")
    with pytest.raises(ValueError, match="GP-based"):
        MPC(gp=tg, discrete_method="rk4", online_capacity=40, **kw)
    with pytest.raises(ValueError, match="'saturate' or 'fifo'"):
        MPC(gp=tg, online_capacity=40, online_policy="lru", **kw)
    with pytest.raises(ValueError, match="capacity 20 < training size 25"):
        MPC(gp=tg, online_capacity=20, **kw)


def test_f32_explicit_inverse_variance_against_jax_x64():
    """The online posterior's f32 variance (the explicit-inverse form
    sf2 - k*'K^-1 k*, the JAX package's) at the tightening test's points
    around the main path, full width (100 points, capacity 128), against
    JAX x64, with JAX's own f32 online variance beside it.  Gaps are in
    units of the prior variance sf2 y_std^2; the honest variances here are
    9e-6 to 1.1e-4 of it, so both f32 forms are rounding noise at their
    worst (cond(K) ~ 1e4; ROADMAP §3).  Held: the port's median gap at
    most JAX f32's and its worst gap within 3x JAX f32's worst.  Measured
    on a CPU: port median 6.7e-5, worst 2.2e-2; JAX f32 median 1.3e-3,
    worst 9.0e-3."""
    f = np.load(FIXTURE)
    logs = [f[f"tank_{k}"] for k in ("log_ell", "log_sf2", "log_sn2")]

    def jgp(dtype):
        return JGP(jnp.asarray(f["tank_X"], dtype),
                   jnp.asarray(f["tank_Y"], dtype), mean_func="zero",
                   hyper=JHypers(*(jnp.asarray(v, dtype) for v in logs),
                                 mean_w=jnp.zeros((4, 0), dtype)),
                   optimizer_opts=GP_OPTS)

    jpost64, jnorm64 = jonline.from_gp(jgp(jnp.float64), 128)
    jpost32, jnorm32 = jonline.from_gp(jgp(jnp.float32), 128)
    tg = gp_from_fixture(dtype=torch.float32, optimizer_opts=GP_OPTS,
                         device="cpu")
    post, norm = online_gp.from_gp(tg, 128)
    prior = (np.exp(np.asarray(logs[1], np.float64))
             * np.asarray(jnorm64.y_std) ** 2)
    rng = np.random.default_rng(0)
    x = X_MID + rng.normal(0.0, [1.5, 1.5, 0.4, 0.4], (24, 4))
    u = U_HOLD + rng.normal(0.0, 0.3, (24, 2))
    gaps, jgaps = [], []
    for z in np.concatenate([x, u], axis=1):
        _, var = online_gp.predict(post, norm,
                                   torch.tensor(z, dtype=torch.float32))
        _, ref = jonline.predict(jpost64, jnorm64, jnp.asarray(z))
        _, j32 = jonline.predict(jpost32, jnorm32,
                                 jnp.asarray(z, jnp.float32))
        gaps.append(np.abs(var.double().numpy() - np.asarray(ref)) / prior)
        jgaps.append(np.abs(np.asarray(j32, np.float64) - np.asarray(ref))
                     / prior)
    gaps, jgaps = np.array(gaps), np.array(jgaps)
    assert np.median(gaps) <= np.median(jgaps), (np.median(gaps),
                                                 np.median(jgaps))
    assert gaps.max() <= 3.0 * jgaps.max(), (gaps.max(), jgaps.max())
