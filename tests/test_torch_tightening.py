"""The chance-tightened f32 main path at full width (the fixture GP's 100
points, Nt=20) held against JAX x64: the GP variance that sets the chance
margins, and one cold plus one warm RTI step at a state on the closed loop.

In f32 the variance near the data is a small difference of terms of size
sf2; the explicit-inverse form sf2 - k*'K^-1 k* leaves it to rounding at
this size, and the tightened loop then chatters.  The port's Cholesky form
keeps it to ~1e-3 relative, so the f32 step matches the f64 reference."""

import numpy as np
import torch
import jax.numpy as jnp

from benchmarks.bench_spec import XSP
from gpmpc_tpu import GP as JGP
from gpmpc_tpu.models import gp_core as jcore
from gpmpc_tpu_torch.models import gp_core
from gpmpc_tpu_torch.models.convert import FIXTURE, gp_from_fixture

from test_torch_gp import OPTS
from test_torch_mpc import _jax_side, _port_side

#: a state on the four-tank closed loop, past the saturated transient
X_MID = np.array([14.01, 14.0, 2.43, 2.52])
U_HOLD = np.array([3.0, 3.0])


def test_f32_variance_matches_jax_x64():
    """Predictive variance of the f32 fixture GP at points on and around
    the main path's trajectory (honest variance 9e-6 to 1.1e-4 of sf2 ~ 1),
    against JAX x64: atol 2e-6 (f32 rounding carried by cond(L) ~ 1e2) and
    rtol 2e-2.  Measured on a CPU: at most 9.3e-7 off, median 6e-3
    relative; the explicit-inverse f32 form is off by a median factor of
    4.8 here and misses the bound at every point."""
    tgp = gp_from_fixture(dtype=torch.float32, optimizer_opts=OPTS,
                          device="cpu")
    f = np.load(FIXTURE)
    jgp = JGP(jnp.asarray(f["tank_X"], jnp.float64),
              jnp.asarray(f["tank_Y"], jnp.float64), mean_func="zero",
              hyper=jcore.GPHypers(*(jnp.asarray(f[f"tank_{k}"], jnp.float64)
                                     for k in ("log_ell", "log_sf2",
                                               "log_sn2")),
                                   mean_w=jnp.zeros((4, 0), jnp.float64)),
              optimizer_opts=OPTS)
    rng = np.random.default_rng(0)
    x = X_MID + rng.normal(0.0, [1.5, 1.5, 0.4, 0.4], (24, 4))
    u = U_HOLD + rng.normal(0.0, 0.3, (24, 2))
    for z in np.concatenate([x, u], axis=1):
        zn = (torch.tensor(z, dtype=torch.float32) - tgp.norm.z_mean) \
            / tgp.norm.z_std
        _, var_t = gp_core.predict(tgp.post, zn, tgp.cfg)
        _, var_j = jcore.predict(jgp.post, jnp.asarray(zn.double().numpy()),
                                 jgp.cfg)
        np.testing.assert_allclose(var_t.numpy(), np.asarray(var_j),
                                   rtol=2e-2, atol=2e-6)


def test_tightened_f32_step_matches_jax_x64():
    """One cold and one warm RTI solve_step with chance tightening, port
    f32 (fused KKT through the kernel's plain version) against JAX x64
    (sequential KKT: JAX refuses the fused sweep in f64), at X_MID.
    Measured on a CPU: margins' covariances within 7e-3, inputs within 4e-4
    relative, the warm trajectory within 5e-5; with the explicit-inverse
    f32 variance the covariances were off by up to 150x and u1 by 1 V."""
    rti = dict(al_iters=2, max_iters=2, ls_steps=8, penalty_init=1e3)
    cold = dict(al_iters=2, max_iters=4)
    full = dict(nt=20, n_train=100)
    jmpc = _jax_side(jnp.float64, "TA", "gp", False, solver_opts=rti,
                     init_solver_opts=cold, **full)
    tmpc = _port_side(torch.float32, "TA", "gp", False,
                      solver_opts=dict(rti, fused_kkt=True),
                      init_solver_opts=dict(cold, fused_kkt=True), **full)
    x0, xsp = jnp.asarray(X_MID), jnp.asarray(XSP)
    ju0, jwarm, jsig0, _ = jmpc.solve_step(x0, xsp,
                                           u_init=jnp.asarray(U_HOLD))
    ju1, jwarm1, jsig1, _ = jmpc.solve_step(x0, xsp, warm=jwarm, u_prev=ju0)
    tu0, twarm, tsig0, _ = tmpc.solve_step(X_MID, XSP, u_init=U_HOLD)
    tu1, twarm1, tsig1, _ = tmpc.solve_step(X_MID, XSP, warm=twarm,
                                            u_prev=tu0)

    def diag(s):
        return np.diagonal(np.asarray(s), axis1=-2, axis2=-1)[1:]

    for got, ref in ((tsig0, jsig0), (tsig1, jsig1)):
        np.testing.assert_allclose(diag(got.numpy()), diag(ref), rtol=3e-2)
    np.testing.assert_allclose(tu0.numpy(), np.asarray(ju0), rtol=2e-3)
    np.testing.assert_allclose(tu1.numpy(), np.asarray(ju1), rtol=2e-3)
    scale = float(np.abs(np.asarray(jwarm1.x)).max())
    np.testing.assert_allclose(twarm1.x.numpy(), np.asarray(jwarm1.x),
                               atol=1e-3 * scale)
