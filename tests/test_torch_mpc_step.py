"""Port parity for the slice, continued: one f32 solve step through the
fused paths, and the rk4-discretized closed loop (split from
test_torch_mpc.py to keep each file short)."""

import numpy as np
import torch
import jax.numpy as jnp

from test_torch_mpc import X0, XSP, _jax_side, _port_side, closed_loop_parity


def test_closed_loop_rk4_matches_jax_x64():
    closed_loop_parity("TA", "rk4")


def test_solve_step_f32_fused_matches_jax():
    """One cold solve_step in f32 with fused_kkt=True on both sides: the
    port runs the kernels' plain versions on the CPU, JAX runs the Pallas
    kernels in interpret mode.  f32 sums differ in order across jacfwd,
    line search and sweep, hence rtol 1e-3."""
    budget = dict(solver_opts=dict(al_iters=2, max_iters=2, ls_steps=8,
                                   penalty_init=1e3, fused_kkt=True),
                  init_solver_opts=dict(al_iters=2, max_iters=4,
                                        fused_kkt=True))
    jmpc = _jax_side(jnp.float32, "TA", "gp", True, **budget)
    tmpc = _port_side(torch.float32, "TA", "gp", True, **budget)
    ju0, jwarm, jsig, jinfo = jmpc.solve_step(jnp.asarray(X0, jnp.float32),
                                              jnp.asarray(XSP, jnp.float32))
    tu0, twarm, tsig, tinfo = tmpc.solve_step(X0, XSP)
    assert tu0.dtype == torch.float32
    np.testing.assert_allclose(tu0.numpy(), np.asarray(ju0), rtol=1e-3)
    np.testing.assert_allclose(twarm.x.numpy(), np.asarray(jwarm.x),
                               rtol=1e-3)
    assert int(tinfo.iters) == int(jinfo.iters)
    # a warm step from the cold solution, then the plant step
    tu1, twarm1, _, _ = tmpc.solve_step(X0, XSP, warm=twarm, u_prev=tu0)
    ju1, jwarm1, _, _ = jmpc.solve_step(jnp.asarray(X0, jnp.float32),
                                        jnp.asarray(XSP, jnp.float32),
                                        warm=jwarm, u_prev=ju0)
    np.testing.assert_allclose(tu1.numpy(), np.asarray(ju1), rtol=1e-3)
    xn_t = tmpc.model.integrate(torch.as_tensor(X0, dtype=torch.float32), tu1)
    xn_j = jmpc.model.integrate(jnp.asarray(X0, jnp.float32), ju1)
    np.testing.assert_allclose(xn_t.numpy(), np.asarray(xn_j), rtol=1e-3)
