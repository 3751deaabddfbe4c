"""Port parity for soft constraints (``lam_state`` softens the state
boxes, ``lam`` the user constraints and the terminal constraint), the
terminal constraint ||x_N - x_sp||^2 <= ``terminal_constraint`` and
reference trajectories ((M, Nx) in ``solve``, an (Nt+1, Nx) window in
``solve_step``): each closed loop of the port against the JAX package's at
f64 on the CPU, noise off, within 1e-6 (the ROADMAP parity rule).  The
four-tank plant with RK4 dynamics, as ``tests/test_soft_constraints.py``
runs it, cut to 6 steps at Nt=5 with an al3 x mi8 budget."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gpmpc_tpu import MPC as JMPC, Model as JModel
from gpmpc_tpu.systems import four_tank_ode as jode
from gpmpc_tpu_torch import MPC, Model
from gpmpc_tpu_torch.systems import four_tank_ode

DT = 3.0
NT, STEPS = 5, 6
X0 = np.array([8.0, 9.0, 1.0, 1.0])
X0_HIGH = np.array([30.0, 9.0, 1.0, 1.0])      # h1 above both caps
XSP = np.array([12.4, 12.7, 1.8, 1.4])
BUDGET = dict(solver_opts=dict(al_iters=3, max_iters=8),
              init_solver_opts=dict(al_iters=3, max_iters=8))
BASE = dict(Q=np.diag([10.0, 10.0, 0.1, 0.1]), R=0.01 * np.eye(2),
            ulb=[0.0, 0.0], uub=[8.0, 8.0], feedback=False, percentile=None,
            cov_updates=1, discrete_method="rk4", **BUDGET)
BOX = dict(xlb=[0.5, 0.5, 0.1, 0.1], xub=[25.0, 25.0, 8.0, 8.0])


def _h1_cap_jax(x, cov, u, par):
    return jnp.array([x[0] - par[0]])


def _h1_cap(x, cov, u, par):
    """User inequality: h1 <= par[0] (g <= 0)."""
    return (x[0] - par[0])[None]


def _pair(**kw):
    """The same controller in both packages (f64, RK4 dynamics, no GP);
    ``user=True`` adds the h1 cap with one parameter."""
    user = kw.pop("user", False)
    jm = JModel(Nx=4, Nu=2, ode=lambda x, u: jode(x, u), dt=DT,
                R=np.diag([1e-3] * 4), clip_negative=True,
                dtype=jnp.float64, integrator_substeps=10)
    tm = Model(Nx=4, Nu=2, ode=four_tank_ode, dt=DT, R=np.diag([1e-3] * 4),
               clip_negative=True, dtype=torch.float64,
               integrator_substeps=10, device="cpu")
    kw = dict(BASE, **kw)
    ju = dict(inequality_constraints=_h1_cap_jax, num_con_par=1) \
        if user else {}
    tu = dict(inequality_constraints=_h1_cap, num_con_par=1) if user else {}
    return (JMPC(horizon=NT * DT, model=jm, **kw, **ju),
            MPC(horizon=NT * DT, model=tm, device="cpu", **kw, **tu))


def _loops(jmpc, tmpc, x0, x_sp, cap=None):
    """Both closed loops, noise off; states and inputs within 1e-6 of each
    other.  Returns the port's states."""
    cp = {} if cap is None else dict(con_par_func=lambda k: np.array([cap]))
    jx, ju = jmpc.solve(jnp.asarray(x0), STEPS * DT, jnp.asarray(x_sp),
                        noise=False, **cp)
    tx, tu = tmpc.solve(x0, STEPS * DT, x_sp, noise=False, **cp)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(tmpc.last_run["iters"],
                                  jmpc.last_run["iters"])
    assert np.all(np.isfinite(tx.numpy()))
    return tx.numpy()


def test_lam_state_from_an_infeasible_start_matches_jax():
    """x0 above the state box (h1 = 30 > 25): the soft boxes' penalty
    drains h1 in both packages alike; the NLP keeps only the input rows."""
    jmpc, tmpc = _pair(lam_state=100.0, **BOX)
    assert (tmpc.problem.n_ineq, tmpc.problem.n_term_ineq) == \
        (jmpc.problem.n_ineq, jmpc.problem.n_term_ineq) == (4, 0)
    xs = _loops(jmpc, tmpc, X0_HIGH, XSP)
    assert xs[-1, 0] < xs[0, 0] - 5.0


def test_lam_with_a_user_constraint_matches_jax():
    """x0 violates the user cap h1 <= 20: with lam the cap is a penalty in
    the stage cost and leaves the AL rows (8 state and 4 input rows, no
    user row: 13 with it hard)."""
    jmpc, tmpc = _pair(lam=100.0, user=True)
    assert tmpc.problem.n_ineq == jmpc.problem.n_ineq == 12
    assert _pair(user=True)[1].problem.n_ineq == 13
    xs = _loops(jmpc, tmpc, X0_HIGH, XSP, cap=20.0)
    assert xs[-1, 0] < xs[0, 0] - 5.0


def test_soft_and_hard_agree_when_inactive():
    """Away from the bounds and below a slack cap, the soft (lam_state,
    lam) and hard loops agree within 1e-3 (as in the JAX package's own
    test), each within 1e-6 of the JAX package's."""
    hard = _loops(*_pair(user=True, **BOX), X0, XSP, cap=100.0)
    soft = _loops(*_pair(user=True, lam=1e3, lam_state=1e3, **BOX), X0, XSP,
                  cap=100.0)
    np.testing.assert_allclose(soft, hard, atol=1e-3)


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_terminal_constraint_matches_jax(soft):
    """||x_N - x_sp||^2 <= 2: a hard AL row after the state boxes (9
    terminal rows), or with lam a penalty in the terminal cost (8 rows);
    with the state boxes soft too, the terminal block is empty (0 rows)
    and the solver takes it."""
    kw = dict(terminal_constraint=2.0, **BOX)
    if soft:
        kw["lam"] = 1e3
    jmpc, tmpc = _pair(**kw)
    assert tmpc.problem.n_term_ineq == jmpc.problem.n_term_ineq == \
        (8 if soft else 9)
    _loops(jmpc, tmpc, X0, XSP)
    if soft:
        jmpc, tmpc = _pair(lam_state=1e3, **kw)
        assert tmpc.problem.n_term_ineq == jmpc.problem.n_term_ineq == 0
        _loops(jmpc, tmpc, X0, XSP)


def _ramp(m):
    return X0 + np.linspace(0.0, 1.0, m)[:, None] * (XSP - X0)


def test_reference_trajectory_matches_jax():
    """An (M, Nx) ramp from X0 to the setpoint, M = STEPS + 2: step k
    previews rows k .. k+Nt, held at the last row past the end (windows
    equal to the JAX package's), and the closed loops agree; too few rows,
    a wrong width or a 3-d reference raise in both."""
    jmpc, tmpc = _pair(**BOX)
    ref = _ramp(STEPS + 2)
    np.testing.assert_array_equal(
        tmpc._prep_ref_windows(ref, STEPS).numpy(),
        np.asarray(jmpc._prep_ref_windows(jnp.asarray(ref), STEPS)))
    _loops(jmpc, tmpc, X0, ref)
    np.testing.assert_array_equal(tmpc.last_run["x_sp"], ref[:STEPS])
    for bad, match in ((ref[:STEPS - 1], "n_steps"),
                       (ref[:, :3], "reference trajectory"),
                       (ref[None], "reference trajectory")):
        for mpc in (jmpc, tmpc):
            with pytest.raises(ValueError, match=match):
                mpc.solve(X0, STEPS * DT, bad, noise=False)


def test_reference_window_in_solve_step_matches_jax():
    """solve_step with an (Nt+1, Nx) window: a cold step and a warm step
    from its state, u0 and the predicted states within 1e-6 of the JAX
    package's; a window of another length raises in both."""
    jmpc, tmpc = _pair(**BOX)
    win = _ramp(NT + 1)
    ju, jw, _, _ = jmpc.solve_step(jnp.asarray(X0), jnp.asarray(win))
    tu, tw, _, _ = tmpc.solve_step(X0, win)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=1e-6)
    np.testing.assert_allclose(tw.x.numpy(), np.asarray(jw.x), atol=1e-6)
    x1 = np.asarray(tmpc.model.integrate(torch.tensor(X0), tu))
    ju, _, _, _ = jmpc.solve_step(jnp.asarray(x1), jnp.asarray(win),
                                  warm=jw, u_prev=ju)
    tu, _, _, _ = tmpc.solve_step(x1, win, warm=tw, u_prev=tu)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=1e-6)
    for mpc in (jmpc, tmpc):
        with pytest.raises(ValueError, match=r"\(Nt\+1, Nx\)"):
            mpc.solve_step(X0, win[:NT])
