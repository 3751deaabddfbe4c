"""Augmented-Lagrangian SQP for multiple-shooting trajectory NLPs.

Counterpart of ``gpmpc_tpu/solvers/al_sqp.py``:

* transcription: multiple shooting — decision variables are the state
  trajectory X (Nt+1, Nx) and inputs U (Nt, Nu); dynamics enter as defect
  equality constraints closed by Gauss-Newton steps.
* inequality constraints enter through a PHR augmented Lagrangian.
* each inner step linearizes the dynamics (``torch.func.jacfwd``, vmapped
  over stages), takes exact Hessians of the stage-separable AL objective
  (``torch.func.hessian``, vmapped), and solves the block-banded KKT system
  with the Riccati sweep of :mod:`gpmpc_tpu_torch.solvers.riccati`.
* globalization: backtracking line search on an L1 merit function with
  Levenberg regularization adaptation.

The JAX version's ``lax.while_loop`` with early exit becomes a fixed budget
of ``cfg.max_iters`` inner steps whose updates are masked with
``torch.where`` once the loop is done: the iterates and the iteration count
are those of the JAX loop, and no solve on the card reads a tensor value
on the host (no ``.item()``, no branch on data), so a step never waits for
the device.  On the CPU, where nothing runs ahead of the host, the loop
leaves at its first done step instead (``CPU_EARLY_EXIT``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.func import grad, hessian, jacfwd, vmap

from gpmpc_tpu_torch.solvers import riccati
from gpmpc_tpu_torch.utils.config import SQPConfig


@dataclasses.dataclass(frozen=True)
class TrajectoryProblem:
    """Static description of a trajectory NLP.

    Functions (pure torch, ``t`` a stage index — an int, or a 0-d tensor
    under ``vmap`` — and ``params`` any runtime data):

    * ``dynamics(x, u, t, params) -> x_next``
    * ``stage_cost(x, u, t, params) -> scalar``
    * ``terminal_cost(x, params) -> scalar``
    * ``stage_ineq(x, u, t, params) -> (n_ineq,)``  with convention g <= 0
    * ``terminal_ineq(x, params) -> (n_term_ineq,)``
    * ``u_guard(params) -> (lo, hi)``: optional safeguard box the line
      search projects candidate inputs into.
    """

    nx: int
    nu: int
    horizon: int
    dynamics: Callable
    stage_cost: Callable
    terminal_cost: Callable
    stage_ineq: Optional[Callable] = None
    terminal_ineq: Optional[Callable] = None
    n_ineq: int = 0
    n_term_ineq: int = 0
    u_guard: Optional[Callable] = None


class SolverState(NamedTuple):
    """Warm-startable solver state (carried across receding-horizon steps)."""

    x: torch.Tensor        # (Nt+1, Nx)
    u: torch.Tensor        # (Nt, Nu)
    lam: torch.Tensor      # (Nt, n_ineq) AL multipliers, >= 0
    lam_term: torch.Tensor  # (n_term_ineq,)


class SolveResult(NamedTuple):
    state: SolverState
    obj: torch.Tensor          # objective at solution (without AL terms)
    con_viol: torch.Tensor     # max inequality violation
    defect: torch.Tensor       # max dynamics defect
    stat: torch.Tensor         # relative KKT dual infeasibility
    iters: torch.Tensor        # inner iterations used
    converged: torch.Tensor    # defect/viol <= tol_con (rel) AND stat <= tol_kkt


def init_state(prob: TrajectoryProblem, x0: torch.Tensor,
               u_init: Optional[torch.Tensor] = None,
               params: Any = None) -> SolverState:
    """Initial guess: roll the dynamics out from x0 under u_init."""
    nt = prob.horizon
    if u_init is None:
        u_init = x0.new_zeros((nt, prob.nu))
    xs = [x0]
    for t in range(nt):
        xs.append(prob.dynamics(xs[-1], u_init[t], t, params))
    return SolverState(x=torch.stack(xs), u=u_init,
                       lam=x0.new_zeros((nt, prob.n_ineq)),
                       lam_term=x0.new_zeros((prob.n_term_ineq,)))


def shift_state(state: SolverState, x0_new: torch.Tensor) -> SolverState:
    """Receding-horizon warm start: shift the previous solution one stage."""
    x = torch.cat([x0_new[None], state.x[2:], state.x[-1:]], dim=0)
    u = torch.cat([state.u[1:], state.u[-1:]], dim=0)
    lam = torch.cat([state.lam[1:], state.lam[-1:]], dim=0)
    return SolverState(x=x, u=u, lam=lam, lam_term=state.lam_term)


def _relu(v):
    # torch.maximum, not clamp: at a tie (an inactive constraint exactly at
    # its bound, e.g. u = ulb with zero margin) it splits the derivative
    # 0.5/0.5 like jnp.maximum, so the AL Hessians match the JAX package's
    return torch.maximum(v, torch.zeros_like(v))


def _al_stage_cost(prob: TrajectoryProblem, x, u, t, params, lam_t, mu):
    """Stage cost + PHR augmented-Lagrangian penalty for g(x,u,t) <= 0."""
    c = prob.stage_cost(x, u, t, params)
    if prob.n_ineq:
        g = prob.stage_ineq(x, u, t, params)
        act = _relu(lam_t + mu * g)
        c = c + (0.5 / mu) * torch.sum(act * act - lam_t * lam_t)
    return c


def _al_term_cost(prob: TrajectoryProblem, x, params, lam_term, mu):
    c = prob.terminal_cost(x, params)
    if prob.n_term_ineq:
        g = prob.terminal_ineq(x, params)
        act = _relu(lam_term + mu * g)
        c = c + (0.5 / mu) * torch.sum(act * act - lam_term * lam_term)
    return c


def _stage_ids(prob, like):
    return torch.arange(prob.horizon, device=like.device)


def _rollout_defects(prob, state, params):
    f_next = vmap(lambda x, u, t: prob.dynamics(x, u, t, params))(
        state.x[:-1], state.u, _stage_ids(prob, state.x))
    return f_next - state.x[1:]


def _merit(prob, state, params, mu, nu_pen, w_viol=0.0):
    """L1 merit: AL objective + nu * ||defects||_1 (+ optional exact-penalty
    term ``w_viol * ||max(0, g)||_1`` on the inequality violations)."""
    ts = _stage_ids(prob, state.x)
    stage = vmap(
        lambda x, u, t, lam_t: _al_stage_cost(prob, x, u, t, params, lam_t, mu)
    )(state.x[:-1], state.u, ts, state.lam)
    term = _al_term_cost(prob, state.x[-1], params, state.lam_term, mu)
    defects = _rollout_defects(prob, state, params)
    m = torch.sum(stage) + term + nu_pen * torch.sum(torch.abs(defects))
    if w_viol and prob.n_ineq:
        g = vmap(lambda x, u, t: prob.stage_ineq(x, u, t, params))(
            state.x[:-1], state.u, ts)
        m = m + w_viol * torch.sum(torch.clamp(g, min=0.0))
    if w_viol and prob.n_term_ineq:
        gt = prob.terminal_ineq(state.x[-1], params)
        m = m + w_viol * torch.sum(torch.clamp(gt, min=0.0))
    return m, defects


#: on a CPU tensor, leave the inner loop at its first done step: the steps
#: left would be masked no-ops (the same iterate, bit for bit), and on the
#: CPU no device waits on the host.  False runs the card's masked budget on
#: the CPU too (tests hold the two equal, and the masked loop against JAX).
#: A batch of problems under ``torch.func.vmap`` (the batched study) always
#: runs the masked budget: each problem is done at its own step.
CPU_EARLY_EXIT = True


def _exit_early(done: torch.Tensor) -> bool:
    """Whether the inner loop may leave now: a plain CPU flag that is set
    (never a tensor under a ``torch.func`` transform, whose value differs
    from problem to problem)."""
    return (CPU_EARLY_EXIT and done.device.type == "cpu"
            and not torch._C._functorch.is_functorch_wrapped_tensor(done)
            and bool(done))


def _in_dtype(dtype, *ts):
    """The tensors in ``dtype``.  torch.func's forward-mode derivatives of
    a product of a 0-d slice (``x[..., 0]``) and a Python float come out in
    float64 when the primal is float32 (torch 2.13; the ODEs and the
    obstacle callback are written that way, as in the JAX package), so
    the derivatives the QP is built from are brought back to the iterate's
    dtype."""
    return [t.to(dtype) for t in ts]


def _build_qp(prob, state, params, mu, reg_state):
    """Linearize dynamics + second-order expand the AL objective per stage."""
    nx = prob.nx

    def stage_data(x, u, t, lam_t):
        a = jacfwd(lambda xx: prob.dynamics(xx, u, t, params))(x)
        b = jacfwd(lambda uu: prob.dynamics(x, uu, t, params))(u)

        def cost_xu(xu):
            return _al_stage_cost(prob, xu[:nx], xu[nx:], t, params, lam_t,
                                  mu)

        xu = torch.cat([x, u])
        return a, b, grad(cost_xu)(xu), hessian(cost_xu)(xu)

    a, b, g, hess = _in_dtype(state.x.dtype, *vmap(stage_data)(
        state.x[:-1], state.u, _stage_ids(prob, state.x), state.lam))
    defects = _rollout_defects(prob, state, params)

    eye_x = torch.eye(nx, dtype=state.x.dtype, device=state.x.device)

    def term_fn(x):
        return _al_term_cost(prob, x, params, state.lam_term, mu)

    qp = riccati.StageQP(
        a=a, b=b, c=defects,
        q_xx=hess[:, :nx, :nx] + reg_state * eye_x[None],
        q_uu=hess[:, nx:, nx:], q_xu=hess[:, :nx, nx:],
        q_x=g[:, :nx], q_u=g[:, nx:],
        qf_xx=hessian(term_fn)(state.x[-1]).to(eye_x.dtype)
        + reg_state * eye_x,
        qf_x=grad(term_fn)(state.x[-1]).to(eye_x.dtype))
    return qp, defects


def _constraint_violation(prob, state, params):
    viol = state.x.new_zeros(())
    if prob.n_ineq:
        g = vmap(lambda x, u, t: prob.stage_ineq(x, u, t, params))(
            state.x[:-1], state.u, _stage_ids(prob, state.x))
        viol = torch.maximum(viol, torch.max(torch.clamp(g, min=0.0)))
    if prob.n_term_ineq:
        gt = prob.terminal_ineq(state.x[-1], params)
        viol = torch.maximum(viol, torch.max(torch.clamp(gt, min=0.0)))
    return viol


def _kkt_stat(prob, state, params, mu):
    """Relative KKT dual infeasibility of the AL problem at ``state``: a
    costate backward pass gives the dynamics multipliers; the residual is
    the input gradient g_u = dc/du + B' p_{t+1}, scaled by the costate
    magnitude (~1 far from a solution, ~0 at one)."""
    def stage_grads(x, u, t, lam_t):
        a = jacfwd(lambda xx: prob.dynamics(xx, u, t, params))(x)
        b = jacfwd(lambda uu: prob.dynamics(x, uu, t, params))(u)
        gx = grad(
            lambda xx: _al_stage_cost(prob, xx, u, t, params, lam_t, mu))(x)
        gu = grad(
            lambda uu: _al_stage_cost(prob, x, uu, t, params, lam_t, mu))(u)
        return a, b, gx, gu

    a, b, gx, gu = _in_dtype(state.x.dtype, *vmap(stage_grads)(
        state.x[:-1], state.u, _stage_ids(prob, state.x), state.lam))
    p = grad(lambda x: _al_term_cost(prob, x, params, state.lam_term, mu))(
        state.x[-1]).to(state.x.dtype)
    p_next = [None] * prob.horizon
    for t in range(prob.horizon - 1, -1, -1):
        p_next[t] = p
        p = gx[t] + a[t].T @ p
    p_next_all = torch.stack(p_next)
    g_u = gu + torch.einsum("tij,ti->tj", b, p_next_all)
    scale = 1.0 + torch.max(torch.abs(p_next_all))
    return torch.max(torch.abs(g_u)) / scale


def _select(mask, new, old):
    return type(old)(*(torch.where(mask, n, o) for n, o in zip(new, old)))


def solve(prob: TrajectoryProblem, params: Any, init: SolverState,
          cfg: SQPConfig = SQPConfig()) -> SolveResult:
    """Solve the trajectory NLP from a warm start.

    Outer loop: ``cfg.al_iters`` AL multiplier/penalty updates.  Inner
    loop: ``cfg.max_iters`` Gauss-Newton SQP steps via the Riccati KKT
    sweep with an L1 merit line search; once a step is small or the
    regularization stalls, the remaining steps run masked (their results
    are discarded), exactly reproducing the early-exit loop.  On a CPU
    tensor the loop exits there instead while ``CPU_EARLY_EXIT``."""
    dtype, device = init.x.dtype, init.x.device
    kw = dict(dtype=dtype, device=device)
    kkt_solve = riccati.select_backend(prob.horizon, dtype,
                                       fused=cfg.fused_kkt,
                                       parallel=cfg.parallel_kkt)
    dx0 = torch.zeros(prob.nx, **kw)
    alphas = cfg.ls_beta ** torch.arange(cfg.ls_steps, **kw)

    def inner_step(state, reg, nu_p, mu):
        qp, defects = _build_qp(prob, state, params, mu, reg)
        sol = kkt_solve(qp, dx0, reg)
        # adapt the merit defect weight to dominate the costates
        nu_new = torch.maximum(nu_p, 10.0 * torch.max(torch.abs(qp.q_x)))
        merit0, _ = _merit(prob, state, params, mu, nu_new, cfg.merit_viol)

        x_c = state.x[None] + alphas[:, None, None] * sol.dx[None]
        u_c = state.u[None] + alphas[:, None, None] * sol.du[None]
        if prob.u_guard is not None:
            g_lo, g_hi = prob.u_guard(params)
            u_c = torch.clamp(u_c, g_lo, g_hi)
        merits = vmap(lambda x, u: _merit(
            prob, SolverState(x, u, state.lam, state.lam_term), params, mu,
            nu_new, cfg.merit_viol)[0])(x_c, u_c)
        merits = torch.where(torch.isnan(merits), torch.inf, merits)
        # sufficient decrease relative to predicted model decrease
        pred = torch.clamp(sol.exp_dec + nu_new * torch.sum(torch.abs(defects)),
                           min=1e-16)
        ok_dec = merits <= merit0 - cfg.ls_c1 * alphas * pred
        any_ok = torch.any(ok_dec) & sol.ok
        best = torch.argmax(ok_dec.to(torch.int32)).reshape(1)  # first True
        cand = SolverState(x=torch.index_select(x_c, 0, best)[0],
                           u=torch.index_select(u_c, 0, best)[0],
                           lam=state.lam, lam_term=state.lam_term)
        new_state = _select(any_ok, cand, state)
        reg_new = torch.where(any_ok,
                              torch.clamp(reg / cfg.reg_mult, min=cfg.reg_init),
                              torch.clamp(reg * cfg.reg_mult, max=cfg.reg_max))
        step_norm = torch.maximum(torch.max(torch.abs(sol.dx)),
                                  torch.max(torch.abs(sol.du)))
        scale = 1.0 + torch.maximum(torch.max(torch.abs(state.x)),
                                    torch.max(torch.abs(state.u)))
        small_step = step_norm <= cfg.tol_stat * scale
        stalled = (~any_ok) & (reg >= cfg.reg_max)
        return new_state, reg_new, small_step | stalled, nu_new

    state = init
    mu = torch.tensor(cfg.penalty_init, **kw)
    nu_p = torch.tensor(1e3, **kw)     # defect merit weight (adapted)
    iters = torch.zeros((), dtype=torch.int32, device=device)
    ts = _stage_ids(prob, init.x)
    for _ in range(cfg.al_iters):
        reg = torch.tensor(cfg.reg_init, **kw)
        done = torch.zeros((), dtype=torch.bool, device=device)
        for _ in range(cfg.max_iters):
            new_state, reg_n, done_n, nu_n = inner_step(state, reg, nu_p, mu)
            active = ~done
            state = _select(active, new_state, state)
            reg = torch.where(active, reg_n, reg)
            nu_p = torch.where(active, nu_n, nu_p)
            iters = iters + active.to(torch.int32)
            done = done | done_n
            if _exit_early(done):
                break

        # multiplier update: lam <- max(0, lam + mu g)
        lam_cap = 1e10  # keep multipliers finite under pathological iterates
        lam, lam_term = state.lam, state.lam_term
        if prob.n_ineq:
            g = vmap(lambda x, u, t: prob.stage_ineq(x, u, t, params))(
                state.x[:-1], state.u, ts)
            lam = torch.clamp(state.lam + mu * g, 0.0, lam_cap)
        if prob.n_term_ineq:
            gt = prob.terminal_ineq(state.x[-1], params)
            lam_term = torch.clamp(state.lam_term + mu * gt, 0.0, lam_cap)
        state = SolverState(x=state.x, u=state.u, lam=lam, lam_term=lam_term)
        mu = torch.clamp(mu * cfg.penalty_mult, max=cfg.penalty_max)

    # final diagnostics
    obj = (torch.sum(vmap(lambda x, u, t: prob.stage_cost(x, u, t, params))(
        state.x[:-1], state.u, ts))
        + prob.terminal_cost(state.x[-1], params))
    defect = torch.max(torch.abs(_rollout_defects(prob, state, params)))
    viol = _constraint_violation(prob, state, params)
    stat = _kkt_stat(prob, state, params, mu)
    scale_x = 1.0 + torch.maximum(torch.max(torch.abs(state.x)),
                                  torch.max(torch.abs(state.u)))
    converged = ((defect <= cfg.tol_con * scale_x)
                 & (viol <= cfg.tol_con * scale_x)
                 & (stat <= cfg.tol_kkt))
    return SolveResult(state=state, obj=obj, con_viol=viol, defect=defect,
                       stat=stat, iters=iters, converged=converged)
