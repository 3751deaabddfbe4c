"""Moving-horizon estimation: output-feedback state estimation for GP-MPC.

Counterpart of ``gpmpc_tpu/mpc/mhe.py``: an MHE estimator reconstructs the
state from noisy, possibly partial measurements by solving a small
trajectory NLP over a sliding window with the controller's AL-SQP/Riccati
machinery (:mod:`gpmpc_tpu_torch.solvers.al_sqp`):

    min_{x, w}  ||x_{k-M} - x_bar||^2_{P^-1}                (arrival cost)
              + sum_i ||y_i - h(x_i)||^2_{R^-1}             (measurements)
              + sum_i ||w_i||^2_{Q^-1}                      (process noise)
    s.t.        x_{i+1} = f(x_i, u_i) + w_i,   xlb <= x_i <= xub

A virtual pre-stage makes it a standard :class:`TrajectoryProblem`: NLP
stage 0 holds the fixed prior ``x_bar``, its input slot carries the arrival
correction ``v_0 = x_{k-M} - x_bar`` with the arrival cost as its stage
cost, and stages t >= 1 carry the process noise ``w`` in the input slot.
The NLP's input has Nx entries, so with ``fused_kkt`` on the card its KKT
solve is K1 at (Nx, Nx).  The state bounds are AL inequalities (the
virtual stage exempt), and ``f`` is any of the controller's discrete
models ('rk4' | 'exact' | 'gp' | 'hybrid').

Two arrival-cost policies: ``arrival_update=False`` holds ``P_arrival``
fixed and takes the smoothed estimate of the next window's start state as
its prior mean; ``arrival_update=True`` propagates the prior by an EKF
recursion as each measurement leaves the window (the filtered arrival
cost of Rao & Rawlings: on linear-Gaussian problems the short-window
filter is the Kalman filter).

The JAX package jits the window solve, the filter step and the filter
loop; here they run eagerly, as ``MPC``'s do.  A filter step reads no
tensor on the host: the fill-in countdown is an int32 tensor chosen
by ``torch.where``, and the step's inverses and solves are the unrolled
Cholesky forms of :mod:`gpmpc_tpu_torch.ops.chol` (``torch.linalg``'s
check their result on the host).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch
from torch.func import jacfwd

from gpmpc_tpu_torch.models.gp import GP, mean_fn_functional
from gpmpc_tpu_torch.ops.chol import spd_inverse_small, spd_solve_small
from gpmpc_tpu_torch.solvers import al_sqp
from gpmpc_tpu_torch.utils.config import SQPConfig, resolve_solver_opts

_BIG = 1e9


def _as_cov(a, n: int, **kw) -> torch.Tensor:
    """Scalar / diag vector / full matrix -> (n, n) covariance."""
    a = torch.as_tensor(a if torch.is_tensor(a) else np.asarray(a), **kw)
    if a.ndim == 0:
        return a * torch.eye(n, **kw)
    if a.ndim == 1:
        return torch.diag(a)
    return a


def _row(a: torch.Tensor, t, hi: int) -> torch.Tensor:
    """Row clip(t, 0, hi) of ``a`` for a stage index ``t``: an int, or a
    0-d tensor under ``vmap``, gathered by ``index_select`` (an index
    computed under ``jacfwd`` there would be read on the host)."""
    if torch.is_tensor(t):
        return torch.index_select(a, 0, torch.clamp(t, 0, hi).reshape(1))[0]
    return a[min(max(t, 0), hi)]


def _at_first(t, first: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
    """``first`` at the virtual stage t = 0, ``other`` elsewhere."""
    if torch.is_tensor(t):
        return torch.where(t == 0, first, other)
    return first if t == 0 else other


class MHEConsts(NamedTuple):
    """Constant tensors the estimation NLP reads."""

    q_inv: torch.Tensor            # (Nx, Nx) process-noise information
    r_inv: torch.Tensor            # (Nm, Nm) measurement information
    p_inv: torch.Tensor            # (Nx, Nx) arrival information
    xlb: torch.Tensor              # (Nx,) estimate bounds (+-_BIG = off)
    xub: torch.Tensor
    x_scale: torch.Tensor
    bd: Optional[torch.Tensor]     # hybrid residual selector
    post: Optional[object]         # GPPosterior or None
    norm: Optional[object]         # Normalization or None


class MHEParams(NamedTuple):
    """Per-solve runtime data (one sliding window)."""

    x_bar: torch.Tensor            # (Nx,) arrival prior mean
    us: torch.Tensor               # (M, Nu) applied inputs in the window
    ys: torch.Tensor               # (M+1, Nm) measurements at window states
    p_inv: torch.Tensor            # (Nx, Nx) arrival information this window
    consts: MHEConsts


class MHEState(NamedTuple):
    """Online filtering state (carried across measurement steps)."""

    y_buf: torch.Tensor            # (M+1, Nm)
    u_buf: torch.Tensor            # (M, Nu)
    x_bar: torch.Tensor            # (Nx,) prior for the window-start state
    p: torch.Tensor                # (Nx, Nx) prior covariance (used by the
                                   # EKF recursion when arrival_update=True;
                                   # carried but constant otherwise)
    fill: torch.Tensor             # int32 scalar: remaining fill-in steps
                                   # whose departing buffer entries are
                                   # synthetic (init_filter's repeated y0),
                                   # which the EKF recursion must not use
    solver: al_sqp.SolverState     # warm start


class MHE:
    """Moving-horizon estimator over a window of ``window`` transitions.

    Same constructor surface as the JAX ``MHE``; every tensor lives on the
    model's device in its dtype (the GP must be there too).  ``h`` is a
    torch callable ``x -> y`` (default: the identity); Nm is the length of
    ``h`` at a zero state.  ``Q_noise``, ``R_meas`` and ``P_arrival`` are
    covariances (scalar/diag/full); ``P_arrival`` defaults to 10
    ``Q_noise`` and ``Q_noise`` to ``model.R``.  ``xlb``/``xub`` bound the
    estimates; ``discrete_method`` is 'rk4' | 'exact' | 'gp' | 'hybrid' as
    in the MPC; ``arrival_update`` selects the EKF-propagated arrival
    cost.  The solver budget is ``al_iters`` 3 with bounds (1 without) and
    ``max_iters`` 25, updated by ``solver_opts``; ``fused_kkt`` (K1 at
    (Nx, Nx) on the card) is f32 only."""

    def __init__(self, model, gp: Optional[GP] = None, *, window: int = 10,
                 Q_noise=None, R_meas=None, P_arrival=None,
                 h: Optional[Callable] = None,
                 xlb=None, xub=None,
                 discrete_method: str = "rk4",
                 hybrid_Bd=None,
                 arrival_update: bool = False,
                 solver_opts: Optional[Union[str, dict]] = None):
        if window < 1:
            raise ValueError("window must be >= 1")
        if R_meas is None:
            raise ValueError("R_meas (measurement-noise covariance) is "
                             "required — it sets the data weight")
        dm = discrete_method
        if dm not in ("rk4", "exact", "gp", "hybrid"):
            raise ValueError(f"unknown discrete_method {dm!r}")
        if dm in ("gp", "hybrid") and gp is None:
            raise ValueError(f"discrete_method={dm!r} requires a GP")
        if dm == "exact" and model.fused_integrator:
            raise ValueError(
                "discrete_method='exact' embeds model.integrate in the NLP "
                "and differentiates it, which the fused RK4 kernel does not "
                "support; build the Model with fused_integrator=False")

        self.model = model
        self.gp = gp
        self.M = int(window)
        self.Nx = model.Nx
        self.Nu = model.Nu
        self.discrete_method = dm
        self.dtype = dtype = model.dtype
        self.device = device = model.device
        if gp is not None and (gp.device != device or gp.dtype != dtype):
            raise ValueError(f"the GP lives on {gp.device}/{gp.dtype}, the "
                             f"model on {device}/{dtype}")
        kw = dict(dtype=dtype, device=device)

        self.h = h if h is not None else (lambda x: x)
        self.Nm = int(self.h(torch.zeros(self.Nx, **kw)).shape[0])

        q = _as_cov(Q_noise if Q_noise is not None else model.R, self.Nx,
                    **kw)
        r = _as_cov(R_meas, self.Nm, **kw)
        p = (_as_cov(P_arrival, self.Nx, **kw) if P_arrival is not None
             else 10.0 * q)
        self.arrival_update = bool(arrival_update)
        self._q_mat, self._r_mat, self._p0 = q, r, p

        xlb = (np.full(self.Nx, -_BIG) if xlb is None
               else np.asarray(xlb, np.float64))
        xub = (np.full(self.Nx, _BIG) if xub is None
               else np.asarray(xub, np.float64))
        self._has_bounds = bool(np.any(xlb > -_BIG) or np.any(xub < _BIG))
        xlb, xub = torch.as_tensor(xlb, **kw), torch.as_tensor(xub, **kw)
        x_scale = torch.where(xub - xlb < _BIG,
                              torch.clamp(xub - xlb, min=1e-6), 1.0)

        if dm == "hybrid":
            bd = (torch.as_tensor(np.asarray(hybrid_Bd), **kw)
                  if hybrid_Bd is not None else torch.eye(self.Nx, **kw))
        else:
            bd = None
        self.consts = MHEConsts(
            q_inv=torch.linalg.inv(q), r_inv=torch.linalg.inv(r),
            p_inv=torch.linalg.inv(p), xlb=xlb, xub=xub, x_scale=x_scale,
            bd=bd,
            post=gp.post if gp is not None else None,
            norm=gp.norm if gp is not None else None)
        self._gp_cfg = gp.cfg if gp is not None else None

        opts = dict(al_iters=3 if self._has_bounds else 1, max_iters=25)
        opts.update(resolve_solver_opts(solver_opts, dtype))
        self.sqp_cfg = SQPConfig(**opts)
        if dtype == torch.float64 and self.sqp_cfg.fused_kkt:
            raise ValueError("fused_kkt runs the KKT sweep in f32; "
                             "use the default Riccati path for f64 MHE")

        self._build_problem()
        self.last_converged = None

    def _t(self, v) -> torch.Tensor:
        return torch.as_tensor(v if torch.is_tensor(v) else np.asarray(v),
                               dtype=self.dtype, device=self.device)

    # ------------------------------------------------------------ dynamics

    def _mean_dynamics(self, x, u):
        dm = self.discrete_method
        if dm == "rk4":
            return self.model.rk4(x, u)
        if dm == "exact":
            return self.model.integrate(x, u)
        z = torch.cat([x, u])
        gp_mean = mean_fn_functional(self.consts.post, self.consts.norm,
                                     self._gp_cfg, z)
        if dm == "gp":
            return gp_mean
        return self.model.rk4(x, u) + self.consts.bd @ gp_mean

    # ------------------------------------------------------------ NLP spec

    def _build_problem(self):
        nx, m = self.Nx, self.M

        def dynamics(z, v, t, params: MHEParams):
            # t=0: virtual arrival stage, x_{k-M} = x_bar + v_0 (the free
            # initial state through the input slot); t>=1: model step + w
            u = _row(params.us, t - 1, m - 1)
            xn = self._mean_dynamics(z, u)
            return _at_first(t, z + v, xn + v)

        def stage_cost(z, v, t, params: MHEParams):
            c = params.consts
            w_inf = _at_first(t, params.p_inv, c.q_inv)
            cost = 0.5 * v @ w_inf @ v
            # measurement at window state x_{t-1} = z_t (none at the
            # virtual stage 0, where z is the prior mean)
            y = _row(params.ys, t - 1, m)
            resid = y - self.h(z)
            meas = 0.5 * resid @ c.r_inv @ resid
            return cost + _at_first(t, torch.zeros_like(meas), meas)

        def terminal_cost(z, params: MHEParams):
            c = params.consts
            resid = params.ys[m] - self.h(z)
            return 0.5 * resid @ c.r_inv @ resid

        stage_ineq = None
        n_ineq = 0
        if self._has_bounds:
            n_ineq = 2 * nx

            def stage_ineq(z, v, t, params: MHEParams):
                c = params.consts
                g = torch.cat([(c.xlb - z) / c.x_scale,
                               (z - c.xub) / c.x_scale])
                # the virtual stage's state is the (fixed) prior: exempt
                return _at_first(t, torch.full_like(g, -1.0), g)

        self._prob = al_sqp.TrajectoryProblem(
            nx=nx, nu=nx, horizon=m + 1,
            dynamics=dynamics, stage_cost=stage_cost,
            terminal_cost=terminal_cost,
            stage_ineq=stage_ineq, n_ineq=n_ineq)

    def _params(self, x_bar, us, ys, p_inv=None) -> MHEParams:
        return MHEParams(x_bar=x_bar, us=us, ys=ys,
                         p_inv=(self.consts.p_inv if p_inv is None
                                else p_inv),
                         consts=self.consts)

    def _solve(self, params: MHEParams, init: al_sqp.SolverState):
        return al_sqp.solve(self._prob, params, init, self.sqp_cfg)

    # ------------------------------------------------------------ one-shot

    def estimate(self, ys, us, x_bar, return_result: bool = False):
        """Smooth one window: measurements ``ys (M+1, Nm)`` at the window
        states, inputs ``us (M, Nu)`` between them, prior ``x_bar`` on the
        first state.  Returns the estimated states ``(M+1, Nx)``."""
        ys = torch.atleast_2d(self._t(ys))
        us = self._t(us).reshape(self.M, self.Nu)
        if tuple(ys.shape) != (self.M + 1, self.Nm):
            raise ValueError(f"ys must be ({self.M + 1}, {self.Nm}), "
                             f"got {tuple(ys.shape)}")
        params = self._params(self._t(x_bar), us, ys)
        init = al_sqp.init_state(self._prob, params.x_bar, params=params)
        res = self._solve(params, init)
        xs = res.state.x[1:]
        return (xs, res) if return_result else xs

    # ------------------------------------------------------------ online

    def init_filter(self, x_bar, y0) -> MHEState:
        """Start the online filter at the prior ``x_bar`` with the first
        measurement ``y0``.  The window buffers are pre-filled by repeating
        ``y0`` (zero inputs), so the first ~M estimates lean on the prior:
        the fill-in transient.  With ``arrival_update=True`` the EKF prior
        recursion starts only once the synthetic entries have left the
        window; :meth:`start_filter` skips the transient."""
        x_bar = self._t(x_bar)
        y0 = self._t(y0)
        y_buf = y0[None].repeat(self.M + 1, 1)
        u_buf = torch.zeros((self.M, self.Nu), dtype=self.dtype,
                            device=self.device)
        params = self._params(x_bar, u_buf, y_buf)
        solver = al_sqp.init_state(self._prob, x_bar, params=params)
        return MHEState(y_buf=y_buf, u_buf=u_buf, x_bar=x_bar, p=self._p0,
                        fill=torch.full((), self.M, dtype=torch.int32,
                                        device=self.device),
                        solver=solver)

    def start_filter(self, x_bar, ys, us, p=None) -> MHEState:
        """Start the online filter from a FULL recorded window instead of
        the repeated-``y0`` fill-in: ``ys (M+1, Nm)`` measurements at the
        window states, ``us (M, Nu)`` inputs between them, ``x_bar`` prior
        on the window-start state, optional prior covariance ``p``
        (default ``P_arrival``).  Solves the window once, so the stored
        prior and warm start refer to the next window and the first
        :meth:`step` has no transient."""
        x_bar = self._t(x_bar)
        y_buf = self._t(ys).reshape(self.M + 1, self.Nm)
        u_buf = self._t(us).reshape(self.M, self.Nu)
        p = self._p0 if p is None else _as_cov(p, self.Nx, dtype=self.dtype,
                                               device=self.device)
        params = self._params(x_bar, u_buf, y_buf,
                              p_inv=spd_inverse_small(p))
        init = al_sqp.init_state(self._prob, x_bar, params=params)
        res = self._solve(params, init)
        fill = torch.zeros((), dtype=torch.int32, device=self.device)
        x_bar_next, p_next = self._advance_prior(x_bar, p, res,
                                                 y_buf, u_buf, fill)
        return MHEState(y_buf=y_buf, u_buf=u_buf, x_bar=x_bar_next,
                        p=p_next, fill=fill, solver=res.state)

    def _step(self, state: MHEState, y_new, u_applied):
        """Advance one measurement step: ``u_applied`` was applied since the
        previous measurement, ``y_new`` is observed now.  Returns the new
        state and ``(x_hat, result)``, x_hat the current-state estimate."""
        y_buf = torch.cat([state.y_buf[1:], y_new[None]], dim=0)
        u_buf = torch.cat([state.u_buf[1:], u_applied[None]], dim=0)
        p_inv = spd_inverse_small(state.p) if self.arrival_update else None
        params = self._params(state.x_bar, u_buf, y_buf, p_inv=p_inv)
        warm = al_sqp.shift_state(state.solver, state.x_bar)
        res = self._solve(params, warm)
        x_bar_next, p_next = self._advance_prior(state.x_bar, state.p, res,
                                                 y_buf, u_buf, state.fill)
        new = MHEState(y_buf=y_buf, u_buf=u_buf, x_bar=x_bar_next,
                       p=p_next, fill=torch.clamp_min(state.fill - 1, 0),
                       solver=res.state)
        return new, (res.state.x[-1], res)

    def _advance_prior(self, x_bar, p, res, y_buf, u_buf, fill):
        """Prior (mean, covariance) for the NEXT window's start state, given
        this window's solve ``res`` over buffers ``(y_buf, u_buf)`` whose
        start state carried prior ``(x_bar, p)``.  ``fill`` > 0 means the
        departing buffer entry is synthetic (init_filter's repeated-y0
        transient), so the fixed-prior advance is used until the window
        holds only real data."""
        # fixed-prior policy: the smoothed estimate of the next window's
        # start state (NLP state index 2), covariance untouched
        if not self.arrival_update:
            return res.state.x[2], p
        # EKF recursion on the departing information: condition the prior
        # on this window's first measurement (the one that leaves next
        # step), then predict through the dynamics, the jacobians anchored
        # at the smoothed window start
        x_anchor = res.state.x[1]
        c_jac = jacfwd(self.h)(x_anchor).to(self.dtype)
        s = c_jac @ p @ c_jac.T + self._r_mat
        k_gain = spd_solve_small(s, c_jac @ p).T             # P C' S^-1
        x_filt = x_bar + k_gain @ (y_buf[0] - self.h(x_bar))
        p_filt = p - k_gain @ s @ k_gain.T
        u_dep = u_buf[0]                  # input window-start -> next state
        a_jac = jacfwd(lambda xx: self._mean_dynamics(xx, u_dep))(
            x_anchor).to(self.dtype)
        x_bar_next = self._mean_dynamics(x_filt, u_dep)
        p_next = a_jac @ p_filt @ a_jac.T + self._q_mat
        p_next = 0.5 * (p_next + p_next.T)
        in_fill = fill > 0
        return (torch.where(in_fill, res.state.x[2], x_bar_next),
                torch.where(in_fill, p, p_next))

    def step(self, state: MHEState, y_new, u_applied):
        """One filter step from host or device data; returns the new state
        and the current-state estimate."""
        new, (x_hat, _) = self._step(state, self._t(y_new),
                                     self._t(u_applied))
        return new, x_hat

    def run(self, x_bar, ys, us):
        """Filter a whole record: ``ys (T, Nm)`` measurements, ``us (T-1,
        Nu)`` inputs applied between them, ``x_bar`` prior on the initial
        state.  Returns estimates ``(T, Nx)`` where entry k uses the
        measurements up to and including ``y_k`` (filtering, not
        smoothing); each step's convergence flag is in
        ``last_converged``."""
        ys = self._t(ys)
        us = self._t(us)
        t_total = ys.shape[0]
        if us.shape[0] != t_total - 1:
            raise ValueError(f"us must be ({t_total - 1}, {self.Nu}), "
                             f"got {tuple(us.shape)}")
        state = self.init_filter(x_bar, ys[0])
        us_prev = torch.cat([torch.zeros((1, self.Nu), dtype=self.dtype,
                                         device=self.device), us], dim=0)
        x_hats, conv = [], []
        for k in range(t_total):
            state, (x_hat, res) = self._step(state, ys[k], us_prev[k])
            x_hats.append(x_hat)
            conv.append(res.converged)
        self.last_converged = torch.stack(conv).cpu().numpy()
        return torch.stack(x_hats)
