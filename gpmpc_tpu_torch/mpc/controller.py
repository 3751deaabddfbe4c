"""Receding-horizon GP-MPC controller.

Counterpart of ``gpmpc_tpu/mpc/controller.py::MPC``: multiple-shooting NLP
over the horizon, mean + covariance propagation (ME/TA/EM/UT/GH),
chance-constraint tightening, linear state feedback, expected quadratic /
saturating costs, the delta-u penalty ``S`` and hard rate bounds
``dulb``/``duub`` (by augmenting the state with the previous input, so the
NLP stays stage-separable and the Riccati sweep still factors it), user
inequality constraints with per-solve parameters (``con_par``), soft
constraints (``lam_state`` softens the state boxes, ``lam`` the user
constraints and the terminal constraint: quadratic slack penalties in the
cost), the terminal constraint ||x_N - x_sp||^2 <= ``terminal_constraint``,
reference trajectories (an (M, Nx) reference previewed over the horizon
by ``solve``, an (Nt+1, Nx) window by ``solve_step``), the
``gp | rk4 | exact | hybrid`` discretizations, and online GP conditioning
(``online_capacity``: the closed loop conditions the GP on every observed
transition through :mod:`gpmpc_tpu_torch.parallel.online_gp`).

Covariance handling is zero-order, as in the JAX package: Sigma_t is
propagated along the current iterate between SQP passes and enters the NLP
as a per-stage parameter (tightened bounds, trace cost terms).  The JAX
``lax.scan``s (covariance passes, covariance recursion, closed loop) are
Python loops here; nothing inside a solve reads a tensor on the host.

``solve_mc`` runs a Monte-Carlo ensemble of closed loops: each control
step is one ``torch.func.vmap`` of :meth:`MPC._solve_step` over the lanes
(one K1 launch per inner SQP step and one K3 launch per sigma-point pass
for all lanes on the card), and the plant step one batched call outside
the vmap (one K2 launch; the adaptive plant's host-side stop flag).
``solve_mc(mesh=)`` shards the lanes over the ranks of a ``DeviceMesh``
(:mod:`gpmpc_tpu_torch.parallel.distributed`).
"""

from __future__ import annotations

import functools
import time
import warnings
from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch
from torch.func import jacfwd, vmap

from gpmpc_tpu_torch.models.dynamics import Model
from gpmpc_tpu_torch.models.gp import GP, mean_fn_functional
from gpmpc_tpu_torch.models.propagate import get_propagator
from gpmpc_tpu_torch.mpc import costs as cost_lib
from gpmpc_tpu_torch.parallel import distributed, online_gp
from gpmpc_tpu_torch.solvers import al_sqp, riccati
from gpmpc_tpu_torch.utils.config import (MPCOptions, SQPConfig,
                                          resolve_solver_opts)
from gpmpc_tpu_torch.utils.device import resolve_device

_BIG = 1e10


class MPCConsts(NamedTuple):
    """All tensors the NLP reads that stay fixed across solves."""

    q: torch.Tensor
    p: torch.Tensor
    r: torch.Tensor
    s: Optional[torch.Tensor]         # delta-u weight (None = no penalty)
    u_sp: torch.Tensor
    xlb: torch.Tensor
    xub: torch.Tensor
    ulb: torch.Tensor
    uub: torch.Tensor
    dulb: Optional[torch.Tensor]      # hard input-rate bounds (None = off)
    duub: Optional[torch.Tensor]
    x_scale: torch.Tensor
    u_scale: torch.Tensor
    u_guard_lo: torch.Tensor
    u_guard_hi: torch.Tensor
    k_fb: torch.Tensor
    noise_cov: torch.Tensor
    model_r: torch.Tensor
    bd: Optional[torch.Tensor]        # hybrid residual selector (Nx, Ny)
    post: Optional[object]            # GPPosterior or None
    norm: Optional[object]            # Normalization or None


class MPCParams(NamedTuple):
    """Per-solve runtime parameters + the constant tensors."""

    x0: torch.Tensor          # (Nx,) current state
    x_sp: torch.Tensor        # (Nt+1, Nx) per-stage reference window
    u_prev: torch.Tensor      # (Nu,) last applied input
    margins_x: torch.Tensor   # (Nt+1, Nx) chance tightening on state bounds
    margins_u: torch.Tensor   # (Nt, Nu) tightening on input bounds (feedback)
    sigmas: torch.Tensor      # (Nt+1, Nx, Nx) propagated covariances
    con_par: torch.Tensor     # (num_con_par,) user-constraint parameters
    consts: MPCConsts


class StepInfo(NamedTuple):
    """Per-control-step solver diagnostics."""

    obj: torch.Tensor
    defect: torch.Tensor
    con_viol: torch.Tensor
    stat: torch.Tensor        # relative KKT dual infeasibility
    iters: torch.Tensor
    converged: torch.Tensor


class MPC:
    """Uncertainty-aware receding-horizon controller.

    Same constructor surface as the JAX ``MPC`` plus ``device``.
    ``inequality_constraints(x, cov, u, par) -> (num_con,)`` returns user
    constraint values (g <= 0), ``par`` a ``num_con_par``-vector given per
    solve (``solve(con_par_func=)``, ``solve_step(con_par=)``).
    Every tensor lives on ``device`` (default: the CUDA card;
    ``device="cpu"`` for the CPU), which must be the model's and the GP's,
    in ``dtype`` (default: the model's)."""

    def __init__(self,
                 horizon: float,
                 model: Model,
                 gp: Optional[GP] = None,
                 Q=None, P=None, R=None, S=None,
                 lam: Optional[float] = None,
                 lam_state: Optional[float] = None,
                 ulb=None, uub=None, xlb=None, xub=None,
                 dulb=None, duub=None,
                 terminal_constraint: Optional[float] = None,
                 feedback: bool = True,
                 percentile: Optional[float] = None,
                 gp_method: str = "TA",
                 costFunc: Union[str, Callable] = "quad",
                 discrete_method: str = "gp",
                 hybrid_Bd=None,
                 inequality_constraints: Optional[Callable] = None,
                 num_con_par: int = 0,
                 solver_opts: Optional[Union[str, dict]] = None,
                 init_solver_opts: Optional[Union[str, dict]] = None,
                 u_sp=None,
                 op_x=None, op_u=None,
                 include_noise_cov: bool = True,
                 cov_updates: int = 2,
                 online_capacity: Optional[int] = None,
                 online_policy: str = "saturate",
                 device=None,
                 dtype=None):
        dm = discrete_method.lower()
        if dm not in ("gp", "rk4", "exact", "hybrid"):
            raise ValueError(f"unknown discrete_method {discrete_method!r}")
        if dm in ("gp", "hybrid") and gp is None:
            raise ValueError(f"discrete_method={dm!r} requires a GP")
        if dm == "exact" and model.fused_integrator:
            raise ValueError(
                "discrete_method='exact' embeds model.integrate in the NLP "
                "and differentiates it, which the fused RK4 kernel does not "
                "support; build the Model with fused_integrator=False for "
                "exact-mode MPC")

        self.model = model
        self.gp = gp
        self.dt = model.dt
        self.Nt = int(round(horizon / model.dt))
        self.Nx, self.Nu = model.Nx, model.Nu
        self.dtype = dtype = dtype or model.dtype
        self.device = device = resolve_device(device)
        if model.device != device:
            raise ValueError(f"the model lives on {model.device}, the "
                             f"controller on {device}")
        if gp is not None and (gp.device != device or gp.dtype != dtype):
            raise ValueError(f"the GP lives on {gp.device}/{gp.dtype}, the "
                             f"controller on {device}/{dtype}")
        kw = dict(dtype=dtype, device=device)

        self.discrete_method = dm
        self.gp_method = gp_method.upper()
        if gp is not None and gp.gp_method != self.gp_method:
            gp.set_method(self.gp_method)
        self._gp_cfg = gp.cfg if gp is not None else None
        self._propagator = (get_propagator(self.gp_method)
                            if gp is not None else None)
        if self._propagator is not None and self.gp_method == "GH":
            # the GP's quadrature knobs (models/propagate.py::propagate_gh)
            self._propagator = functools.partial(
                self._propagator, order=gp.gh_order, grid=gp.gh_grid)
        self.cost_func = costFunc
        if not callable(costFunc) and costFunc not in ("quad", "sat"):
            raise ValueError(f"unknown costFunc {costFunc!r}")
        self.feedback = bool(feedback)
        self.cov_updates = int(cov_updates)
        self.include_noise_cov = bool(include_noise_cov)
        # steady-state (RTI) budget for the receding loop, plus a separate
        # cold-start budget for the first solve
        self.sqp_cfg = SQPConfig(**resolve_solver_opts(solver_opts, dtype))
        self.init_sqp_cfg = (
            SQPConfig(**resolve_solver_opts(init_solver_opts, dtype))
            if init_solver_opts is not None else SQPConfig())
        if (dtype == torch.float64
                and (self.sqp_cfg.fused_kkt or self.init_sqp_cfg.fused_kkt)):
            raise ValueError(
                "fused_kkt runs the KKT sweep in f32 — it would silently "
                "degrade the x64 parity path; use the default sweep for "
                "float64 models")

        def t(v):
            return torch.as_tensor(np.asarray(v), **kw)

        def mat(m, n, default_diag):
            if m is None:
                return default_diag * torch.eye(n, **kw)
            m = t(m)
            return torch.diag(m) if m.ndim == 1 else m

        def vec(v, n, fill):
            return torch.full((n,), fill, **kw) if v is None else t(v)

        self.Q = mat(Q, self.Nx, 1.0)
        self.P = mat(P, self.Nx, 0.0) if P is not None else self.Q * 10.0
        self.R = mat(R, self.Nu, 0.01)
        self.S = mat(S, self.Nu, 0.0) if S is not None else None
        # soft constraints: a quadratic slack penalty in the cost replaces
        # the hard AL constraint group it softens; lam_state the
        # (tightened) state boxes, lam the user constraints and the
        # terminal constraint (hard AL handling without them)
        self.lam = None if lam is None else float(lam)
        self.lam_state = None if lam_state is None else float(lam_state)
        self.terminal_constraint = terminal_constraint
        # hard input-rate bounds dulb <= u_t - u_{t-1} <= duub; with them or
        # the delta-u penalty the state carries the previous input, so the
        # NLP stays stage-separable (Riccati-factorable)
        self.has_du_bounds = dulb is not None or duub is not None
        self.aug = self.S is not None or self.has_du_bounds
        if self.has_du_bounds and self.S is None:
            self.S = torch.zeros((self.Nu, self.Nu), **kw)   # no-op penalty
        self.Nxa = self.Nx + (self.Nu if self.aug else 0)
        self.ulb = vec(ulb, self.Nu, -_BIG)
        self.uub = vec(uub, self.Nu, _BIG)
        self.xlb = vec(xlb, self.Nx, -_BIG)
        self.xub = vec(xub, self.Nx, _BIG)
        self.dulb = vec(dulb, self.Nu, -_BIG) if self.has_du_bounds else None
        self.duub = vec(duub, self.Nu, _BIG) if self.has_du_bounds else None
        self.u_sp = vec(u_sp, self.Nu, 0.0)

        # quantile for chance-constraint tightening: Phi^{-1}(percentile)
        self.percentile = percentile
        self.quantile = (float(torch.special.ndtri(torch.tensor(
            percentile, dtype=torch.float64 if dtype == torch.float64
            else torch.float32))) if percentile is not None else 0.0)

        # hybrid: the GP models residuals on the dims Bd (Nx, Ny) selects
        if hybrid_Bd is not None:
            self.Bd = t(hybrid_Bd)
        elif dm == "hybrid":
            if gp.Ny != self.Nx:
                raise ValueError("hybrid without Bd requires gp.Ny == Nx")
            self.Bd = torch.eye(self.Nx, **kw)
        else:
            self.Bd = None

        # user constraints: probe once for the static constraint count
        self.user_ineq = inequality_constraints
        self.num_con_par = int(num_con_par)
        if inequality_constraints is not None:
            probe = inequality_constraints(
                torch.zeros(self.Nx, **kw), torch.zeros((self.Nx, self.Nx),
                                                        **kw),
                torch.zeros(self.Nu, **kw), torch.zeros(self.num_con_par,
                                                        **kw))
            self.num_user_con = int(probe.shape[0])
        else:
            self.num_user_con = 0

        # feedback gain from discrete LQR at the operating point; in pure-GP
        # mode from the GP mean's linearization, else from the known model's
        if self.feedback:
            ox = t(op_x) if op_x is not None else torch.zeros(self.Nx, **kw)
            ou = t(op_u) if op_u is not None else torch.zeros(self.Nu, **kw)
            if dm == "gp":
                jac = gp.linearize(torch.cat([ox, ou]))        # (Nx, Nx+Nu)
                ad, bd = jac[:, :self.Nx], jac[:, self.Nx:]
            else:
                ad, bd = model.discrete_linearize(ox, ou)
            self.K_fb, k_ok = riccati.lqr_gain(ad, bd, self.Q, self.R,
                                               return_converged=True)
            if not k_ok:
                warnings.warn("LQR Riccati iteration for the feedback gain "
                              "did not converge; check (A, B) at the "
                              "operating point", stacklevel=2)
        else:
            self.K_fb = torch.zeros((self.Nu, self.Nx), **kw)

        noise_cov = (gp.noise_cov() if (gp is not None and include_noise_cov)
                     else torch.zeros((self.Nx, self.Nx), **kw))

        # constraint scaling keeps AL penalties well-conditioned when some
        # bounds are "infinite" (large finite placeholders)
        x_scale = torch.where(self.xub - self.xlb < _BIG,
                              torch.clamp(self.xub - self.xlb, min=1e-6), 1.0)
        u_scale = torch.where(self.uub - self.ulb < _BIG,
                              torch.clamp(self.uub - self.ulb, min=1e-6), 1.0)
        pad = 0.5 * torch.where(self.uub - self.ulb < _BIG,
                                self.uub - self.ulb, _BIG)
        self.consts = MPCConsts(
            q=self.Q, p=self.P, r=self.R, s=self.S, u_sp=self.u_sp,
            xlb=self.xlb, xub=self.xub, ulb=self.ulb, uub=self.uub,
            dulb=self.dulb, duub=self.duub, x_scale=x_scale, u_scale=u_scale,
            u_guard_lo=self.ulb - pad, u_guard_hi=self.uub + pad,
            k_fb=self.K_fb, noise_cov=noise_cov, model_r=self.model.R,
            bd=self.Bd, post=gp.post if gp is not None else None,
            norm=gp.norm if gp is not None else None)

        # online (adaptive) GP: with ``online_capacity`` the closed loop
        # conditions the posterior on every observed transition; its solves
        # see it through online_gp.as_gp_posterior, whose variance is the
        # explicit-inverse form (the online posterior keeps no factor)
        self.online_capacity = online_capacity
        self.online_post = None
        if online_capacity is not None:
            if gp is None or dm not in ("gp", "hybrid"):
                raise ValueError("online_capacity requires a GP-based "
                                 "discrete_method")
            if online_policy not in ("saturate", "fifo"):
                raise ValueError("online_policy must be 'saturate' or "
                                 f"'fifo'; got {online_policy!r}")
            self.online_policy = online_policy
            self.online_post0, _ = online_gp.from_gp(gp, online_capacity)
            # hybrid: the GP models the residual Bd^+ (x+ - rk4(x, u)), so
            # an observed transition is mapped into that space
            self._bd_pinv = (torch.linalg.pinv(self.Bd) if dm == "hybrid"
                             else None)

        self.options = MPCOptions(
            gp_method=self.gp_method, discrete_method=dm,
            cost_func=self.cost_func, feedback=self.feedback,
            percentile=percentile, terminal_constraint=terminal_constraint,
            cov_updates=self.cov_updates, num_con_par=self.num_con_par,
            solver=self.sqp_cfg)
        self._build_problem()
        self._last_run = None
        self._last_mc = None

    # ------------------------------------------------------------ dynamics

    def _mean_dynamics(self, x, u, consts: MPCConsts):
        """Discrete mean dynamics per ``discrete_method``."""
        if self.discrete_method == "rk4":
            return self.model.rk4(x, u)
        if self.discrete_method == "exact":
            return self.model.integrate(x, u)
        gp_mean = mean_fn_functional(consts.post, consts.norm, self._gp_cfg,
                                     torch.cat([x, u]))
        if self.discrete_method == "gp":
            return gp_mean
        # hybrid: known model + GP residual correction
        return self.model.rk4(x, u) + consts.bd @ gp_mean

    def _cov_step(self, x, u, sigma, consts: MPCConsts):
        """One-step covariance propagation (zero-order pass), with the
        feedback cross-terms Sigma_u = K Sigma K' in the joint input
        covariance.  ME carries no covariance."""
        k = consts.k_fb
        sk = sigma @ k.T                                  # delta-u = -K delta-x
        sigma_z = torch.cat([torch.cat([sigma, -sk], dim=1),
                             torch.cat([-sk.T, k @ sigma @ k.T], dim=1)])
        if self.discrete_method in ("rk4", "exact"):
            f = (self.model.rk4 if self.discrete_method == "rk4"
                 else self.model.integrate)
            jx = jacfwd(lambda xx: f(xx, u))(x)
            ju = jacfwd(lambda uu: f(x, uu))(u)
            # in x's dtype: see Model.discrete_linearize
            j = torch.cat([jx, ju], dim=1).to(x.dtype)      # (Nx, Nx+Nu)
            sig_n = j @ sigma_z @ j.T + consts.model_r
            return 0.5 * (sig_n + sig_n.T)
        z = torch.cat([x, u])
        if self.discrete_method == "gp":
            if self.gp_method == "ME":
                return torch.zeros_like(sigma)
            _, sig_y, _ = self._propagator(consts.post, consts.norm,
                                           self._gp_cfg, z, sigma_z)
            sig_n = sig_y + consts.noise_cov
            return 0.5 * (sig_n + sig_n.T)
        # hybrid: linearized known part + GP residual part + cross terms
        jx, ju = self.model.discrete_linearize(x, u)
        j = torch.cat([jx, ju], dim=1)
        _, sig_y, c_zy = self._propagator(consts.post, consts.norm,
                                          self._gp_cfg, z, sigma_z)
        bd = consts.bd
        cross = j @ c_zy @ bd.T
        sig_n = (j @ sigma_z @ j.T + bd @ sig_y @ bd.T
                 + cross + cross.T + consts.noise_cov)
        return 0.5 * (sig_n + sig_n.T)

    def propagate_covariances(self, xs, us, sigma0, consts: MPCConsts):
        """Sigma_t along a nominal trajectory -> (Nt+1, Nx, Nx)."""
        sigmas = [sigma0]
        for t in range(self.Nt):
            sigmas.append(self._cov_step(xs[t, :self.Nx], us[t], sigmas[-1],
                                         consts))
        return torch.stack(sigmas)

    # ------------------------------------------------------------ NLP spec

    def _stage_cost_value(self, x, sig, x_ref, w):
        if self.cost_func == "quad":
            return cost_lib.expected_quadratic(x, sig, x_ref, w)
        if self.cost_func == "sat":
            return cost_lib.expected_saturating(x, sig, x_ref, w)
        return self.cost_func(x, sig, x_ref, w)

    def _split(self, xa):
        """Augmented state -> (physical state, previous input)."""
        if self.aug:
            return xa[:self.Nx], xa[self.Nx:]
        return xa, None

    def _build_problem(self):
        nx, nu, nt = self.Nx, self.Nu, self.Nt
        hard_state = self.lam_state is None  # soft: a penalty in the cost
        hard_user = self.lam is None         # lam softens general constraints
        hard_term = hard_user and self.terminal_constraint is not None

        def state_box(x, mx, c0):
            return [(x - (c0.xub - mx)) / c0.x_scale,
                    ((c0.xlb + mx) - x) / c0.x_scale]

        def state_penalty(x, mx, c0):
            """lam_state times the squared scaled violation of the
            (tightened) state box."""
            viol = (torch.clamp(x - (c0.xub - mx), min=0.0)
                    + torch.clamp((c0.xlb + mx) - x, min=0.0)) / c0.x_scale
            return self.lam_state * torch.sum(viol * viol)

        def dynamics(xa, u, t, params: MPCParams):
            x, _ = self._split(xa)
            xn = self._mean_dynamics(x, u, params.consts)
            return torch.cat([xn, u]) if self.aug else xn

        def stage_cost(xa, u, t, params: MPCParams):
            c0 = params.consts
            x, u_prev = self._split(xa)
            c = self._stage_cost_value(x, params.sigmas[t], params.x_sp[t],
                                       c0.q)
            du_sp = u - c0.u_sp
            c = c + du_sp @ c0.r @ du_sp
            if self.aug:
                dd = u - u_prev
                c = c + dd @ c0.s @ dd
            if not hard_state:
                c = c + state_penalty(x, params.margins_x[t], c0)
            if not hard_user and self.user_ineq is not None:
                g = self.user_ineq(x, params.sigmas[t], u, params.con_par)
                viol = torch.clamp(g, min=0.0)
                c = c + self.lam * torch.sum(viol * viol)
            return c

        def terminal_cost(xa, params: MPCParams):
            c0 = params.consts
            x, _ = self._split(xa)
            c = self._stage_cost_value(x, params.sigmas[nt], params.x_sp[nt],
                                       c0.p)
            if not hard_state:
                c = c + state_penalty(x, params.margins_x[nt], c0)
            if not hard_user and self.terminal_constraint is not None:
                e = x - params.x_sp[nt]
                viol = torch.clamp(e @ e - self.terminal_constraint, min=0.0)
                c = c + self.lam * viol * viol
            return c

        def stage_ineq(xa, u, t, params: MPCParams):
            c0 = params.consts
            x, u_prev = self._split(xa)
            mu_m = params.margins_u[t]
            g = state_box(x, params.margins_x[t], c0) if hard_state else []
            g += [(u - (c0.uub - mu_m)) / c0.u_scale,
                  ((c0.ulb + mu_m) - u) / c0.u_scale]
            if self.has_du_bounds:
                # hard rate bounds on du = u_t - u_{t-1}, untightened (the
                # rate is commanded, not stochastic)
                du = u - u_prev
                g += [(du - c0.duub) / c0.u_scale,
                      (c0.dulb - du) / c0.u_scale]
            if hard_user and self.user_ineq is not None:
                g.append(self.user_ineq(x, params.sigmas[t], u,
                                        params.con_par))
            return torch.cat(g)

        def terminal_ineq(xa, params: MPCParams):
            x, _ = self._split(xa)
            g = (state_box(x, params.margins_x[nt], params.consts)
                 if hard_state else [])
            if hard_term:
                # ||x_N - x_sp||^2 <= terminal_constraint
                e = x - params.x_sp[nt]
                g.append((e @ e - self.terminal_constraint)[None])
            if not g:
                return xa.new_zeros((0,))
            return torch.cat(g)

        n_state_con = 2 * nx if hard_state else 0
        n_du_con = 2 * nu if self.has_du_bounds else 0
        n_user_con = self.num_user_con if hard_user else 0
        self.problem = al_sqp.TrajectoryProblem(
            nx=self.Nxa, nu=nu, horizon=nt,
            dynamics=dynamics, stage_cost=stage_cost,
            terminal_cost=terminal_cost,
            stage_ineq=stage_ineq, terminal_ineq=terminal_ineq,
            n_ineq=n_state_con + 2 * nu + n_du_con + n_user_con,
            n_term_ineq=n_state_con + int(hard_term),
            u_guard=lambda p: (p.consts.u_guard_lo, p.consts.u_guard_hi))

    def _margins(self, sigmas, consts: MPCConsts):
        """Chance tightening: Phi^{-1}(p) * sqrt(diag Sigma_t), clamped so
        tightened boxes cannot cross."""
        if self.percentile is None:
            return (sigmas.new_zeros((self.Nt + 1, self.Nx)),
                    sigmas.new_zeros((self.Nt, self.Nu)))
        diag = torch.diagonal(sigmas, dim1=-2, dim2=-1)
        mx = self.quantile * torch.sqrt(torch.clamp(diag, min=0.0))
        box = consts.xub - consts.xlb
        mx = torch.minimum(mx, 0.49 * torch.where(box < _BIG, box, _BIG))
        # input tightening from Sigma_u = K Sigma K' (feedback only)
        k = consts.k_fb
        sig_u = k @ sigmas[:-1] @ k.T
        du = torch.sqrt(torch.clamp(torch.diagonal(sig_u, dim1=-2, dim2=-1),
                                    min=0.0))
        mu_m = self.quantile * du
        ubox = consts.uub - consts.ulb
        mu_m = torch.minimum(mu_m, 0.49 * torch.where(ubox < _BIG, ubox, _BIG))
        return mx, mu_m

    # ------------------------------------------------------------ solving

    def _tensor(self, v):
        return torch.as_tensor(v if torch.is_tensor(v) else np.asarray(v),
                               dtype=self.dtype, device=self.device)

    def _ref_window(self, x_sp):
        """A reference as the (Nt+1, Nx) per-stage window the NLP reads: a
        setpoint (Nx,) is broadcast; an (Nt+1, Nx) window (preview over
        the horizon) passes through."""
        x_sp = self._tensor(x_sp)
        if x_sp.ndim == 1 and x_sp.shape[0] == self.Nx:
            return x_sp[None, :].expand(self.Nt + 1, self.Nx)
        if tuple(x_sp.shape) != (self.Nt + 1, self.Nx):
            raise ValueError(
                f"x_sp must be (Nx,) or (Nt+1, Nx)=({self.Nt + 1}, "
                f"{self.Nx}); got {tuple(x_sp.shape)}")
        return x_sp

    def _augment_x0(self, x0, u_prev):
        return torch.cat([x0, u_prev]) if self.aug else x0

    def _solve_step(self, warm: al_sqp.SolverState, x0, x_sp, u_prev,
                    sigma0, con_par, consts: MPCConsts, cfg=None):
        """One MPC solve: zero-order covariance refresh passes around the
        AL-SQP, each refreshing Sigma from the previous pass's solution."""
        cfg = cfg if cfg is not None else self.sqp_cfg
        state = al_sqp.shift_state(warm, self._augment_x0(x0, u_prev))
        for _ in range(max(self.cov_updates, 1)):
            sigmas = self.propagate_covariances(state.x, state.u, sigma0,
                                                consts)
            mx, mu_m = self._margins(sigmas, consts)
            params = MPCParams(x0=x0, x_sp=x_sp, u_prev=u_prev, margins_x=mx,
                               margins_u=mu_m, sigmas=sigmas,
                               con_par=con_par, consts=consts)
            result = al_sqp.solve(self.problem, params, state, cfg)
            state = result.state
        info = StepInfo(obj=result.obj, defect=result.defect,
                        con_viol=result.con_viol, stat=result.stat,
                        iters=result.iters, converged=result.converged)
        return state, state.u[0], sigmas, info

    def _init_warm(self, x0a, x_sp, u_init=None):
        zeros = torch.zeros
        kw = dict(dtype=self.dtype, device=self.device)
        params = MPCParams(
            x0=x0a[:self.Nx], x_sp=x_sp, u_prev=zeros(self.Nu, **kw),
            margins_x=zeros((self.Nt + 1, self.Nx), **kw),
            margins_u=zeros((self.Nt, self.Nu), **kw),
            sigmas=zeros((self.Nt + 1, self.Nx, self.Nx), **kw),
            con_par=zeros(self.num_con_par, **kw), consts=self.consts)
        return al_sqp.init_state(self.problem, x0a, params=params,
                                 u_init=u_init)

    def solve_step(self, x0, x_sp, warm=None, u_prev=None, sigma0=None,
                   con_par=None, u_init=None):
        """Single receding-horizon step; returns ``(u0, warm_state, sigmas,
        info)`` for driving a real plant externally.  A cold start
        (``warm=None``) uses the cold-start budget and ``u_init`` ((Nu,) or
        (Nt, Nu)) to seed its rollout.  ``con_par`` ((num_con_par,)) are
        this solve's user-constraint parameters (zeros when None)."""
        x0 = self._tensor(x0)
        x_sp = self._ref_window(x_sp)
        if u_prev is None:
            u_prev = torch.zeros(self.Nu, dtype=self.dtype, device=self.device)
        cold = warm is None
        if cold:
            if u_init is not None:
                u_init = self._tensor(u_init)
                if u_init.ndim == 1:
                    u_init = u_init[None].expand(self.Nt, self.Nu)
            warm = self._init_warm(self._augment_x0(x0, u_prev), x_sp,
                                   u_init=u_init)
        if sigma0 is None:
            sigma0 = torch.zeros((self.Nx, self.Nx), dtype=self.dtype,
                                 device=self.device)
        con_par = (self._tensor(con_par) if con_par is not None else
                   torch.zeros(self.num_con_par, dtype=self.dtype,
                               device=self.device))
        state, u0, sigmas, info = self._solve_step(
            warm, x0, x_sp, u_prev, sigma0, con_par, self.consts,
            cfg=self.init_sqp_cfg if cold else None)
        # saturate to the hard box (and rate window) like the internal
        # closed loop does
        u0 = self._saturate(u0, u_prev, self.consts)
        return u0, state, sigmas, info

    def _saturate(self, u, u_prev, consts: MPCConsts):
        """The input the plant can receive: inside the hard box and, with
        rate bounds, the rate window around ``u_prev``, whatever the
        solver's residual violation."""
        u = torch.clamp(u, consts.ulb, consts.uub)
        if self.has_du_bounds:
            u = torch.clamp(u, u_prev + consts.dulb, u_prev + consts.duub)
        return u

    # ------------------------------------------------------------ closed loop

    def _closed_loop(self, x0, ref_windows, u0_guess, con_pars, noise_w,
                     consts, n_steps, noise, opost=None):
        """The receding-horizon loop: solve, apply u0* to the plant, shift,
        repeat.  ``ref_windows`` is (n_steps, Nt+1, Nx), ``con_pars``
        (n_steps, num_con_par).  With an online posterior ``opost`` each
        solve reads it and each observed transition conditions it; returns
        it last."""
        kw = dict(dtype=self.dtype, device=self.device)
        u_prev = torch.zeros(self.Nu, **kw)
        warm = self._init_warm(self._augment_x0(x0, u_prev), ref_windows[0],
                               u0_guess)
        sigma0 = torch.zeros((self.Nx, self.Nx), **kw)
        # cold-start preparation: one full-budget solve preconditions the
        # warm state so the in-loop (possibly RTI-grade) budget only tracks
        if self.init_sqp_cfg != self.sqp_cfg:
            con_par0 = (con_pars[0] if con_pars.shape[0] else
                        torch.zeros(self.num_con_par, **kw))
            warm = self._solve_step(warm, x0, ref_windows[0], u_prev, sigma0,
                                    con_par0, consts,
                                    cfg=self.init_sqp_cfg)[0]
        x = x0
        xs, us, sig1s, infos = [], [], [], []
        for k in range(n_steps):
            consts_k = (consts if opost is None else consts._replace(
                post=online_gp.as_gp_posterior(opost)))
            warm, u_cmd, sigmas, info = self._solve_step(
                warm, x, ref_windows[k], u_prev, sigma0, con_pars[k],
                consts_k)
            # physical actuator saturation (box and rate window)
            u_cmd = self._saturate(u_cmd, u_prev, consts)
            x_next = self.model.integrate(x, u_cmd)
            if noise:
                x_next = x_next + noise_w[k]
            if self.model.clip_negative:
                x_next = torch.clamp(x_next, min=0.0)
            if opost is not None:
                # condition on the transition observed (noise included), in
                # the GP's own space: the raw next state in gp mode, the
                # model residual through Bd in hybrid mode
                y_obs = (self._bd_pinv @ (x_next - self.model.rk4(x, u_cmd))
                         if self._bd_pinv is not None else x_next)
                opost = online_gp.condition(
                    opost, consts.norm, torch.cat([x, u_cmd]), y_obs,
                    kernel=self._gp_cfg.kernel, policy=self.online_policy,
                    mean_func=self._gp_cfg.mean_func)
            xs.append(x)
            us.append(u_cmd)
            sig1s.append(sigmas[1, :self.Nx, :self.Nx])
            infos.append(info)
            x, u_prev = x_next, u_cmd
        xs.append(x)
        info = StepInfo(*(torch.stack(v) for v in zip(*infos)))
        return (torch.stack(xs), torch.stack(us), torch.stack(sig1s), info,
                opost)

    def _prep_ref_windows(self, x_sp, n_steps):
        """A setpoint (Nx,) or a reference trajectory (M, Nx), M >=
        n_steps, as per-step preview windows (n_steps, Nt+1, Nx): step k
        previews rows k .. k+Nt, held at the last row past the end."""
        x_sp = self._tensor(x_sp)
        if x_sp.ndim == 1:
            if x_sp.shape[0] != self.Nx:
                raise ValueError(f"x_sp must be (Nx,)=({self.Nx},) or (M, "
                                 f"Nx); got {tuple(x_sp.shape)}")
            return x_sp[None, None, :].expand(n_steps, self.Nt + 1, self.Nx)
        if x_sp.ndim != 2 or x_sp.shape[1] != self.Nx:
            raise ValueError(
                f"reference trajectory must be (M, Nx={self.Nx}); "
                f"got {tuple(x_sp.shape)}")
        if x_sp.shape[0] < n_steps:
            raise ValueError(
                f"reference trajectory needs >= n_steps={n_steps} rows; "
                f"got {tuple(x_sp.shape)}")
        idx = torch.clamp(torch.arange(n_steps)[:, None]
                          + torch.arange(self.Nt + 1)[None, :],
                          max=x_sp.shape[0] - 1).to(x_sp.device)
        return x_sp[idx]                            # (n_steps, Nt+1, Nx)

    def _prep_con_pars(self, con_par_func, n_steps):
        """Per-step user-constraint parameters (n_steps, num_con_par),
        gathered on the host from ``con_par_func(k)`` before the loop."""
        if con_par_func is not None:
            con_pars = np.stack([np.asarray(con_par_func(k), dtype=np.float64)
                                 for k in range(n_steps)])
            return self._tensor(con_pars).reshape(n_steps, self.num_con_par)
        return torch.zeros((n_steps, self.num_con_par), dtype=self.dtype,
                           device=self.device)

    def _noise_chol(self):
        return torch.linalg.cholesky(
            self.model.R + 1e-32 * torch.eye(self.Nx, dtype=self.dtype,
                                             device=self.device))

    def _plant(self, x, u):
        """The plant step of every lane at once: x (L, Nx), u (L, Nu).  The
        fused RK4 chain (one K2 launch, which maps the ODE over the lanes,
        as its plain version does on the CPU) and the adaptive integrator
        (its per-lane masks and host-side stop flag) take the batch as it
        is; the unfused RK4 chain is mapped over the lanes, so an ODE
        written for one state serves in each case."""
        if self.model.fused_integrator or self.model.integrator == "adaptive":
            return self.model.integrate(x, u)
        return vmap(self.model.integrate)(x, u)

    def _mc_loop(self, x0s, ref_windows, u0_guess, con_pars, noise_ws,
                 consts, opost, n_steps):
        """The Monte-Carlo ensemble: the closed loop of :meth:`_closed_loop`
        (with noise) for every lane, one vmapped solve and one batched
        plant step a control step.  ``opost`` (the online posterior) goes
        in shared and comes back batched: each lane conditions its own
        copy.  Returns ``(xs (L, M+1, Nx), us (L, M, Nu), sig1s (L, M, Nx,
        Nx), StepInfo of (L, M), opost)``."""
        kw = dict(dtype=self.dtype, device=self.device)
        n_mc = x0s.shape[0]
        u_start = torch.zeros(self.Nu, **kw)
        sigma0 = torch.zeros((self.Nx, self.Nx), **kw)
        warm = vmap(lambda x0: self._init_warm(
            self._augment_x0(x0, u_start), ref_windows[0], u0_guess))(x0s)
        if self.init_sqp_cfg != self.sqp_cfg:
            con_par0 = (con_pars[0] if con_pars.shape[0] else
                        torch.zeros(self.num_con_par, **kw))
            warm = vmap(lambda w, x0: self._solve_step(
                w, x0, ref_windows[0], u_start, sigma0, con_par0, consts,
                cfg=self.init_sqp_cfg)[0])(warm, x0s)

        def solve(warm, x, u_prev, x_sp, con_par, post=None):
            consts_k = (consts if post is None else consts._replace(
                post=online_gp.as_gp_posterior(post)))
            warm, u_cmd, sigmas, info = self._solve_step(
                warm, x, x_sp, u_prev, sigma0, con_par, consts_k)
            u_cmd = self._saturate(u_cmd, u_prev, consts)
            return warm, u_cmd, sigmas[1, :self.Nx, :self.Nx], info

        def observe(post, x, u, x_next):
            y_obs = (self._bd_pinv @ (x_next - self.model.rk4(x, u))
                     if self._bd_pinv is not None else x_next)
            return online_gp.condition(
                post, consts.norm, torch.cat([x, u]), y_obs,
                kernel=self._gp_cfg.kernel, policy=self.online_policy,
                mean_func=self._gp_cfg.mean_func)

        x = x0s
        u_prev = u_start[None].expand(n_mc, self.Nu)
        pdim = None
        xs, us, sig1s, infos = [], [], [], []
        for k in range(n_steps):
            if opost is None:
                warm, u_cmd, sig1, info = vmap(
                    solve, in_dims=(0, 0, 0, None, None))(
                    warm, x, u_prev, ref_windows[k], con_pars[k])
            else:
                warm, u_cmd, sig1, info = vmap(
                    solve, in_dims=(0, 0, 0, None, None, pdim))(
                    warm, x, u_prev, ref_windows[k], con_pars[k], opost)
            x_next = self._plant(x, u_cmd) + noise_ws[:, k]
            if self.model.clip_negative:
                x_next = torch.clamp(x_next, min=0.0)
            if opost is not None:
                opost = vmap(observe, in_dims=(pdim, 0, 0, 0))(
                    opost, x, u_cmd, x_next)
                pdim = 0
            xs.append(x)
            us.append(u_cmd)
            sig1s.append(sig1)
            infos.append(info)
            x, u_prev = x_next, u_cmd
        xs.append(x)
        info = StepInfo(*(torch.stack(v, dim=1) for v in zip(*infos)))
        return (torch.stack(xs, dim=1), torch.stack(us, dim=1),
                torch.stack(sig1s, dim=1), info, opost)

    def solve_mc(self, x0, sim_time, x_sp, n_mc: int, u0=None,
                 con_par_func: Optional[Callable] = None,
                 generator: Optional[torch.Generator] = None,
                 noise_ws=None, mesh=None):
        """Monte-Carlo ensemble of closed loops: ``n_mc`` process-noise
        realizations of the same receding-horizon simulation, run as one
        batch of lanes.

        ``x0`` is one (Nx,) initial state shared by every lane or a batch
        (n_mc, Nx).  The noise is ``noise_ws`` (n_mc, n_steps, Nx) when
        given, else normals drawn from ``generator`` (default: a generator
        on the controller's device seeded with 0) times the Cholesky
        factor of ``model.R``, as :meth:`solve` draws one lane's.  Returns
        ``(x_sim (n_mc, M+1, Nx), u_sim (n_mc, M, Nu))``; per-lane
        diagnostics are in ``last_mc``.  Its main consumer is the chance
        calibration audit (:mod:`gpmpc_tpu_torch.utils.calibration`).

        ``mesh`` (a ``DeviceMesh`` of the controller's device type) shards
        the lanes over its ranks, as the JAX package shards them over a
        mesh's devices: ``n_mc`` must divide by ``mesh.size()``; each rank
        runs its contiguous lanes of ``x0`` and of the noise (drawn in full
        on every rank, then sliced, so lane i sees the local run's noise),
        with per-lane online posteriors of its own when
        ``online_capacity`` is set; the reference windows, ``con_par``s and
        ``u0`` are replicated; every rank returns the gathered lanes and
        holds them in ``last_mc``."""
        if mesh is not None:
            distributed.check_mesh(mesh, self.device)
        n_steps = int(round(sim_time / self.dt))
        x0 = self._tensor(x0)
        if (x0.ndim == 1 and tuple(x0.shape) != (self.Nx,)) or x0.ndim > 2 \
                or (x0.ndim == 2 and tuple(x0.shape) != (n_mc, self.Nx)):
            raise ValueError(f"x0 must be ({self.Nx},) or ({n_mc}, "
                             f"{self.Nx}); got {tuple(x0.shape)}")
        x0s = x0[None].expand(n_mc, self.Nx) if x0.ndim == 1 else x0
        ref_windows = self._prep_ref_windows(x_sp, n_steps)
        u0_guess = (self._tensor(u0)[None].expand(self.Nt, self.Nu)
                    if u0 is not None else None)
        con_pars = self._prep_con_pars(con_par_func, n_steps)
        if noise_ws is None:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            eps = torch.randn((n_mc, n_steps, self.Nx), generator=generator,
                              dtype=self.dtype, device=self.device)
            noise_ws = eps @ self._noise_chol().T
        else:
            noise_ws = self._tensor(noise_ws)
            if tuple(noise_ws.shape) != (n_mc, n_steps, self.Nx):
                raise ValueError(f"noise_ws must be (n_mc, n_steps, Nx) = "
                                 f"{(n_mc, n_steps, self.Nx)}; got "
                                 f"{tuple(noise_ws.shape)}")
        opost = (self.online_post0 if self.online_capacity is not None
                 else None)
        if mesh is not None:
            x0s, noise_ws = (distributed.local_block(a, mesh)
                             for a in (x0s, noise_ws))
        xs, us, sig1s, infos, _ = self._mc_loop(
            x0s, ref_windows, u0_guess, con_pars, noise_ws, self.consts,
            opost, n_steps)
        converged = infos.converged
        if mesh is not None:
            xs, us, sig1s, converged = (distributed.gather(a, mesh) for a in
                                        (xs, us, sig1s, converged))
        self._last_mc = {
            "x_sim": xs.cpu().numpy(), "u_sim": us.cpu().numpy(),
            "sigmas": sig1s.cpu().numpy(),
            "converged": converged.cpu().numpy(),
            "x_sp": ref_windows[:, 0, :].cpu().numpy(),
        }
        return xs, us

    @property
    def last_mc(self):
        return self._last_mc

    def solve(self, x0, sim_time, x_sp, u0=None, noise: bool = True,
              noise_w=None, generator: Optional[torch.Generator] = None,
              con_par_func: Optional[Callable] = None):
        """Closed-loop receding-horizon simulation.

        ``x_sp`` is a fixed setpoint (Nx,) or a reference trajectory (M,
        Nx) with M >= the number of steps: step k's solve previews rows
        k .. k+Nt (held at the last row past the end).  ``con_par_func(k)``
        gives step
        k's user-constraint parameters (num_con_par,).  With
        ``noise=True`` the plant gets additive process noise ~ N(0,
        model.R): ``noise_w`` (n_steps, Nx) when given, else drawn from
        ``generator`` (default: a generator on the controller's device
        seeded with 0).  Returns ``(x_sim (M+1, Nx),
        u_sim (M, Nu))``; diagnostics are in ``last_run``."""
        n_steps = int(round(sim_time / self.dt))
        x0 = self._tensor(x0)
        ref_windows = self._prep_ref_windows(x_sp, n_steps)
        u0_guess = (self._tensor(u0)[None].expand(self.Nt, self.Nu)
                    if u0 is not None else None)
        con_pars = self._prep_con_pars(con_par_func, n_steps)
        if noise and noise_w is None:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            eps = torch.randn((n_steps, self.Nx), generator=generator,
                              dtype=self.dtype, device=self.device)
            noise_w = eps @ self._noise_chol().T
        elif noise:
            noise_w = self._tensor(noise_w)

        opost = (self.online_post0 if self.online_capacity is not None
                 else None)
        t_start = time.perf_counter()
        xs, us, sig1s, infos, opost = self._closed_loop(
            x0, ref_windows, u0_guess, con_pars, noise_w, self.consts,
            n_steps, noise, opost)
        x_sim = xs.cpu().numpy()                      # waits for the device
        wall = time.perf_counter() - t_start
        self.online_post = opost
        self._last_run = {
            "x_sim": x_sim, "u_sim": us.cpu().numpy(),
            "sigmas": sig1s.cpu().numpy(),
            **{k: v.cpu().numpy() for k, v in infos._asdict().items()},
            "x_sp": ref_windows[:, 0, :].cpu().numpy(),
            "wall_time_total": wall,
            "wall_time_per_step": wall / max(n_steps, 1),
            "gp_points": (int(opost.count) if opost is not None else None),
        }
        return xs, us

    @property
    def last_run(self):
        return self._last_run

    def plot(self, filename: Optional[str] = None, show: bool = False):
        """The last :meth:`solve`'s closed-loop states and inputs with their
        bounds, the reference and +/-2 sigma bands of the one-step
        predicted covariance, drawn from ``last_run``; saved to
        ``filename`` when given, shown with ``show``.  Returns the (closed)
        figure.  Raises :class:`~gpmpc_tpu_torch.utils.plotting.
        MatplotlibMissing` without matplotlib."""
        if self._last_run is None:
            raise RuntimeError("nothing to plot — call solve() first")
        from gpmpc_tpu_torch.utils.plotting import pyplot
        plt = pyplot()
        r = self._last_run
        xs, us, sig = r["x_sim"], r["u_sim"], r["sigmas"]
        xlb, xub, ulb, uub = (v.cpu().numpy() for v in
                              (self.xlb, self.xub, self.ulb, self.uub))
        t_x = np.arange(xs.shape[0]) * self.dt
        t_u = np.arange(us.shape[0]) * self.dt
        fig, axes = plt.subplots(self.Nx + self.Nu, 1, sharex=True,
                                 figsize=(8, 2.2 * (self.Nx + self.Nu)))
        axes = np.atleast_1d(axes)
        for i in range(self.Nx):
            ax = axes[i]
            ax.plot(t_x, xs[:, i], label=f"x{i}")
            std = np.sqrt(np.maximum(sig[:, i, i], 0.0))
            ax.fill_between(t_u + self.dt, xs[1:, i] - 2 * std,
                            xs[1:, i] + 2 * std, alpha=0.2,
                            label="±2σ (predicted)")
            if xub[i] < _BIG:
                ax.axhline(xub[i], ls="--", c="r", lw=0.8)
            if xlb[i] > -_BIG:
                ax.axhline(xlb[i], ls="--", c="r", lw=0.8)
            ax.plot(t_u, r["x_sp"][:, i], ls=":", c="g", lw=0.9,
                    label="reference")
            ax.legend(loc="best", fontsize=7)
        for j in range(self.Nu):
            ax = axes[self.Nx + j]
            ax.step(t_u, us[:, j], where="post", label=f"u{j}")
            if uub[j] < _BIG:
                ax.axhline(uub[j], ls="--", c="r", lw=0.8)
            if ulb[j] > -_BIG:
                ax.axhline(ulb[j], ls="--", c="r", lw=0.8)
            ax.legend(loc="best", fontsize=7)
        axes[-1].set_xlabel("time [s]")
        fig.tight_layout()
        if filename:
            fig.savefig(filename, dpi=120)
        if show:
            plt.show()
        plt.close(fig)
        return fig

    def __repr__(self):
        return (f"MPC(Nt={self.Nt}, Nx={self.Nx}, Nu={self.Nu}, "
                f"dt={self.dt}, device={self.device}, {self.options})")
