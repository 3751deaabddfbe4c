"""Batched closed-loop study: parallel receding-horizon rollouts with
per-rollout online GP conditioning (bench config 5).

Counterpart of ``gpmpc_tpu/parallel/batched.py``.  The JAX package vmaps
the whole rollout (a ``lax.scan`` over control steps) into one program.
Here one control step of one rollout (shift the warm start, solve the
AL-SQP, apply the clipped input to the plant, condition the rollout's
posterior on the observed transition) is batched over the rollouts with
``torch.func.vmap``, and a Python loop runs the steps.  Every op of a
step is then one batched op for all B rollouts: the GP predictions, the
stage Hessians and, with ``fused_kkt``/``fused_integrator``, the Riccati
sweep (K1) and the plant's RK4 substeps (K2), whose wrappers are custom
operators with a vmap rule that makes one launch for the batch
(``ops/cuda_kernels.py``).  The solver's inner loop runs its fixed,
masked budget under the batch, as on the card, which is what the JAX
package's vmapped ``while_loop`` computes lane by lane.

Each rollout carries its own :class:`~online_gp.OnlinePosterior`, so the
B posteriors part as the rollouts explore.  Not ported: ``mesh=`` (ROADMAP
slice F item 9), ``chunk=`` and ``solve_precision=`` (ROADMAP "Not
ported"); each raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch
from torch.func import vmap

from gpmpc_tpu_torch.parallel import online_gp
from gpmpc_tpu_torch.solvers import al_sqp
from gpmpc_tpu_torch.utils.config import SQPConfig, resolve_solver_opts


class StudyConsts(NamedTuple):
    """Tensors the study NLP reads that stay fixed across steps."""

    q: torch.Tensor
    r: torch.Tensor
    ulb: torch.Tensor
    uub: torch.Tensor
    u_scale: torch.Tensor
    u_guard_lo: torch.Tensor
    u_guard_hi: torch.Tensor
    norm: object                     # Normalization


class StudyParams(NamedTuple):
    x_sp: torch.Tensor
    post: online_gp.OnlinePosterior
    consts: StudyConsts


class StudyResult(NamedTuple):
    x_traj: torch.Tensor     # (B, n_steps+1, Nx)
    u_traj: torch.Tensor     # (B, n_steps, Nu)
    cost: torch.Tensor       # (B,) closed-loop quadratic cost per rollout
    obj: torch.Tensor        # (B, n_steps) NLP objectives
    gp_points: torch.Tensor  # (B,) final conditioning counts
    mean_cost: torch.Tensor  # () batch-mean cost
    post: object             # batched OnlinePosterior (B-leading) for resume


def save_study(path: str, result: StudyResult) -> None:
    """Checkpoint a study (trajectories and the per-rollout conditioned
    posteriors) to ``.npz`` with the JAX package's keys and posterior leaf
    order, so either package loads the other's checkpoints."""
    leaves = [t.detach().cpu().numpy() for t in result.post]
    np.savez(path,
             **{k: getattr(result, k).detach().cpu().numpy()
                for k in ("x_traj", "u_traj", "cost", "obj", "gp_points",
                          "mean_cost")},
             n_post_leaves=len(leaves),
             **{f"post_{i}": leaf for i, leaf in enumerate(leaves)})


def load_study(path: str, template_post) -> StudyResult:
    """Load a study checkpoint; ``template_post`` (e.g. ``study.post0``)
    gives the posterior's structure and device."""
    z = np.load(path)
    n = int(z["n_post_leaves"])
    tmpl = list(template_post)
    leaves = [np.asarray(z[f"post_{i}"]) for i in range(n)]
    if n == len(tmpl) - 1:
        # a 0.3.x checkpoint predates OnlinePosterior.mean_w (the trailing
        # field): the template's frozen weights (zero-width for 'zero'),
        # batched to match the saved leaves
        mw = tmpl[-1].detach().cpu().numpy()
        if leaves and leaves[0].ndim == tmpl[0].ndim + 1:
            mw = np.broadcast_to(mw, (leaves[0].shape[0],) + mw.shape)
        leaves.append(mw)
    device = tmpl[0].device

    def t(a):
        return torch.tensor(np.asarray(a), device=device)

    return StudyResult(
        x_traj=t(z["x_traj"]), u_traj=t(z["u_traj"]), cost=t(z["cost"]),
        obj=t(z["obj"]), gp_points=t(z["gp_points"]),
        mean_cost=t(z["mean_cost"]),
        post=type(template_post)(*(t(leaf) for leaf in leaves)))


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported ({item})")


class BatchedStudy:
    """Batched GP-MPC study harness: ``run(x0s, x_sp, n_steps)`` runs B
    receding-horizon rollouts, each conditioning its own online posterior
    on every observed transition.  Tensors live on the model's device."""

    def __init__(self, model, gp, horizon: float,
                 Q=None, R=None, ulb=None, uub=None,
                 capacity: Optional[int] = None,
                 condition_online: bool = True,
                 online_policy: str = "saturate",
                 solver_opts: Optional[Union[str, dict]] = None,
                 solve_precision: Optional[str] = None,
                 mesh=None,
                 chunk: Optional[int] = None):
        if solve_precision is not None:
            _not_ported("BatchedStudy(solve_precision=)",
                        "ROADMAP 'Not ported': the single TF32 flag, which "
                        "stays off, replaces it")
        if mesh is not None:
            _not_ported("BatchedStudy(mesh=)", "ROADMAP slice F item 9")
        if chunk is not None:
            _not_ported("BatchedStudy(chunk=)",
                        "ROADMAP 'Not ported': a TPU vmap-tiling workaround")
        if gp.device != model.device or gp.dtype != model.dtype:
            raise ValueError(f"the GP lives on {gp.device}/{gp.dtype}, the "
                             f"model on {model.device}/{model.dtype}")
        self.model = model
        self.dt = model.dt
        self.Nt = int(round(horizon / model.dt))
        self.Nx, self.Nu = model.Nx, model.Nu
        self.dtype = dtype = model.dtype
        self.device = device = model.device
        kw = dict(dtype=dtype, device=device)
        self.condition_online = bool(condition_online)
        if online_policy not in ("saturate", "fifo"):
            raise ValueError("online_policy must be 'saturate' or 'fifo'; "
                             f"got {online_policy!r}")
        self.online_policy = online_policy

        def t(v):
            return torch.as_tensor(np.asarray(v), **kw)

        self.Q = t(Q if Q is not None else np.eye(self.Nx))
        self.R = t(R if R is not None else 0.01 * np.eye(self.Nu))
        big = 1e10
        self.ulb = t(ulb if ulb is not None else [-big] * self.Nu)
        self.uub = t(uub if uub is not None else [big] * self.Nu)
        # named presets resolve through the shared table; a falsy dict or
        # None keeps the study's own default budget (al3 x mi15)
        if isinstance(solver_opts, str):
            opts = resolve_solver_opts(solver_opts, dtype)
        else:
            opts = solver_opts or {"al_iters": 3, "max_iters": 15}
        self.sqp_cfg = SQPConfig(**opts)

        # online conditioning reads cross-kernel rows only; a nonzero
        # trained prior mean rides along frozen (residual-based alpha)
        self.kernel = gp.cfg.kernel
        self.mean_func = gp.cfg.mean_func
        cap = capacity or (gp.N + 64)
        self.post0, self.norm = online_gp.from_gp(gp, cap)

        span = self.uub - self.ulb
        u_scale = torch.where(span < big, torch.clamp(span, min=1e-6), 1.0)
        pad = 0.5 * torch.where(span < big, span, big)
        self.consts = StudyConsts(
            q=self.Q, r=self.R, ulb=self.ulb, uub=self.uub,
            u_scale=u_scale, u_guard_lo=self.ulb - pad,
            u_guard_hi=self.uub + pad, norm=self.norm)

        kernel, mean_func = self.kernel, self.mean_func

        def dynamics(x, u, t, params: StudyParams):
            return online_gp.predict_mean(params.post, params.consts.norm,
                                          torch.cat([x, u]), kernel,
                                          mean_func)

        def stage_cost(x, u, t, params: StudyParams):
            e = x - params.x_sp
            return e @ params.consts.q @ e + u @ params.consts.r @ u

        def terminal_cost(x, params: StudyParams):
            e = x - params.x_sp
            return 10.0 * (e @ params.consts.q @ e)

        def stage_ineq(x, u, t, params: StudyParams):
            c0 = params.consts
            return torch.cat([(u - c0.uub) / c0.u_scale,
                              (c0.ulb - u) / c0.u_scale])

        self.problem = al_sqp.TrajectoryProblem(
            nx=self.Nx, nu=self.Nu, horizon=self.Nt,
            dynamics=dynamics, stage_cost=stage_cost,
            terminal_cost=terminal_cost,
            stage_ineq=stage_ineq, n_ineq=2 * self.Nu,
            u_guard=lambda p: (p.consts.u_guard_lo, p.consts.u_guard_hi))

    # ----------------------------------------------------------- rollouts

    def _init_warm(self, x0, post, x_sp, consts: StudyConsts):
        """One rollout's cold warm start: the GP rolled out under u = 0."""
        return al_sqp.init_state(self.problem, x0,
                                 params=StudyParams(x_sp, post, consts))

    def _step(self, x, warm, post, w, x_sp, consts: StudyConsts):
        """One control step of one rollout: solve from the shifted warm
        start, apply the clipped first input to the plant (plus the noise
        ``w``), condition the posterior on the observed transition."""
        params = StudyParams(x_sp=x_sp, post=post, consts=consts)
        state = al_sqp.shift_state(warm, x)
        res = al_sqp.solve(self.problem, params, state, self.sqp_cfg)
        u = torch.clamp(res.state.u[0], consts.ulb, consts.uub)
        x_next = self.model.integrate(x, u) + w
        if self.model.clip_negative:
            x_next = torch.clamp(x_next, min=0.0)
        if self.condition_online:
            post = online_gp.condition(post, consts.norm, torch.cat([x, u]),
                                       x_next, kernel=self.kernel,
                                       policy=self.online_policy,
                                       mean_func=self.mean_func)
        return x_next, res.state, post, u, res.obj

    def _run(self, x0s, x_sp, noise_ws, post0, consts: StudyConsts,
             n_steps: int, batched_post: bool) -> StudyResult:
        """The study: a loop over control steps, each one vmapped step of
        every rollout.  ``post0`` is one posterior shared by all rollouts,
        or B-leading with ``batched_post``."""
        pdim = 0 if batched_post else None
        warm = vmap(self._init_warm, in_dims=(0, pdim, None, None))(
            x0s, post0, x_sp, consts)
        x, post = x0s, post0
        xs, us, objs = [x0s], [], []
        for k in range(n_steps):
            step = vmap(self._step, in_dims=(0, 0, pdim, 0, None, None))
            x, warm, post, u, obj = step(x, warm, post, noise_ws[:, k],
                                         x_sp, consts)
            pdim = 0
            xs.append(x)
            us.append(u)
            objs.append(obj)
        xs = torch.stack(xs, dim=1)
        us = torch.stack(us, dim=1)
        e = xs[:, :-1] - x_sp
        cost = torch.sum(torch.einsum("bti,ij,btj->bt", e, consts.q, e)
                         + torch.einsum("bti,ij,btj->bt", us, consts.r, us),
                         dim=1)
        if pdim is None:                 # n_steps = 0: one shared posterior
            post = type(post0)(*(leaf.expand((x0s.shape[0],) + leaf.shape)
                                 for leaf in post0))
        return StudyResult(x_traj=xs, u_traj=us, cost=cost,
                           obj=torch.stack(objs, dim=1) if objs else
                           xs.new_zeros((xs.shape[0], 0)),
                           gp_points=post.count, mean_cost=torch.mean(cost),
                           post=post)

    def noise(self, b: int, n_steps: int,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Process noise ~ N(0, model.R) for B rollouts over ``n_steps``:
        (B, n_steps, Nx), the normals drawn from ``generator`` (default:
        one on the study's device seeded with 0)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        eye = torch.eye(self.Nx, dtype=self.dtype, device=self.device)
        chol_r = torch.linalg.cholesky(self.model.R + 1e-32 * eye)
        return torch.randn((b, n_steps, self.Nx), generator=generator,
                           dtype=self.dtype, device=self.device) @ chol_r.T

    def run(self, x0s, x_sp, n_steps: int,
            generator: Optional[torch.Generator] = None, noise: bool = True,
            init_post=None, noise_ws=None) -> StudyResult:
        """Run the study.  ``noise_ws`` (B, n_steps, Nx) is the process noise
        when given; otherwise with ``noise`` it is drawn by :meth:`noise`
        from ``generator``, and without ``noise`` it is zero.  ``init_post``
        (a batched OnlinePosterior, e.g. a previous result's ``post`` or
        :func:`load_study`'s) resumes the rollouts with their own
        conditioned GPs."""
        kw = dict(dtype=self.dtype, device=self.device)

        def t(v):
            return torch.as_tensor(v if torch.is_tensor(v) else np.asarray(v),
                                   **kw)

        x0s, x_sp = t(x0s), t(x_sp)
        b = x0s.shape[0]
        if noise_ws is not None:
            noise_ws = t(noise_ws)
            if tuple(noise_ws.shape) != (b, n_steps, self.Nx):
                raise ValueError(f"noise_ws must be (B, n_steps, Nx) = "
                                 f"{(b, n_steps, self.Nx)}; got "
                                 f"{tuple(noise_ws.shape)}")
        elif noise:
            noise_ws = self.noise(b, n_steps, generator)
        else:
            noise_ws = torch.zeros((b, n_steps, self.Nx), **kw)
        post0 = self.post0 if init_post is None else init_post
        return self._run(x0s, x_sp, noise_ws, post0, self.consts,
                         n_steps=n_steps, batched_post=init_post is not None)
