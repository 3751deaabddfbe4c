"""Plant / physical model layer.

Counterpart of ``gpmpc_tpu/models/dynamics.py::Model``: wraps a
continuous-time ODE ``ode(x, u) -> dx/dt`` (any function of torch tensors)
into fixed-step RK4 maps or the error-controlled Dormand-Prince RK5(4)
integrator (``integrator='adaptive'``), their Jacobians, rollouts and
training data, the plant-against-predictor comparison and its figure;
semi-explicit index-1 DAE systems (``alg``) by pointwise Newton
elimination of the algebraic variables.  Random draws come from a
``torch.Generator`` where the JAX package takes a ``jax.random`` key (other
numbers from the same seed).

The adaptive integrator is the JAX package's ``lax.while_loop`` as a masked
loop over a batch of lanes (any leading dims of the state): each lane
stops stepping when it reaches dt or its step budget, and the loop reads
"every lane done" on the host once every :data:`ADAPTIVE_CHUNK` steps on
the card (every step on the CPU).  Under a ``torch.func`` transform (the
NLP's ``jacfwd`` with ``discrete_method='exact'``, a ``vmap``) the flag is
read from the primal values beneath the transform's wrappers: the step
sizes and stop decisions depend on the primal values only, as in the JAX
loop, and the tangents ride along.  That read is a host sync, so an
``exact`` controller with the adaptive integrator syncs on the card; the
plant and the host paths (``sim``, ``generate_training_data``,
``MPC.solve_mc``'s plant step) read it outside any transform.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch.func import jacfwd

from torch.func import vmap

from gpmpc_tpu_torch.ops import cuda_kernels
from gpmpc_tpu_torch.ops.chol import ge_solve_small
from gpmpc_tpu_torch.utils.device import resolve_device

#: the adaptive integrator's steps between two host reads of "every lane
#: done" on the card (each read waits for the device); on the CPU it reads
#: after every step
ADAPTIVE_CHUNK = 8


def _primal(t: torch.Tensor) -> torch.Tensor:
    """The tensor beneath every ``torch.func`` wrapper of ``t``: the primal
    values of all lanes of every level."""
    while torch._C._functorch.is_functorch_wrapped_tensor(t):
        t = torch._C._functorch.get_unwrapped(t)
    return t


class Model:
    """Continuous-time plant wrapped into discrete-time maps:
    ``rk4``, ``integrate``, ``linearize``, ``discrete_linearize``, ``sim``,
    ``generate_training_data``.  Every tensor lives on ``device`` (default:
    the CUDA card; ``device="cpu"`` for the CPU) in ``dtype``.

    With ``alg`` the plant is the semi-explicit index-1 DAE x' = ode(x, z,
    u), 0 = alg(x, z, u), z in R^Nz: the algebraic variables are eliminated
    pointwise by ``alg_newton_iters`` Newton steps from ``z_guess(x, u)``
    (default zeros), so every map works on the reduced ODE.  ``rtol``,
    ``atol`` and ``max_adaptive_steps`` set the adaptive integrator."""

    def __init__(self,
                 Nx: int,
                 Nu: int,
                 ode: Callable,
                 dt: float,
                 R=None,
                 alg: Optional[Callable] = None,
                 Nz: Optional[int] = None,
                 z_guess: Optional[Callable] = None,
                 alg_newton_iters: int = 12,
                 clip_negative: bool = False,
                 integrator_substeps: int = 20,
                 integrator: str = "rk4",
                 fused_integrator: bool = False,
                 rtol: float = 1e-6,
                 atol: float = 1e-9,
                 max_adaptive_steps: int = 10_000,
                 device=None,
                 dtype=torch.float32):
        self.Nx = int(Nx)
        self.Nu = int(Nu)
        self.dt = float(dt)
        self.device = resolve_device(device)
        self.dtype = dtype
        self.clip_negative = bool(clip_negative)
        self.integrator_substeps = int(integrator_substeps)
        if integrator not in ("rk4", "adaptive"):
            raise ValueError(f"unknown integrator {integrator!r} "
                             "(expected 'rk4' or 'adaptive')")
        # fused_integrator runs the RK4 substep chain as one CUDA kernel
        # launch (K2, csrc/rk4_substeps.cu) on a CUDA device, and as its
        # plain version on the CPU.  f32 only, not differentiable: plant
        # truth, never the NLP-embedded map.  On the card the ODE's functor
        # is registered here: systems.four_tank_ode and car_ode (tagged)
        # take their hand-written ones, any other ODE is traced on one
        # point and lowered now (an op outside the lowering, or a branch
        # on the data, raises here), and built at its first launch.
        self.fused_integrator = bool(fused_integrator)
        if self.fused_integrator:
            if dtype == torch.float64:
                raise ValueError(
                    "fused_integrator=True runs in f32 — it would silently "
                    "break the x64 parity path; use the default integrator "
                    "for float64 models")
            if alg is not None:
                raise ValueError(
                    "fused_integrator=True does not support DAE (alg) "
                    "systems")
            if integrator == "adaptive":
                raise ValueError(
                    "fused_integrator=True applies to the fixed-step RK4 "
                    "chain; integrator='adaptive' would silently bypass it "
                    "— pick one")
        #: K2's functor on the card (``cuda_kernels.register_ode``), which
        #: ``integrate`` launches; None on the CPU
        self.k2 = (cuda_kernels.register_ode(ode, self.Nx, self.Nu,
                                             self.device)
                   if self.fused_integrator and self.device.type == "cuda"
                   else None)
        self.integrator = integrator
        self.rtol = float(rtol)
        self.atol = float(atol)
        self.max_adaptive_steps = int(max_adaptive_steps)
        #: host reads of "every lane done" by the adaptive integrator
        self.adaptive_host_reads = 0
        self.R = (torch.zeros((self.Nx, self.Nx), dtype=dtype,
                              device=self.device) if R is None
                  else torch.as_tensor(np.asarray(R), dtype=dtype,
                                       device=self.device))
        self.alg = alg
        if alg is not None:
            if Nz is None or int(Nz) <= 0:
                raise ValueError("DAE systems require Nz (the number of "
                                 "algebraic variables)")
            self.Nz = int(Nz)
            self._ode_dae = ode                  # ode(x, z, u)
            self._z_guess = z_guess
            self._alg_iters = int(alg_newton_iters)
            self.ode = self._dae_reduced         # ode(x, u) for all callers
        else:
            self.Nz = 0
            self.ode = ode

    # ------------------------------------------------------------ DAE layer

    def solve_alg(self, x: torch.Tensor, u: torch.Tensor,
                  z0: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Newton solve of 0 = alg(x, z, u) for the algebraic variables z
        of one point: a fixed count of steps, each a ``jacfwd`` in z and an
        unrolled Gauss-Jordan solve (no branch on the values)."""
        if z0 is None:
            z0 = (self._z_guess(x, u) if self._z_guess is not None
                  else x.new_zeros(self.Nz))
        z = z0
        for _ in range(self._alg_iters):
            g = self.alg(x, z, u)
            jz = jacfwd(lambda zz: self.alg(x, zz, u))(z).to(z.dtype)
            z = z + ge_solve_small(jz, -g)
        return z

    def _dae_reduced(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """Reduced ODE x' = f(x, z*(x, u), u), z* from the Newton solve;
        mapped over any leading dims of x and u."""
        return self._pointwise(
            lambda xx, uu: self._ode_dae(xx, self.solve_alg(xx, uu), uu),
            x, u)

    @staticmethod
    def _pointwise(f, x, u):
        """``f(x, u)`` of one point, mapped over the broadcast leading dims
        of x (..., Nx) and u (..., Nu)."""
        lead = torch.broadcast_shapes(x.shape[:-1], u.shape[:-1])
        if not lead:
            return f(x, u)
        xf = x.expand(lead + x.shape[-1:]).reshape((-1,) + x.shape[-1:])
        uf = u.expand(lead + u.shape[-1:]).reshape((-1,) + u.shape[-1:])
        out = vmap(f)(xf, uf)
        return out.reshape(lead + out.shape[-1:])

    # ------------------------------------------------------------ core maps

    def rk4(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """One RK4 step over dt — the cheap discrete map embedded in the NLP
        (``discrete_method='rk4'``)."""
        return cuda_kernels.rk4_substeps_reference(self.ode, x, u, self.dt, 1)

    def integrate(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """Plant-truth one-step integration over dt: ``integrator_substeps``
        RK4 substeps (with ``fused_integrator`` through the K2 wrapper), or
        the adaptive DOPRI5 integrator with ``integrator='adaptive'``."""
        if self.integrator == "adaptive":
            return self.integrate_adaptive(x, u)
        h = self.dt / self.integrator_substeps
        if self.fused_integrator:
            return cuda_kernels.rk4_substeps(
                self.ode, x.contiguous(), u.contiguous(), h,
                self.integrator_substeps, spec=self.k2)
        return cuda_kernels.rk4_substeps_reference(
            self.ode, x, u, h, self.integrator_substeps)

    # Dormand-Prince RK5(4)7M tableau (the pair of the host integrator
    # csrc/integrator.cpp and of the JAX package)
    _DP_A = (
        (1 / 5,),
        (3 / 40, 9 / 40),
        (44 / 45, -56 / 15, 32 / 9),
        (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
        (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
        (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
    )
    # 5th-order solution weights == last A row (FSAL); 4th-order embedded
    _DP_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640,
              -92097 / 339200, 187 / 2100, 1 / 40)

    def _dopri5_step(self, x, u, h, k1):
        """One DOPRI5 trial step of size ``h`` (broadcast against x) from
        the first stage ``k1 = f(x)``, the ODE mapped over the lanes (an
        ODE written for one state serves); returns (x5, err, k7) with err the
        5th-minus-embedded-4th-order difference and k7 = f(x5), the next
        step's k1 (FSAL)."""
        k = [k1]
        for row in self._DP_A:
            xs = x + h * sum(a * ki for a, ki in zip(row, k) if a != 0.0)
            k.append(self._pointwise(self.ode, xs, u))
        x5 = xs                       # the last stage uses the b-row (FSAL)
        x4 = x + h * sum(b * ki for b, ki in zip(self._DP_B4, k)
                         if b != 0.0)
        return x5, x5 - x4, k[-1]

    def integrate_adaptive(self, x: torch.Tensor, u: torch.Tensor,
                           rtol: Optional[float] = None,
                           atol: Optional[float] = None) -> torch.Tensor:
        """Error-controlled one-step integration over dt: Dormand-Prince
        RK5(4) with the Gustafsson PI step-size controller, the JAX
        package's ``integrate_adaptive``.  x (..., Nx) and u (..., Nu): each
        lane of the leading dims steps on its own and stops at dt or at
        ``max_adaptive_steps`` steps (its updates masked once it stops);
        the loop ends when every lane has stopped, read on the host every
        :data:`ADAPTIVE_CHUNK` steps on the card.  Forward-mode
        differentiable.

        Failure is not silent: a lane whose budget ran out before dt, or
        that force-accepted a step at the minimum step size with its error
        above tolerance, comes back NaN."""
        rtol = self.rtol if rtol is None else float(rtol)
        atol = self.atol if atol is None else float(atol)
        t_end = self.dt
        h0 = t_end / 10.0              # a conservative fraction of dt
        h_min = t_end * 1e-6
        # h *= safety err^(-0.7/5) err_prev^(0.4/5) (Hairer & Wanner II.4)
        safety, pi_alpha, pi_beta = 0.9, 0.7 / 5.0, 0.4 / 5.0
        budget = self.max_adaptive_steps
        lead = torch.broadcast_shapes(x.shape[:-1], u.shape[:-1])
        x = x.expand(lead + x.shape[-1:])
        u = u.expand(lead + u.shape[-1:])
        kw = dict(dtype=x.dtype, device=x.device)
        t = torch.zeros(lead, **kw)
        h = torch.full(lead, h0, **kw)
        k1 = self._pointwise(self.ode, x, u)
        en_prev = torch.ones(lead, **kw)
        n = torch.zeros(lead, dtype=torch.int32, device=x.device)
        bad = torch.zeros(lead, dtype=torch.bool, device=x.device)
        chunk = 1 if x.device.type == "cpu" else ADAPTIVE_CHUNK
        steps = 0
        while steps < budget:
            for _ in range(min(chunk, budget - steps)):
                active = (t < t_end) & (n < budget)
                hh = torch.minimum(h, t_end - t)
                x5, err, k7 = self._dopri5_step(x, u, hh[..., None], k1)
                scale = atol + rtol * torch.maximum(torch.abs(x),
                                                    torch.abs(x5))
                enorm = torch.sqrt(torch.mean((err / scale) ** 2, dim=-1))
                accept = (enorm <= 1.0) | (hh <= h_min)
                # a force-accept at h_min with the error still above
                # tolerance means the error control has failed
                bad_n = bad | ((enorm > 1.0) & (hh <= h_min))
                en = torch.clamp(enorm, min=1e-10)
                fac = (safety * torch.pow(en, -pi_alpha)
                       * torch.pow(torch.clamp(en_prev, min=1e-10), pi_beta))
                h_n = torch.clamp(hh * torch.clamp(fac, 0.2, 5.0), min=h_min)
                take = active & accept
                t = torch.where(take, t + hh, t)
                x = torch.where(take[..., None], x5, x)
                # FSAL: an accepted step's k7 = f(x5) is the next k1; a
                # rejected step retries from the same x with the same k1
                k1 = torch.where(take[..., None], k7, k1)
                en_prev = torch.where(take, en, en_prev)
                h = torch.where(active, h_n, h)
                bad = torch.where(active, bad_n, bad)
                n = n + active.to(torch.int32)
                steps += 1
            self.adaptive_host_reads += 1
            if not bool(torch.any(_primal((t < t_end) & (n < budget)))):
                break
        failed = bad | (t < t_end)        # budget exhausted mid-interval
        return torch.where(failed[..., None], torch.full_like(x, torch.nan),
                           x)

    # ------------------------------------------------------------ linearize

    def linearize(self, x: torch.Tensor, u: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Continuous-time Jacobians A = df/dx, B = df/du at (x, u), in
        x's dtype (:meth:`discrete_linearize` says why)."""
        a = jacfwd(lambda xx: self.ode(xx, u))(x)
        b = jacfwd(lambda uu: self.ode(x, uu))(u)
        return a.to(x.dtype), b.to(x.dtype)

    def discrete_linearize(self, x: torch.Tensor, u: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Discrete-time Jacobians of the one-step RK4 map, in x's dtype:
        torch.func's forward-mode derivatives of a 0-d slice times a Python
        float (as the ODEs are written) come out in float64 for a float32
        primal (torch 2.13)."""
        a = jacfwd(lambda xx: self.rk4(xx, u))(x)
        b = jacfwd(lambda uu: self.rk4(x, uu))(u)
        return a.to(x.dtype), b.to(x.dtype)

    # ------------------------------------------------------------ simulate

    def _tensor(self, v) -> torch.Tensor:
        """``v`` (a tensor, an array or a list) on the model's device, in
        its dtype."""
        return torch.as_tensor(v if torch.is_tensor(v) else np.asarray(v),
                               dtype=self.dtype, device=self.device)

    def _chol_r(self) -> torch.Tensor:
        eye = torch.eye(self.Nx, dtype=self.dtype, device=self.device)
        return torch.linalg.cholesky(self.R + 1e-32 * eye)

    def sim(self, x0, u_seq, noise: bool = False,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Multi-step rollout under a control sequence u_seq (T, Nu); with
        ``noise`` additive process noise ~ N(0, R) per step, drawn from
        ``generator``.  Returns the trajectory (T+1, Nx) including x0."""
        x, u_seq = self._tensor(x0), self._tensor(u_seq)
        kw = dict(dtype=self.dtype, device=self.device)
        t = u_seq.shape[0]
        if noise:
            if generator is None:
                raise ValueError("sim(noise=True) requires a generator")
            w = torch.randn((t, self.Nx), generator=generator, **kw) \
                @ self._chol_r().T
        else:
            w = torch.zeros((t, self.Nx), **kw)
        xs = [x]
        for k in range(t):
            x = self.integrate(x, u_seq[k]) + w[k]
            if self.clip_negative:
                x = torch.clamp(x, min=0.0)
            xs.append(x)
        return torch.stack(xs)

    def generate_training_data(self, N: int, uub, ulb, xub, xlb,
                               noise: bool = True,
                               generator: Optional[torch.Generator] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sample (x, u) uniformly in box bounds, integrate one step (all N
        samples in one call: one K2 launch with ``fused_integrator`` on the
        card), add measurement noise ~ N(0, R).  The draws come from
        ``generator`` (default: one on the model's device seeded with 0, as
        the JAX package's default key is PRNGKey(0)).  Returns X (N, Nx+Nu),
        Y (N, Nx)."""
        g = generator if generator is not None else \
            torch.Generator(device=self.device).manual_seed(0)
        kw = dict(dtype=self.dtype, device=self.device)
        xlb, xub, ulb, uub = (torch.as_tensor(np.asarray(v), **kw)
                              for v in (xlb, xub, ulb, uub))
        x0 = xlb + (xub - xlb) * torch.rand((N, self.Nx), generator=g, **kw)
        u0 = ulb + (uub - ulb) * torch.rand((N, self.Nu), generator=g, **kw)
        xn = self.integrate(x0, u0)
        if noise:
            xn = xn + torch.randn((N, self.Nx), generator=g, **kw) \
                @ self._chol_r().T
        if self.clip_negative:
            # keep sampled states physical (tank levels)
            xn = torch.clamp(xn, min=0.0)
        return torch.cat([x0, u0], dim=1), xn

    # ------------------------------------------------------------ misc

    def get_size(self) -> Tuple[int, int]:
        """(Nx, Nu)."""
        return self.Nx, self.Nu

    def predict_compare(self, x0, u_seq, predictor,
                        generator: Optional[torch.Generator] = None):
        """Rollout of the plant against a one-step ``predictor(x, u) ->
        x_next`` (e.g. a trained GP's mean) under the controls ``u_seq``
        (T, Nu), for validation plots.  The plant's rollout is :meth:`sim`,
        with process noise drawn from ``generator`` when one is given.
        Returns ``(x_true (T+1, Nx), x_pred (T+1, Nx))``."""
        x, u_seq = self._tensor(x0), self._tensor(u_seq)
        x_true = self.sim(x, u_seq, noise=generator is not None,
                          generator=generator)
        xs = [x]
        for k in range(u_seq.shape[0]):
            x = predictor(x, u_seq[k])
            xs.append(x)
        return x_true, torch.stack(xs)

    def plot_compare(self, x_true, x_pred, filename=None):
        """The prediction-against-plant figure of :meth:`predict_compare`'s
        two rollouts, one axis per state, saved to ``filename`` when given;
        returns the (closed) figure.  Raises
        :class:`~gpmpc_tpu_torch.utils.plotting.MatplotlibMissing` without
        matplotlib."""
        from gpmpc_tpu_torch.utils.plotting import pyplot
        plt = pyplot()
        x_true = np.asarray(torch.as_tensor(x_true).detach().cpu())
        x_pred = np.asarray(torch.as_tensor(x_pred).detach().cpu())
        t = np.arange(x_true.shape[0]) * self.dt
        fig, axes = plt.subplots(self.Nx, 1, sharex=True,
                                 figsize=(8, 2.0 * self.Nx))
        axes = np.atleast_1d(axes)
        for i in range(self.Nx):
            axes[i].plot(t, x_true[:, i], label=f"x{i} plant")
            axes[i].plot(t, x_pred[:, i], "--", label=f"x{i} predicted")
            axes[i].legend(loc="best", fontsize=7)
        axes[-1].set_xlabel("time [s]")
        fig.tight_layout()
        if filename:
            fig.savefig(filename, dpi=120)
        plt.close(fig)
        return fig
