"""Plant / physical model layer.

Counterpart of ``gpmpc_tpu/models/dynamics.py::Model``: wraps a
continuous-time ODE ``ode(x, u) -> dx/dt`` (any function of torch tensors)
into fixed-step RK4 maps, their Jacobians, rollouts and training data.
Random draws come from a ``torch.Generator`` where the JAX package takes a
``jax.random`` key (other numbers from the same seed).  The adaptive DOPRI5
integrator and DAE (``alg``) elimination are ROADMAP §1 item 6.4.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch.func import jacfwd

from gpmpc_tpu_torch.ops import cuda_kernels
from gpmpc_tpu_torch.utils.device import resolve_device


class Model:
    """Continuous-time plant wrapped into discrete-time maps:
    ``rk4``, ``integrate``, ``linearize``, ``discrete_linearize``, ``sim``,
    ``generate_training_data``.  Every tensor lives on ``device`` (default:
    the CUDA card; ``device="cpu"`` for the CPU) in ``dtype``."""

    def __init__(self,
                 Nx: int,
                 Nu: int,
                 ode: Callable,
                 dt: float,
                 R=None,
                 alg: Optional[Callable] = None,
                 clip_negative: bool = False,
                 integrator_substeps: int = 20,
                 integrator: str = "rk4",
                 fused_integrator: bool = False,
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
        # launch (csrc/rk4_substeps.cu) on a CUDA device, and as its plain
        # version on the CPU.  f32 only, not differentiable: plant truth,
        # never the NLP-embedded map.
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
            if (self.device.type == "cuda"
                    and cuda_kernels.kernel_ode_id(ode) is None):
                raise ValueError(
                    "fused_integrator=True on a CUDA device needs an ODE "
                    "compiled into the RK4 kernel (have "
                    f"{sorted(cuda_kernels.CUDA_ODES)}: "
                    "systems.four_tank_ode or systems.car_ode passed "
                    "directly, not wrapped); other ODEs are ROADMAP work "
                    "(the quadrotor's K2 functor, §2 item 2)")
        if integrator == "adaptive":
            raise NotImplementedError(
                "integrator='adaptive' is not ported yet (ROADMAP §1 item "
                "6.4)")
        if alg is not None:
            raise NotImplementedError(
                "DAE (alg) systems are not ported yet (ROADMAP §1 item "
                "6.4)")
        self.integrator = integrator
        self.R = (torch.zeros((self.Nx, self.Nx), dtype=dtype,
                              device=self.device) if R is None
                  else torch.as_tensor(np.asarray(R), dtype=dtype,
                                       device=self.device))
        self.ode = ode

    # ------------------------------------------------------------ core maps

    def rk4(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """One RK4 step over dt — the cheap discrete map embedded in the NLP
        (``discrete_method='rk4'``)."""
        return cuda_kernels.rk4_substeps_reference(self.ode, x, u, self.dt, 1)

    def integrate(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """Plant-truth one-step integration over dt: ``integrator_substeps``
        RK4 substeps; with ``fused_integrator`` through the K2 wrapper."""
        h = self.dt / self.integrator_substeps
        if self.fused_integrator:
            return cuda_kernels.rk4_substeps(
                self.ode, x.contiguous(), u.contiguous(), h,
                self.integrator_substeps)
        return cuda_kernels.rk4_substeps_reference(
            self.ode, x, u, h, self.integrator_substeps)

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

    def _chol_r(self) -> torch.Tensor:
        eye = torch.eye(self.Nx, dtype=self.dtype, device=self.device)
        return torch.linalg.cholesky(self.R + 1e-32 * eye)

    def sim(self, x0, u_seq, noise: bool = False,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Multi-step rollout under a control sequence u_seq (T, Nu); with
        ``noise`` additive process noise ~ N(0, R) per step, drawn from
        ``generator``.  Returns the trajectory (T+1, Nx) including x0."""
        kw = dict(dtype=self.dtype, device=self.device)
        x = torch.as_tensor(np.asarray(x0), **kw)
        u_seq = torch.as_tensor(np.asarray(u_seq), **kw)
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
