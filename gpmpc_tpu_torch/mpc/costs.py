"""Expected stage costs under state uncertainty.

Counterpart of ``gpmpc_tpu/mpc/costs.py``:

* expected quadratic: (x - x_sp)' Q (x - x_sp) + tr(Q Sigma)
* saturating (PILCO-style), ``costFunc='sat'``:
  E[1 - exp(-0.5 ||x - x_sp||^2_W)] under x ~ N(mu, Sigma) =
  1 - |I + Sigma W|^{-1/2} exp(-0.5 e' W (I + Sigma W)^{-1} e).
"""

from __future__ import annotations

import torch

from gpmpc_tpu_torch.ops.chol import ge_solve_small


def expected_quadratic(mu: torch.Tensor, sigma: torch.Tensor,
                       x_sp: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    e = mu - x_sp
    return e @ q @ e + torch.sum(q * sigma)


def expected_saturating(mu: torch.Tensor, sigma: torch.Tensor,
                        x_sp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    e = mu - x_sp
    m = torch.eye(mu.shape[0], dtype=mu.dtype, device=mu.device) + sigma @ w
    # the unrolled pivoted solve, not torch.linalg.solve: under vmap over
    # the stages, hessian() through torch.linalg.solve gave NaN for every
    # stage whose Sigma is not diagonal (torch 2.13)
    quad = e @ w @ ge_solve_small(m, e)
    _, logdet = torch.linalg.slogdet(m)
    return 1.0 - torch.exp(-0.5 * quad - 0.5 * logdet)
