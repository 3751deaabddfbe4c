"""Uncertainty propagation through the GP dynamics model.

Counterpart of ``gpmpc_tpu/models/propagate.py`` for the two schemes of the
main path.  Given GP input z ~ N(mu_z, Sigma_z) with z = [x; u] in raw
space:

* ME  (mean equivalent): mu = gp_mean(mu_z), Sigma = diag(gp_var(mu_z)).
* TA  (first-order Taylor, Girard et al. 2003): mean as ME;
  Sigma = diag(gp_var(mu_z)) + J Sigma_z J^T with J = d mu / d z from
  ``torch.func.jacfwd``.

Each returns ``(mu_y (Ny,), Sigma_y (Ny,Ny), C (D,Ny))`` with C = cov(z, y).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch.func import jacfwd

from gpmpc_tpu_torch.models import gp_core
from gpmpc_tpu_torch.utils.config import GPConfig


class Normalization(NamedTuple):
    """z-score statistics mapping raw <-> normalized spaces."""

    z_mean: torch.Tensor   # (D,)
    z_std: torch.Tensor    # (D,)
    y_mean: torch.Tensor   # (Ny,)
    y_std: torch.Tensor    # (Ny,)

    @staticmethod
    def identity(d: int, ny: int, dtype=torch.float32,
                 device=None) -> "Normalization":
        kw = dict(dtype=dtype, device=device)
        return Normalization(torch.zeros(d, **kw), torch.ones(d, **kw),
                             torch.zeros(ny, **kw), torch.ones(ny, **kw))


def _raw_mean_var(post: gp_core.GPPosterior, norm: Normalization,
                  cfg: GPConfig, z_raw: torch.Tensor):
    """Predictive mean/variance in raw space at a raw input point."""
    zn = (z_raw - norm.z_mean) / norm.z_std
    mu_n, var_n = gp_core.predict(post, zn, cfg)
    return norm.y_mean + norm.y_std * mu_n, (norm.y_std ** 2) * var_n


def propagate_me(post: gp_core.GPPosterior, norm: Normalization,
                 cfg: GPConfig, mu_z: torch.Tensor, cov_z: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mean-equivalent: input covariance ignored."""
    mu, var = _raw_mean_var(post, norm, cfg, mu_z)
    c = mu.new_zeros((mu_z.shape[0], mu.shape[0]))
    return mu, torch.diag(var), c


def propagate_ta(post: gp_core.GPPosterior, norm: Normalization,
                 cfg: GPConfig, mu_z: torch.Tensor, cov_z: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """First-order Taylor: Sigma_y = diag(var(mu_z)) + J Sigma_z J^T,
    C = Sigma_z J^T."""
    def mean_fn(z):
        zn = (z - norm.z_mean) / norm.z_std
        return norm.y_mean + norm.y_std * gp_core.predict_mean(post, zn, cfg)

    mu, var = _raw_mean_var(post, norm, cfg, mu_z)
    jac = jacfwd(mean_fn)(mu_z)                         # (Ny, D)
    sigma = torch.diag(var) + jac @ cov_z @ jac.T
    c = cov_z @ jac.T                                   # (D, Ny)
    return mu, sigma, c


PROPAGATORS = {"ME": propagate_me, "TA": propagate_ta}


def get_propagator(method: str):
    """Select the propagation scheme ('ME' | 'TA')."""
    m = method.upper()
    if m in PROPAGATORS:
        return PROPAGATORS[m]
    if m in ("EM", "UT", "GH"):
        raise NotImplementedError(
            f"gp_method {method!r} is not ported yet: EM is ROADMAP slice B, "
            "UT and GH are ROADMAP slice F item 1")
    raise ValueError(
        f"unknown gp_method {method!r}; expected ME, TA, EM, UT, or GH")
