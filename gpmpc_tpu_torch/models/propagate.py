"""Uncertainty propagation through the GP dynamics model.

Counterpart of ``gpmpc_tpu/models/propagate.py`` for three of its
schemes.  Given GP input z ~ N(mu_z, Sigma_z) with z = [x; u] in raw
space:

* ME  (mean equivalent): mu = gp_mean(mu_z), Sigma = diag(gp_var(mu_z)).
* TA  (first-order Taylor, Girard et al. 2003): mean as ME;
  Sigma = diag(gp_var(mu_z)) + J Sigma_z J^T with J = d mu / d z from
  ``torch.func.jacfwd``.
* EM  (exact moment matching, Candela/Girard/Rasmussen 2003; the PILCO
  forms): exact output mean and full output covariance for the SE-ARD
  kernel under a Gaussian input.

Each returns ``(mu_y (Ny,), Sigma_y (Ny,Ny), C (D,Ny))`` with C = cov(z, y).
UT and GH are ROADMAP slice F item 1.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch.func import jacfwd

from gpmpc_tpu_torch.models import gp_core
from gpmpc_tpu_torch.ops.chol import (chol_logdet_small, chol_small,
                                      tri_solve_small)
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


@functools.lru_cache(maxsize=None)
def _pairs(ny: int, device: torch.device):
    """The output pairs (a, b), a <= b, in ``np.triu_indices`` order, and
    the positions of the pairs a == b among them, as index tensors on
    ``device``: made once, so a stage's EM copies no indices to the
    card."""
    iu, ju = np.triu_indices(ny)
    return (torch.as_tensor(iu, device=device),
            torch.as_tensor(ju, device=device),
            torch.as_tensor(np.flatnonzero(iu == ju), device=device))


def propagate_em(post: gp_core.GPPosterior, norm: Normalization,
                 cfg: GPConfig, mu_z: torch.Tensor, cov_z: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact moment matching for the SE-ARD kernel under a Gaussian input.
    Needs a zero prior mean (in normalized space), which ``GP.set_method``
    enforces for ``gp_method='EM'``.

    The JAX version maps its per-dim terms over the Ny output dims and its
    pair terms over the Ny(Ny+1)/2 output pairs (a, b), a <= b; here both
    are a leading batch dim, so one stage's covariance is the same few
    dozen batched ops whatever Ny is.  The (N, N) pair products run in
    full f32 on the card (TF32 stays off), as the JAX version pins them to
    ``Precision.HIGHEST``."""
    if cfg.kernel != "se":
        raise ValueError("exact moment matching is SE-specific "
                         f"(kernel={cfg.kernel!r}); use ME/TA")
    h = post.hypers
    x = post.x                                          # (N, D) normalized
    n, d = x.shape
    ny = h.log_sf2.shape[0]

    # the Gaussian in normalized input space
    m = (mu_z - norm.z_mean) / norm.z_std
    s = cov_z / (norm.z_std[:, None] * norm.z_std[None, :])

    nu = x - m[None, :]                                 # (N, D)
    beta = post.alpha                                   # (Ny, N)
    ell2 = torch.exp(2.0 * h.log_ell)                   # (Ny, D)
    sf2 = torch.exp(h.log_sf2)                          # (Ny,)
    eye_d = torch.eye(d, dtype=x.dtype, device=x.device)

    # ---- per dim a: mean and cross-covariance
    t = s + torch.diag_embed(ell2)                      # S + Lambda_a, SPD
    lt = chol_small(t)                                  # (Ny, D, D)
    sol = tri_solve_small(lt, nu.T.expand(ny, d, n))    # (Ny, D, N)
    quad = torch.sum(sol * sol, dim=-2)                 # nu' T^-1 nu, (Ny, N)
    # |S Lam^-1 + I|^{-1/2} = |Lam|^{1/2} |S + Lam|^{-1/2}
    logdet = (0.5 * torch.sum(torch.log(ell2), dim=-1)
              - 0.5 * chol_logdet_small(lt))            # (Ny,)
    q = sf2[:, None] * torch.exp(logdet[:, None] - 0.5 * quad)   # (Ny, N)
    mu_n = torch.sum(beta * q, dim=-1)                  # (Ny,)
    tinv_nu = tri_solve_small(lt, sol, trans=True)      # T^-1 nu, (Ny, D, N)
    c_n = ((s @ tinv_nu) @ (beta * q)[..., None])[..., 0]        # (Ny, D)

    # ---- pairs (a, b), a <= b: log k_a(x_i, m) for all a and i
    log_km = (torch.log(sf2)[:, None]
              - 0.5 * torch.sum(nu * nu / ell2[:, None, :], dim=-1))
    ia, ib, diag = _pairs(ny, x.device)
    il = 1.0 / ell2
    il_a, il_b = il[ia], il[ib]                         # (P, D)
    # R = S P + I with P = diag(il_a + il_b) is not symmetric; the Woodbury
    # form with M = I + sqrt(P) S sqrt(P) (SPD):
    #   R^{-1} S = S - S sqrt(P) M^{-1} sqrt(P) S,   det R = det M
    dsq = torch.sqrt(il_a + il_b)                       # (P, D)
    mm = eye_d + dsq[:, :, None] * s * dsq[:, None, :]
    lm = chol_small(mm)                                 # (P, D, D)
    sd = s * dsq[:, None, :]                            # S sqrt(P)
    minv_sd = tri_solve_small(lm, tri_solve_small(lm, sd.mT), trans=True)
    ris = s - sd @ minv_sd                              # R^{-1} S, (P, D, D)
    logdet_r = chol_logdet_small(lm)                    # (P,)
    u = nu * il_a[:, None, :]                           # (P, N, D)
    v = nu * il_b[:, None, :]
    ur = u @ ris
    uu = torch.sum(ur * u, dim=-1)                      # (P, N)
    vv = torch.sum((v @ ris) * v, dim=-1)
    uv = ur @ v.mT                                      # (P, N, N)
    log_q2 = (log_km[ia][:, :, None] + log_km[ib][:, None, :]
              - 0.5 * logdet_r[:, None, None]
              + 0.5 * (uu[:, :, None] + vv[:, None, :]) + uv)
    q2 = torch.exp(log_q2)
    vals = ((beta[ia][:, None, :] @ q2)[:, 0, :] * beta[ib]).sum(-1) \
        - mu_n[ia] * mu_n[ib]
    # the diagonal pairs add sf2 - tr(K^-1 Q2)
    dims = ia[diag]
    tr = torch.sum(post.inv_k[dims] * q2[diag], dim=(-2, -1))
    vals = vals.index_add(0, diag, sf2[dims] - tr)
    sigma_n = vals.new_zeros((ny, ny)).index_put((ia, ib), vals) \
        .index_put((ib, ia), vals)

    # ---- denormalize
    mu = norm.y_mean + norm.y_std * mu_n
    sigma = sigma_n * (norm.y_std[:, None] * norm.y_std[None, :])
    c = c_n.T * (norm.z_std[:, None] * norm.y_std[None, :])
    return mu, sigma, c


PROPAGATORS = {"ME": propagate_me, "TA": propagate_ta, "EM": propagate_em}


def get_propagator(method: str):
    """Select the propagation scheme ('ME' | 'TA' | 'EM')."""
    m = method.upper()
    if m in PROPAGATORS:
        return PROPAGATORS[m]
    if m in ("UT", "GH"):
        raise NotImplementedError(
            f"gp_method {method!r} is not ported yet (ROADMAP slice F item "
            "1)")
    raise ValueError(
        f"unknown gp_method {method!r}; expected ME, TA, EM, UT, or GH")
