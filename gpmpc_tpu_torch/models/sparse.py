"""Sparse (inducing-point) GP regression: the Titsias variational free
energy (VFE).

Counterpart of ``gpmpc_tpu/models/sparse.py``.  M << N inducing inputs Z
summarize the data; training minimizes the variational free energy (an
upper bound on the exact NLL, equal to it at Z = X), and prediction costs
O(M) for the mean and O(M^2) for the variance whatever N is.  The VFE
posterior has the exact posterior's algebraic form,

    mean(x*) = m(x*) + k_*M beta,   var(x*) = sf2 - k_*M Lambda k_M*,

with beta = sigma^-2 Sigma K_MN r and Lambda = K_MM^-1 - Sigma (Sigma =
(K_MM + sigma^-2 K_MN K_NM)^-1), so it is a posterior with ``x`` = Z,
``alpha`` = beta, ``inv_k`` = Lambda and ``chol`` = chol(K_MM), and every
consumer of a posterior (predict, the propagations, the MPC) takes it
unchanged.  As a :class:`gp_core.SparsePosterior` it also keeps L_B =
chol(I + A A'), so its variance is formed by triangular solves rather
than with the explicit Lambda (f32 accuracy; the JAX package's form in
f64 within ~1e-12).

Every function carries a leading problem dim where the JAX package maps:
one VFE evaluation of the whole (multistart x Ny) grid computes K_MM by
the plain cross-covariance (as the JAX package does) and its two Cholesky
factors, L_M of K_MM and L_B of I + A A', each as one K5 launch for all
problems on the card (``ops/gp_cuda.py::cholesky_auto``, whose backward
carries the derivative through both).  Online conditioning does not apply
(``parallel/online_gp.py`` rejects a sparse GP).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from gpmpc_tpu_torch.models import gp_core, lbfgs
from gpmpc_tpu_torch.models.gp_core import (GPHypers, _jitter_floor,
                                            _mean_rows, _noise_var)
from gpmpc_tpu_torch.ops.chol import tri_solve
from gpmpc_tpu_torch.ops.gp_cuda import cholesky_auto, sum_rows_then_cols
from gpmpc_tpu_torch.ops.kernels import kernel_cross
from gpmpc_tpu_torch.utils.config import GPConfig


def select_inducing(x: torch.Tensor, m: int) -> torch.Tensor:
    """Greedy k-center (farthest-point) subset: the indices of ``m`` rows of
    ``x`` (N, D) that cover the data, deterministically.  Starts at the
    point closest to the mean and repeatedly adds the point farthest from
    the set (the first such point on a tie, as ``jnp.argmax``)."""
    n = x.shape[0]
    if not 1 <= m <= n:
        raise ValueError(f"inducing count m={m} must be in [1, N={n}]")
    first = torch.argmin(torch.sum((x - torch.mean(x, dim=0)) ** 2, dim=1))
    picks = [first]
    mind = torch.sum((x - x[first]) ** 2, dim=1)               # (N,)
    for _ in range(1, m):
        nxt = torch.argmax(mind)
        picks.append(nxt)
        mind = torch.minimum(mind, torch.sum((x - x[nxt]) ** 2, dim=1))
    return torch.stack(picks).to(torch.int32)


def _factor_terms(log_ell, log_sf2, log_sn2, z_ind, x, cfg: GPConfig):
    """The shared factorization of P problems: L_M = chol(K_MM), A =
    L_M^-1 K_MN / sigma, L_B = chol(I + A A'); log_ell (P, D), log_sf2 and
    log_sn2 (P,).  Two K5 launches on the card."""
    ell = torch.exp(log_ell)[:, None, :]                       # (P, 1, D)
    sf2 = torch.exp(log_sf2)
    sn2 = _noise_var(log_sn2, cfg)
    # K_MM has no noise term: as ell grows it tends to sf2 (ones + jit I),
    # so the jitter has a dtype-aware floor of ~800 ulps (1e-4 in f32,
    # cond(K_MM) <~ M 1e4), as in the JAX package
    jit = max(_jitter_floor(cfg, x.dtype),
              800.0 * float(torch.finfo(x.dtype).eps))
    m_ind = z_ind.shape[0]
    eye = torch.eye(m_ind, dtype=x.dtype, device=x.device)
    k = kernel_cross(cfg.kernel, z_ind, z_ind, ell, sf2[:, None, None])
    k_mm = k * (1.0 - eye) + (sf2 + jit * sf2)[:, None, None] * eye
    l_m = cholesky_auto(k_mm)
    k_mn = kernel_cross(cfg.kernel, z_ind, x, ell, sf2[:, None, None])
    a = tri_solve(l_m, k_mn) / torch.sqrt(sn2)[:, None, None]  # (P, M, N)
    l_b = cholesky_auto(eye + a @ a.mT)
    return l_m, a, l_b, sf2, sn2


def vfe_nll_batch(log_ell: torch.Tensor, log_sf2: torch.Tensor,
                  log_sn2: torch.Tensor, mean_w: torch.Tensor,
                  z_ind: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                  cfg: GPConfig, mean_func: str) -> torch.Tensor:
    """Variational free energy (negative ELBO) of P problems over one input
    set and one inducing set, the sparse stand-in for ``gp_core.
    nll_batch``: log_ell (P, D), log_sf2 and log_sn2 (P,), mean_w (P, F),
    z_ind (M, D), x (N, D), y (P, N) -> (P,),

        F = 0.5 [N log(2 pi sn2) + log|B| + (r'r - c'c) / sn2]
            + (N sf2 / sn2 - tr(A A')) / 2,

    r = y - m(X), c = L_B^-1 A r.  Both r'r - c'c and the trace term are
    nonnegative exactly but cancellation-prone, so each is clamped at 0,
    as in the JAX package."""
    n = x.shape[0]
    l_m, a, l_b, sf2, sn2 = _factor_terms(log_ell, log_sf2, log_sn2, z_ind,
                                          x, cfg)
    r = y - _mean_rows(x, mean_w, mean_func)
    c = tri_solve(l_b, (a @ r[..., None])[..., 0])              # (P, M)
    quad = torch.clamp(torch.sum(r * r, dim=-1) - torch.sum(c * c, dim=-1),
                       min=0.0) / sn2
    logdet = (torch.sum(torch.log(torch.diagonal(l_b, dim1=-2, dim2=-1)),
                        dim=-1) + 0.5 * n * torch.log(sn2))
    trace = 0.5 * torch.clamp(n * sf2 / sn2 - sum_rows_then_cols(a * a),
                              min=0.0)
    nll = 0.5 * quad + logdet + 0.5 * n * math.log(2.0 * math.pi) + trace
    prior = (max(cfg.ell_prior, 1e-4) * torch.sum(log_ell ** 2, dim=-1)
             + 1e-4 * log_sn2 ** 2
             + max(cfg.sf2_prior, 1e-4) * log_sf2 ** 2)
    return nll + prior


def vfe_nll_single(log_ell: torch.Tensor, log_sf2: torch.Tensor,
                   log_sn2: torch.Tensor, mean_w: torch.Tensor,
                   z_ind: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                   cfg: GPConfig, mean_func: str) -> torch.Tensor:
    """The VFE of ONE output dimension (the JAX package's signature):
    log_ell (D,), log_sf2 and log_sn2 (), mean_w (F,), y (N,) -> ()."""
    return vfe_nll_batch(log_ell[None], log_sf2[None], log_sn2[None],
                         mean_w[None], z_ind, x, y[None], cfg, mean_func)[0]


def fit_sparse(x: torch.Tensor, y: torch.Tensor, z_ind: torch.Tensor,
               cfg: GPConfig, generator: torch.Generator, mesh=None
               ) -> Tuple[GPHypers, torch.Tensor, dict]:
    """Train all Ny sparse GPs: multistart L-BFGS on the VFE bound, the
    (multistart x Ny) grid as one batch (:func:`gp_core.fit` with this
    objective).  The grid gets one extra informed start, an exact fit on
    a k-center subset of at most 256 points: the VFE landscape has a wide
    "predict the mean" basin that data-blind starts fall into.  Returns
    the best hypers per dim, their bounds and the batched evaluations of
    each leg (``{"exact": ..., "vfe": ...}``).  ``mesh`` shards both fits'
    grids over its ranks (:func:`gp_core.fit`)."""
    def nll_fn(log_ell, log_sf2, log_sn2, mean_w, xx, yy, cfg_, mf):
        return vfe_nll_batch(log_ell, log_sf2, log_sn2, mean_w, z_ind, xx,
                             yy, cfg_, mf)

    sub = select_inducing(x, min(x.shape[0], 256)).long()
    warm, _, n_exact = gp_core.fit(x[sub], y[sub], cfg, generator,
                                   mesh=mesh)
    hyper, values, n_vfe = gp_core.fit(x, y, cfg, generator, nll_fn=nll_fn,
                                       extra_starts=warm, mesh=mesh)
    return hyper, values, {"exact": n_exact, "vfe": n_vfe}


def _sum_vfe(x, y, hypers: GPHypers, cfg: GPConfig):
    """The summed per-dim VFE bound as a function of the inducing set."""
    def fun(z):
        return torch.sum(vfe_nll_batch(*hypers, z, x, y.mT, cfg,
                                       cfg.mean_func))
    return fun


def optimize_inducing(x: torch.Tensor, y: torch.Tensor, z0: torch.Tensor,
                      hypers: GPHypers, cfg: GPConfig, max_iters: int = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Refine the inducing locations: L-BFGS on Z itself (one problem of
    M x D variables), minimizing the summed per-dim VFE bound with the
    hyperparameters fixed; the derivative runs through both Choleskys.
    Keeps ``z0`` where the result is not finite or not lower (two inducing
    points merged).  Returns ``(z_opt, total_bound, n_evals)``."""
    if max_iters is None:
        max_iters = cfg.max_iters
    fun = _sum_vfe(x, y, hypers, cfg)
    shape = z0.shape

    def objective(theta):
        return fun(theta[0].reshape(shape))[None]

    theta, val, n_evals = lbfgs.minimize(objective, z0.reshape(1, -1),
                                         max_iters, cfg.grad_tol)
    with torch.no_grad():
        val0 = fun(z0)
    ok = torch.isfinite(val[0]) & (val[0] <= val0)
    z_opt = torch.where(ok, theta[0].reshape(shape), z0)
    return z_opt, torch.where(ok, val[0], val0), n_evals + 1


def refit_sparse(x: torch.Tensor, y: torch.Tensor, z_ind: torch.Tensor,
                 hypers: GPHypers, cfg: GPConfig
                 ) -> Tuple[GPHypers, torch.Tensor, int]:
    """Re-fit the hyperparameters on a new inducing set from trained
    values: one start per dim, the Ny problems as one batch.  Returns
    ``(hypers, bounds, n_evals)``."""
    d = x.shape[1]
    theta0 = torch.cat([hypers.log_ell, hypers.log_sf2[:, None],
                        hypers.log_sn2[:, None], hypers.mean_w], dim=1)
    y_rows = y.mT

    def objective(theta):
        return vfe_nll_batch(*gp_core._unpack(theta, d), z_ind, x, y_rows,
                             cfg, cfg.mean_func)

    theta, values, n_evals = lbfgs.minimize(objective, theta0,
                                            cfg.max_iters, cfg.grad_tol)
    return GPHypers(*gp_core._unpack(theta, d)), values, n_evals


def sparse_posterior(x: torch.Tensor, y: torch.Tensor, z_ind: torch.Tensor,
                     hypers: GPHypers, cfg: GPConfig
                     ) -> gp_core.SparsePosterior:
    """The VFE posterior of all Ny dims (two K5 launches): ``x`` = Z (M,
    D), ``alpha`` = beta (Ny, M), ``inv_k`` = Lambda (Ny, M, M) = K_MM^-1
    - Sigma, ``chol`` = L_M, ``chol_b`` = L_B."""
    l_m, a, l_b, _, sn2 = _factor_terms(hypers.log_ell, hypers.log_sf2,
                                        hypers.log_sn2, z_ind, x, cfg)
    r = y.mT - _mean_rows(x, hypers.mean_w, cfg.mean_func)      # (Ny, N)
    c = tri_solve(l_b, (a @ r[..., None])[..., 0])              # (Ny, M)
    # beta = sigma^-1 L_M^-T L_B^-T c
    beta = tri_solve(l_m, tri_solve(l_b, c, trans=True),
                     trans=True) / torch.sqrt(sn2)[:, None]
    eye = torch.eye(z_ind.shape[0], dtype=x.dtype, device=x.device)
    inv_lm = tri_solve(l_m, eye.expand(l_m.shape))              # L_M^-1
    w = tri_solve(l_b, inv_lm)                                  # L_B^-1 L_M^-1
    lam = inv_lm.mT @ inv_lm - w.mT @ w                         # K_MM^-1 - Sigma
    return gp_core.SparsePosterior(x=z_ind, chol=l_m, alpha=beta, inv_k=lam,
                                   hypers=hypers, chol_b=l_b)
