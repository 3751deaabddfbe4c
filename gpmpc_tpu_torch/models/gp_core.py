"""Functional GP core: posterior and prediction.

Counterpart of ``gpmpc_tpu/models/gp_core.py`` for serving a GP with given
hyperparameters: per output dim d, K = K_SE + sn2*I, L = chol(K),
alpha = K^{-1}(y - m(X)); mu = m(z) + k*^T alpha, var = sf2 - ||L^{-1} k*||^2.
Inputs are in *normalized* space (the :class:`~gpmpc_tpu_torch.models.gp.GP`
wrapper owns normalization).  Hyperparameter training is ROADMAP slice C.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch.func import vmap

from gpmpc_tpu_torch.models.mean_functions import mean_value
from gpmpc_tpu_torch.ops.chol import chol_solve, cholesky_psd, tri_solve
from gpmpc_tpu_torch.ops.kernels import kernel_cross, kernel_gram
from gpmpc_tpu_torch.utils.config import GPConfig


class GPHypers(NamedTuple):
    """Stacked hyperparameters, one row per output dimension (Ny leading)."""

    log_ell: torch.Tensor    # (Ny, D) log lengthscales
    log_sf2: torch.Tensor    # (Ny,)   log signal variance
    log_sn2: torch.Tensor    # (Ny,)   log noise variance
    mean_w: torch.Tensor     # (Ny, F) mean-function weights (F may be 0)

    @property
    def ell(self):
        return torch.exp(self.log_ell)

    @property
    def sf2(self):
        return torch.exp(self.log_sf2)

    @property
    def sn2(self):
        return torch.exp(self.log_sn2)


class GPPosterior(NamedTuple):
    """Precomputed per-dim factorizations."""

    x: torch.Tensor          # (N, D) training inputs (normalized)
    chol: torch.Tensor       # (Ny, N, N) lower Cholesky of K + sn2 I
    alpha: torch.Tensor      # (Ny, N) K^{-1} (y - m(X))
    inv_k: torch.Tensor      # (Ny, N, N) explicit inverse (online GP, slice D)
    hypers: GPHypers


def _noise_var(log_sn2: torch.Tensor, cfg: GPConfig) -> torch.Tensor:
    return torch.exp(log_sn2) + cfg.min_noise


def _jitter_floor(cfg: GPConfig, dtype) -> float:
    """Dtype-aware jitter floor (~50 ulps of the signal variance): the f32
    Gram carries ~eps*sf2*N rounding from the norms-minus-cross-products
    form, which a fixed 1e-8-scale jitter cannot cover."""
    return max(cfg.jitter, 50.0 * float(torch.finfo(dtype).eps))


def posterior(x: torch.Tensor, y: torch.Tensor, hypers: GPHypers,
              cfg: GPConfig) -> GPPosterior:
    """Precompute per-dim chol/alpha/invK.

    A failed factor (NaN, or finite garbage caught by the reconstruction
    test) is retried at escalating jitter.  The retries run unconditionally
    and are selected with ``torch.where``, as in the JAX version, so both
    packages pick the same factor and no host sync is needed."""
    n = x.shape[0]
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    jit_floor = _jitter_floor(cfg, x.dtype)

    def try_factor(kk):
        l = cholesky_psd(kk)
        err = torch.max(torch.abs(l @ l.T - kk)) / (1.0 + torch.max(torch.abs(kk)))
        return l, (~torch.all(torch.isfinite(l))) | (err > 0.1)

    chols, alphas, inv_ks = [], [], []
    for d in range(hypers.log_sf2.shape[0]):
        sn2 = _noise_var(hypers.log_sn2[d], cfg)
        sf2 = torch.exp(hypers.log_sf2[d])
        k = kernel_gram(cfg.kernel, x, torch.exp(hypers.log_ell[d]), sf2, sn2,
                        jitter=jit_floor)
        l, bad = try_factor(k)
        for mult in (1e2, 1e4):          # escalate on a failed factor
            l_retry, bad_retry = try_factor(k + (mult * jit_floor) * sf2 * eye)
            l = torch.where(bad, l_retry, l)
            bad = bad & bad_retry
        r = y[:, d] - mean_value(x, hypers.mean_w[d], cfg.mean_func)
        inv_l = tri_solve(l, eye)
        chols.append(l)
        alphas.append(chol_solve(l, r))
        inv_ks.append(inv_l.T @ inv_l)
    return GPPosterior(x=x, chol=torch.stack(chols), alpha=torch.stack(alphas),
                       inv_k=torch.stack(inv_ks), hypers=hypers)


def predict_mean(post: GPPosterior, z: torch.Tensor, cfg: GPConfig
                 ) -> torch.Tensor:
    """Predictive mean at z, (D,) -> (Ny,): m(z) + k*^T alpha.  The
    dynamics and their derivatives need only this, so they skip the
    variance's triangular solves."""
    def one(log_ell, log_sf2, mean_w, alpha):
        ks = kernel_cross(cfg.kernel, z[None, :], post.x, torch.exp(log_ell),
                          torch.exp(log_sf2))[0]                    # (N,)
        return mean_value(z, mean_w, cfg.mean_func) + torch.dot(ks, alpha)

    h = post.hypers
    return vmap(one)(h.log_ell, h.log_sf2, h.mean_w, post.alpha)


def predict(post: GPPosterior, z: torch.Tensor, cfg: GPConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deterministic-input predictive mean/variance at z: (D,) -> ((Ny,), (Ny,)).

    The variance is sf2 - ||L^-1 k*||^2 with a triangular solve per output
    dim, not the JAX package's sf2 - k*^T K^-1 k* with the explicit
    inverse.  Near the data both are a small difference of terms of size
    sf2, but the explicit inverse carries cond(K) into the rounding: on the
    four-tank fixture in f32 (cond(K) ~ 1e4, honest variance ~1e-4 sf2; measured on a CPU)
    the explicit-inverse variance is rounding noise (median relative error
    1.2 along a closed-loop trajectory, most values clamped to zero), which
    the chance tightening turns into chattering inputs; the triangular
    solve carries only cond(L) = sqrt(cond(K)) (median relative error
    1.4e-3).  In f64 the two forms agree to ~1e-12 of sf2."""
    def one(log_ell, log_sf2, log_sn2, mean_w, alpha, chol):
        ks = kernel_cross(cfg.kernel, z[None, :], post.x, torch.exp(log_ell),
                          torch.exp(log_sf2))[0]                    # (N,)
        mu = mean_value(z, mean_w, cfg.mean_func) + torch.dot(ks, alpha)
        v = tri_solve(chol, ks)                                     # L^-1 k*
        var = torch.exp(log_sf2) - torch.dot(v, v)
        if cfg.predict_includes_noise:
            var = var + _noise_var(log_sn2, cfg)
        return mu, torch.maximum(var, torch.zeros_like(var))

    h = post.hypers
    return vmap(one)(h.log_ell, h.log_sf2, h.log_sn2, h.mean_w,
                     post.alpha, post.chol)
