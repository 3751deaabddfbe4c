"""Functional GP core: NLL, hyperparameter training, posterior, prediction.

Counterpart of ``gpmpc_tpu/models/gp_core.py``: per output dim d,
K = K_SE + sn2*I, L = chol(K), alpha = K^{-1}(y - m(X)),
NLL = 0.5 y^T alpha + sum(log diag L) + (N/2) log 2pi plus log-space priors,
minimized over the log hypers with multistart L-BFGS;
mu = m(z) + k*^T alpha, var = sf2 - ||L^{-1} k*||^2.  Inputs are in
*normalized* space (the :class:`~gpmpc_tpu_torch.models.gp.GP` wrapper owns
normalization).

Every function here carries a leading problem dim where the JAX package
maps or vmaps: one NLL evaluation of the whole (multistart x Ny) training
grid is one Gram (K4) and one Cholesky (K5) launch on the card, a
posterior one K4 and three K5 launches, a batched prediction one K3
launch.  The kernel family is ``cfg.kernel``: a Matérn Gram is plain
PyTorch (``ops/kernels.py``), so a Matérn NLL evaluation is one K5 launch
and a Matérn posterior three, with no K4.  :func:`fit` takes another
objective of the same batched signature (``nll_fn``, the sparse GP's VFE
bound, two K5 launches an evaluation) and informed extra starts.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
from torch.func import vmap

from gpmpc_tpu_torch.models import lbfgs
from gpmpc_tpu_torch.models.mean_functions import (mean_features, mean_value,
                                                   num_mean_params)
from gpmpc_tpu_torch.ops import gp_cuda
from gpmpc_tpu_torch.ops.chol import chol_solve, tri_solve
from gpmpc_tpu_torch.ops.gp_cuda import cholesky_auto as cholesky_psd
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
    inv_k: torch.Tensor      # (Ny, N, N) explicit inverse (EM, online GP)
    hypers: GPHypers


class ExplicitInversePosterior(GPPosterior):
    """A posterior known only by its explicit inverse: the online GP's
    (``parallel/online_gp.py::as_gp_posterior``), whose bordered updates
    keep K^-1 and no factor, so ``chol`` is None.  Its variance is sf2 -
    k*' K^-1 k*, the JAX package's form; every other posterior keeps a
    factor's form."""

    __slots__ = ()


class SparsePosterior(NamedTuple):
    """The sparse VFE posterior (``models/sparse.py::sparse_posterior``),
    the JAX package's drop-in ``GPPosterior`` with x = Z (M, D), chol = L_M
    = chol(K_MM), alpha = beta and inv_k = Lambda = K_MM^-1 - Sigma (EM
    reads it), plus ``chol_b`` = L_B = chol(I + A A') (Ny, M, M).

    Its variance sf2 - k*' Lambda k* is formed as sf2 - ||L_M^-1 k*||^2 +
    ||L_B^-1 L_M^-1 k*||^2 by two triangular solves, not with the explicit
    Lambda: in f32 the explicit form carries cond(K_MM) into the rounding
    and the variance near the data is noise, as for the exact GP
    (:func:`predict`).  In f64 the two forms agree within ~1e-12 of
    sf2."""

    x: torch.Tensor
    chol: torch.Tensor
    alpha: torch.Tensor
    inv_k: torch.Tensor
    hypers: GPHypers
    chol_b: torch.Tensor


def _noise_var(log_sn2: torch.Tensor, cfg: GPConfig) -> torch.Tensor:
    return torch.exp(log_sn2) + cfg.min_noise


def _jitter_floor(cfg: GPConfig, dtype) -> float:
    """Dtype-aware jitter floor (~50 ulps of the signal variance): the f32
    Gram carries ~eps*sf2*N rounding from the norms-minus-cross-products
    form, which a fixed 1e-8-scale jitter cannot cover."""
    return max(cfg.jitter, 50.0 * float(torch.finfo(dtype).eps))


def _mean_rows(x: torch.Tensor, mean_w: torch.Tensor, kind: str
               ) -> torch.Tensor:
    """m(x; w_p) for P weight rows: x (N, D), mean_w (P, F) -> (P, N)."""
    if kind == "zero":
        return x.new_zeros((mean_w.shape[0], x.shape[0]))
    return (mean_features(x, kind) @ mean_w.mT).mT


def nll_batch(log_ell: torch.Tensor, log_sf2: torch.Tensor,
              log_sn2: torch.Tensor, mean_w: torch.Tensor, x: torch.Tensor,
              y: torch.Tensor, cfg: GPConfig, mean_func: str) -> torch.Tensor:
    """Negative log marginal likelihood of P problems over one input set:
    log_ell (P, D), log_sf2 and log_sn2 (P,), mean_w (P, F), x (N, D),
    y (P, N) -> (P,).  One Gram and one Cholesky for all P; differentiable
    through ``gp_cuda.SEARDGram`` (a Matérn Gram through plain autograd)
    and ``gp_cuda.Cholesky``."""
    n = x.shape[0]
    sf2 = torch.exp(log_sf2)
    sn2 = _noise_var(log_sn2, cfg)
    k = kernel_gram(cfg.kernel, x, torch.exp(log_ell), sf2, sn2,
                    jitter=_jitter_floor(cfg, x.dtype))
    l = cholesky_psd(k)
    r = y - _mean_rows(x, mean_w, mean_func)
    a = chol_solve(l, r)
    nll = (0.5 * torch.sum(r * a, dim=-1)
           + torch.sum(torch.log(torch.diagonal(l, dim1=-2, dim2=-1)), dim=-1)
           + 0.5 * n * math.log(2.0 * math.pi))
    # the JAX package's log-space priors: a weak 1e-4 floor keeps L-BFGS out
    # of overflow; the ell/sf2 terms carry the calibration priors
    prior = (max(cfg.ell_prior, 1e-4) * torch.sum(log_ell ** 2, dim=-1)
             + 1e-4 * log_sn2 ** 2
             + max(cfg.sf2_prior, 1e-4) * log_sf2 ** 2)
    return nll + prior


def nll_single(log_ell: torch.Tensor, log_sf2: torch.Tensor,
               log_sn2: torch.Tensor, mean_w: torch.Tensor, x: torch.Tensor,
               y: torch.Tensor, cfg: GPConfig, mean_func: str
               ) -> torch.Tensor:
    """Negative log marginal likelihood for ONE output dimension (the JAX
    package's signature): log_ell (D,), log_sf2 and log_sn2 (), mean_w
    (F,), x (N, D), y (N,) -> ()."""
    return nll_batch(log_ell[None], log_sf2[None], log_sn2[None],
                     mean_w[None], x, y[None], cfg, mean_func)[0]


def _init_hypers(generator: torch.Generator, x: torch.Tensor,
                 y: torch.Tensor, n_starts: int, mean_func: str) -> GPHypers:
    """Data-driven multistart initializations (stacked over starts and dims).

    Start 0 is the unperturbed heuristic, as in the JAX package: the
    lengthscales at the per-dim input std, signal variance at var(y), noise
    at var(y)/100.  Later starts perturb it in log space with normals drawn
    from ``generator`` (other numbers than ``jax.random``'s)."""
    n, d = x.shape
    ny = y.shape[1]
    f = num_mean_params(mean_func, d)
    x_std = torch.std(x, dim=0, correction=0) + 1e-8
    y_var = torch.var(y, dim=0, correction=0) + 1e-8
    kw = dict(dtype=x.dtype, device=x.device)
    pert_ell = torch.randn((n_starts, ny, d), generator=generator, **kw) * 0.7
    pert_sf2 = torch.randn((n_starts, ny), generator=generator, **kw) * 0.7
    pert_sn2 = torch.randn((n_starts, ny), generator=generator, **kw) * 1.5
    for pert in (pert_ell, pert_sf2, pert_sn2):
        pert[0] = 0.0                     # start 0: the unperturbed heuristic
    return GPHypers(
        log_ell=torch.log(x_std).expand(ny, d)[None] + pert_ell,
        log_sf2=torch.log(y_var)[None] + pert_sf2,
        log_sn2=(torch.log(y_var) - math.log(100.0))[None] + pert_sn2,
        mean_w=torch.zeros((n_starts, ny, f), **kw))


def _unpack(theta: torch.Tensor, d: int):
    """Rows of packed hypers [log_ell (D) | log_sf2 | log_sn2 | mean_w (F)]
    as (log_ell, log_sf2, log_sn2, mean_w) — the order of the JAX
    package's sorted parameter dict."""
    return theta[:, :d], theta[:, d], theta[:, d + 1], theta[:, d + 2:]


def fit(x: torch.Tensor, y: torch.Tensor, cfg: GPConfig,
        generator: torch.Generator, nll_fn=None,
        extra_starts: GPHypers = None, mesh=None
        ) -> Tuple[GPHypers, torch.Tensor, int]:
    """Train all Ny GPs with multistart; returns the best hypers per dim,
    their final NLLs and the number of batched objective evaluations.

    ``nll_fn`` (the signature of :func:`nll_batch`) swaps the objective:
    ``models/sparse.py`` trains on the VFE bound this way.
    ``extra_starts`` (per-dim hypers, Ny leading) is appended to the
    perturbed starts as one more start.

    The JAX package runs the (multistart x Ny) grid under ``lax.map``, one
    problem at a time, each through ``_run_lbfgs``; here the grid is one
    batch through :func:`gpmpc_tpu_torch.models.lbfgs.minimize`, so each
    objective evaluation is one K4 (SE only) and one K5 launch for all S*Ny
    problems.  Non-finite final values count as +inf and each dim takes its
    best start.

    ``mesh`` (a ``DeviceMesh``, :func:`gpmpc_tpu_torch.parallel.distributed.
    make_study_mesh`) shards the problem grid over its ranks, as the JAX
    package does: the starts are drawn from ``generator`` before sharding,
    so every rank holds the same grid; the grid is padded to a multiple of
    ``mesh.size()`` with copies of problem 0, each rank minimizes its
    contiguous block (on the card one K4 and one K5 launch an evaluation at
    P = the block's size), and the blocks are gathered and the pad dropped
    before each dim takes its best start.  ``n_evals`` is then the most
    batched evaluations any rank made."""
    if mesh is not None:
        # imported here: the parallel package imports this module
        from gpmpc_tpu_torch.parallel import distributed
        distributed.check_mesh(mesh, x.device)
    n, d = x.shape
    ny = y.shape[1]
    s = cfg.multistart
    starts = _init_hypers(generator, x, y, s, cfg.mean_func)
    if extra_starts is not None:
        starts = GPHypers(*(torch.cat([a, b[None].to(a.dtype)])
                            for a, b in zip(starts, extra_starts)))
        s = s + 1
    nll = nll_fn if nll_fn is not None else nll_batch
    theta0 = torch.cat([starts.log_ell.reshape(s * ny, d),
                        starts.log_sf2.reshape(s * ny, 1),
                        starts.log_sn2.reshape(s * ny, 1),
                        starts.mean_w.reshape(s * ny, -1)], dim=1)
    y_rows = y.mT.repeat(s, 1)                    # (S*Ny, N), dim-minor
    total = s * ny
    if mesh is not None:
        pad = (-total) % mesh.size()
        theta0, y_rows = (distributed.local_block(
            torch.cat([a, a[:1].expand((pad,) + a.shape[1:])]), mesh)
            for a in (theta0, y_rows))

    def objective(theta):
        return nll(*_unpack(theta, d), x, y_rows, cfg, cfg.mean_func)

    theta, values, n_evals = lbfgs.minimize(objective, theta0,
                                            cfg.max_iters, cfg.grad_tol)
    if mesh is not None:
        theta = distributed.gather(theta, mesh)[:total]
        values = distributed.gather(values, mesh)[:total]
        n_evals = int(distributed.all_reduce(
            torch.tensor(n_evals, device=x.device), mesh, "max"))
    values = torch.where(torch.isfinite(values), values, torch.inf)
    values = values.reshape(s, ny)
    best = torch.argmin(values, dim=0)                          # (Ny,)
    dims = torch.arange(ny, device=x.device)
    theta = theta.reshape(s, ny, -1)[best, dims]
    return GPHypers(*_unpack(theta, d)), values[best, dims], n_evals


def posterior(x: torch.Tensor, y: torch.Tensor, hypers: GPHypers,
              cfg: GPConfig) -> GPPosterior:
    """Precompute chol/alpha/invK for all Ny dims at once.

    A failed factor (NaN, or finite garbage caught by the reconstruction
    test) is retried at escalating jitter.  The retries run unconditionally
    and are selected with ``torch.where``, as in the JAX version, so both
    packages pick the same factor and no host sync is needed: one Gram and
    three Cholesky launches for the whole posterior."""
    n = x.shape[0]
    ny = hypers.log_sf2.shape[0]
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    jit_floor = _jitter_floor(cfg, x.dtype)
    sf2 = torch.exp(hypers.log_sf2)
    k = kernel_gram(cfg.kernel, x, torch.exp(hypers.log_ell), sf2,
                    _noise_var(hypers.log_sn2, cfg), jitter=jit_floor)

    def try_factor(kk):
        l = cholesky_psd(kk)
        err = (torch.amax(torch.abs(l @ l.mT - kk), dim=(-2, -1))
               / (1.0 + torch.amax(torch.abs(kk), dim=(-2, -1))))
        return l, ~torch.isfinite(l).flatten(-2).all(-1) | (err > 0.1)

    l, bad = try_factor(k)
    for mult in (1e2, 1e4):              # escalate on a failed factor
        l_retry, bad_retry = try_factor(
            k + ((mult * jit_floor) * sf2)[:, None, None] * eye)
        l = torch.where(bad[:, None, None], l_retry, l)
        bad = bad & bad_retry
    r = y.mT - _mean_rows(x, hypers.mean_w, cfg.mean_func)
    inv_l = tri_solve(l, eye.expand(ny, n, n))
    return GPPosterior(x=x, chol=l, alpha=chol_solve(l, r),
                       inv_k=inv_l.mT @ inv_l, hypers=hypers)


def predict_batch(post: GPPosterior, z: torch.Tensor, cfg: GPConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deterministic-input predictive mean/variance of an SE posterior at B
    points at once: z (B, D) -> (mu (B, Ny), var (B, Ny)), what the JAX
    package gets from ``vmap(predict)``.  k* and k* alpha for every point
    and dim are one K3 launch; the variance is sf2 - ||L^-1 k*^T||^2 by one
    batched triangular solve, as in :func:`predict` (plus ||L_B^-1 L^-1
    k*^T||^2 for a :class:`SparsePosterior`), or for an
    :class:`ExplicitInversePosterior` sf2 - k* inv_k k*^T.
    :func:`predict_points` picks this route."""
    h = post.hypers
    sf2 = torch.exp(h.log_sf2)
    mu, ks = gp_cuda.gp_predict_batch(
        z.contiguous(), post.x.contiguous(), torch.exp(h.log_ell).contiguous(),
        sf2.contiguous(), post.alpha.contiguous())
    mu = _mean_rows(z, h.mean_w, cfg.mean_func) + mu              # (Ny, B)
    if isinstance(post, ExplicitInversePosterior):
        quad = torch.sum(ks * (post.inv_k @ ks.mT).mT, dim=-1)    # (Ny, B)
    else:
        v = torch.linalg.solve_triangular(post.chol, ks.mT, upper=False)
        quad = torch.sum(v * v, dim=-2)
        if isinstance(post, SparsePosterior):
            vb = torch.linalg.solve_triangular(post.chol_b, v, upper=False)
            quad = quad - torch.sum(vb * vb, dim=-2)
    var = sf2[:, None] - quad
    if cfg.predict_includes_noise:
        var = var + _noise_var(h.log_sn2, cfg)[:, None]
    return mu.mT, torch.clamp(var, min=0.0).mT


def predict_points(post: GPPosterior, z: torch.Tensor, cfg: GPConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deterministic-input predictive mean/variance at B points: z (B, D)
    -> (mu (B, Ny), var (B, Ny)), the JAX package's ``vmap(predict)``.
    An SE posterior goes through :func:`predict_batch` (one K3 launch on
    the card; under ``vmap`` over lanes one launch for all of them, with
    per-lane posteriors too); a Matérn posterior maps :func:`predict` over
    the points, since K3 computes SE-ARD only."""
    if cfg.kernel == "se":
        return predict_batch(post, z, cfg)
    return vmap(lambda zz: predict(post, zz, cfg))(z)


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
    1.4e-3).  In f64 the two forms agree to ~1e-12 of sf2.

    An :class:`ExplicitInversePosterior` (the online GP) has no factor: its
    variance is the explicit-inverse form, selected by its type; a
    :class:`SparsePosterior`'s adds ||L_B^-1 L_M^-1 k*||^2 to the factor's
    form."""
    explicit = isinstance(post, ExplicitInversePosterior)
    sparse = isinstance(post, SparsePosterior)

    def one(log_ell, log_sf2, log_sn2, mean_w, alpha, mat, mat_b):
        ks = kernel_cross(cfg.kernel, z[None, :], post.x, torch.exp(log_ell),
                          torch.exp(log_sf2))[0]                    # (N,)
        mu = mean_value(z, mean_w, cfg.mean_func) + torch.dot(ks, alpha)
        if explicit:
            var = torch.exp(log_sf2) - torch.dot(ks, mat @ ks)     # K^-1
        else:
            v = tri_solve(mat, ks)                                  # L^-1 k*
            var = torch.exp(log_sf2) - torch.dot(v, v)
            if sparse:
                vb = tri_solve(mat_b, v)
                var = var + torch.dot(vb, vb)
        if cfg.predict_includes_noise:
            var = var + _noise_var(log_sn2, cfg)
        return mu, torch.maximum(var, torch.zeros_like(var))

    h = post.hypers
    mat = post.inv_k if explicit else post.chol
    return vmap(one)(h.log_ell, h.log_sf2, h.log_sn2, h.mean_w, post.alpha,
                     mat, post.chol_b if sparse else mat)
