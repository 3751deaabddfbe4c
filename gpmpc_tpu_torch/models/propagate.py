"""Uncertainty propagation through the GP dynamics model.

Counterpart of ``gpmpc_tpu/models/propagate.py``.  Given GP input
z ~ N(mu_z, Sigma_z) with z = [x; u] in raw space:

* ME  (mean equivalent): mu = gp_mean(mu_z), Sigma = diag(gp_var(mu_z)).
* TA  (first-order Taylor, Girard et al. 2003): mean as ME;
  Sigma = diag(gp_var(mu_z)) + J Sigma_z J^T with J = d mu / d z from
  ``torch.func.jacfwd``.
* EM  (exact moment matching, Candela/Girard/Rasmussen 2003; the PILCO
  forms): exact output mean and full output covariance for the SE-ARD
  kernel under a Gaussian input.
* UT  (unscented transform, Ko and Fox 2009): 2D+1 sigma points of the
  input Gaussian through the GP, its predictive variance folded in.
* GH  (Gauss-Hermite tensor grid, or the degree-5 cubature of
  McNamee and Stenger): quadrature of the exact moment integrals, any
  kernel.

Each returns ``(mu_y (Ny,), Sigma_y (Ny,Ny), C (D,Ny))`` with C = cov(z, y).
UT and GH predict at all their points at once through
:func:`gp_core.predict_points`: one K3 launch on the card for an SE
posterior with a Cholesky factor.
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
                         f"(kernel={cfg.kernel!r}); use ME/TA/UT/GH")
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


def _points_mean_var(post: gp_core.GPPosterior, norm: Normalization,
                     cfg: GPConfig, pts: torch.Tensor):
    """Raw-space predictive means and variances at P raw input points,
    (P, D) -> ((P, Ny), (P, Ny)): the JAX package's ``vmap(_raw_mean_var)``
    as one :func:`gp_core.predict_points` (one K3 launch on the card for
    an SE posterior with a factor)."""
    zn = (pts - norm.z_mean) / norm.z_std
    mu_n, var_n = gp_core.predict_points(post, zn, cfg)
    return norm.y_mean + norm.y_std * mu_n, (norm.y_std ** 2) * var_n


#: the sigma points' root jitter, in ulps of the largest input variance
ROOT_JITTER_ULPS = 64


def _sigma_root(s: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of s + j I, s = (scaled) Sigma_z: the sigma
    points' matrix square root.  The JAX package takes j = 1e-12 in f64
    and 1e-8 in f32, which keeps the factor defined at Sigma_z = 0 (the
    t = 0 stage of every rollout).  Here j is at least ROOT_JITTER_ULPS
    ulps of the largest diagonal entry as well: with feedback Sigma_z is
    singular (du = -K dx, rank Nx of Nx + Nu), and in f32 its rounding
    puts eigenvalues ~eps ||Sigma_z|| below zero, past 1e-8, where the
    factor's pivots divide by ~1e-15 (ROADMAP §3, "f32 sigma-point
    root").  In f64 the relative term stays below 1e-12 on every input the
    tests run, so the factor is the JAX package's bit for bit."""
    d = s.shape[-1]
    eps = torch.finfo(s.dtype).eps
    floor = 1e-12 if s.dtype == torch.float64 else 1e-8
    j = torch.clamp(ROOT_JITTER_ULPS * eps * torch.amax(torch.diagonal(s)),
                    min=floor)
    return chol_small(s + j * torch.eye(d, dtype=s.dtype, device=s.device))


def propagate_ut(post: gp_core.GPPosterior, norm: Normalization,
                 cfg: GPConfig, mu_z: torch.Tensor, cov_z: torch.Tensor,
                 *, alpha: float = 1.0, beta: float = 2.0,
                 kappa: float = 0.0
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Unscented-transform propagation: the 2D+1 sigma points of the input
    Gaussian through the posterior mean, the GP's own predictive variance
    folded in as the sigma-point-weighted process noise.  The default
    scaling (alpha=1, kappa=0, beta=2) keeps every covariance weight
    nonnegative, so Sigma_y is PSD by construction."""
    d = mu_z.shape[0]
    kw = dict(dtype=mu_z.dtype, device=mu_z.device)
    lam = alpha * alpha * (d + kappa) - d
    root = _sigma_root((d + lam) * cov_z)
    offsets = torch.cat([torch.zeros((1, d), **kw), root.T, -root.T])
    pts = mu_z[None, :] + offsets                            # (2D+1, D)
    w_m = torch.cat([torch.full((1,), lam / (d + lam), **kw),
                     torch.full((2 * d,), 0.5 / (d + lam), **kw)])
    w_c = w_m.clone()
    w_c[0] += 1.0 - alpha * alpha + beta
    mus, vars_ = _points_mean_var(post, norm, cfg, pts)      # (2D+1, Ny)
    mu = w_m @ mus
    dev = mus - mu[None, :]
    sigma = (dev * w_c[:, None]).T @ dev + torch.diag(w_m @ vars_)
    c = (offsets * w_c[:, None]).T @ dev                     # (D, Ny)
    return mu, sigma, c


#: the tensor Gauss-Hermite grid's largest point count
GH_MAX_POINTS = 20000


def _tensor_gh_rule(d: int, order: int):
    """Tensor-product Gauss-Hermite nodes (order**d, d) and weights for
    N(0, I_d), numpy, as the JAX package builds them: all weights
    positive, exact for polynomials up to per-dim degree 2 order - 1."""
    n_pts = order ** d
    if n_pts > GH_MAX_POINTS:
        raise ValueError(
            f"GH tensor grid has order**D = {order}**{d} = {n_pts} points "
            f"(cap {GH_MAX_POINTS}); lower `order`, use gh_grid='cubature5' "
            "(2 D^2 + 1 points), or gp_method='UT'")
    # probabilists' Hermite: sum_i w_i f(x_i) ~ sqrt(2 pi) E[f(X)], X~N(0,1)
    nodes_1d, w_1d = np.polynomial.hermite_e.hermegauss(order)
    w_1d = w_1d / np.sqrt(2.0 * np.pi)                   # normalized: sum=1
    grids = np.meshgrid(*([nodes_1d] * d), indexing="ij")
    xi = np.stack([g.reshape(-1) for g in grids], axis=-1)      # (P, D)
    wg = np.ones(n_pts)
    for g in np.meshgrid(*([w_1d] * d), indexing="ij"):
        wg = wg * g.reshape(-1)
    return xi, wg


def _cubature5_rule(d: int):
    """Degree-5 fully symmetric cubature for N(0, I_d) in 2 d^2 + 1 points
    (McNamee and Stenger 1967), numpy, as the JAX package builds it: the
    origin, +-sqrt(d+2) e_i and sqrt((d+2)/2)(+-e_i +- e_j).  Exact for
    every polynomial of total degree <= 5; its axial weight
    (4-d)/(2(d+2)^2) is negative for d > 4, so the caller floors Sigma_y's
    eigenvalues there."""
    w0 = 2.0 / (d + 2.0)
    w1 = (4.0 - d) / (2.0 * (d + 2.0) ** 2)
    w2 = 1.0 / (d + 2.0) ** 2
    pts = [np.zeros((1, d))]
    wts = [np.full(1, w0)]
    r1 = np.sqrt(d + 2.0)
    eye = np.eye(d)
    pts += [r1 * eye, -r1 * eye]
    wts += [np.full(d, w1), np.full(d, w1)]
    r2 = np.sqrt((d + 2.0) / 2.0)
    iu, ju = np.triu_indices(d, k=1)
    for sa, sb in ((1, 1), (1, -1), (-1, 1), (-1, -1)):
        pts.append(r2 * (sa * eye[iu] + sb * eye[ju]))
        wts.append(np.full(iu.shape[0], w2))
    return np.concatenate(pts, axis=0), np.concatenate(wts)


@functools.lru_cache(maxsize=None)
def _gh_rule(d: int, order: int, cubature: bool, dtype: torch.dtype,
             device: torch.device):
    """A rule's nodes and weights as tensors on ``device``: built once, so
    a stage's GH copies nothing to the card."""
    xi, wg = _cubature5_rule(d) if cubature else _tensor_gh_rule(d, order)
    return (torch.as_tensor(xi, dtype=dtype, device=device),
            torch.as_tensor(wg, dtype=dtype, device=device))


#: sweeps of the Jacobi eigensolver behind the cubature5 PSD floor: the
#: cyclic method converges quadratically; on random symmetric matrices 7
#: sweeps took Ny <= 10 and 8 took Ny = 12 to rounding in f64, so 10 leave
#: a margin (tests/test_torch_propagate_ut_gh.py holds Ny = 4, 6 and 8
#: against numpy's eigh)
JACOBI_SWEEPS = 10


@functools.lru_cache(maxsize=None)
def _jacobi_rounds(n: int, device: torch.device):
    """The round-robin order of the n(n-1)/2 index pairs: rounds of
    disjoint pairs (p < q), each round one orthogonal rotation of the whole
    matrix, as index tensors on ``device`` (the rows and columns of the
    rotation's four entries per pair, and p and q)."""
    m = n + n % 2
    players = list(range(m))
    rounds = []
    for _ in range(m - 1):
        pairs = [(min(a, b), max(a, b)) for a, b in
                 zip(players[:m // 2], players[::-1][:m // 2])
                 if a < n and b < n]
        p = torch.tensor([a for a, _ in pairs], device=device)
        q = torch.tensor([b for _, b in pairs], device=device)
        rounds.append((p, q, torch.cat([p, q, p, q]),
                       torch.cat([p, q, q, p])))
        players = [players[0], players[-1]] + players[1:-1]
    return rounds


def psd_floor(sigma: torch.Tensor) -> torch.Tensor:
    """V max(L, 0) V' of a symmetric (n, n) matrix with eigenvalues L and
    eigenvectors V: what the JAX package takes through ``jnp.linalg.eigh``,
    here by JACOBI_SWEEPS fixed sweeps of the cyclic Jacobi method in the
    round-robin order, branch-free.  ``torch.linalg.eigh`` checks its
    result on the host on a CUDA tensor; this reads nothing back, so a
    solve step stays free of host syncs."""
    n = sigma.shape[-1]
    eye = torch.eye(n, dtype=sigma.dtype, device=sigma.device)
    a, v = sigma, eye
    rounds = _jacobi_rounds(n, sigma.device)
    for _ in range(JACOBI_SWEEPS):
        for p, q, rows, cols in rounds:
            # the rotation that zeroes a[p, q] (Golub and Van Loan's
            # sym.schur2); none where it is zero already
            app, aqq, apq = a[p, p], a[q, q], a[p, q]
            zero = apq == 0.0
            tau = (aqq - app) / (2.0 * torch.where(zero, 1.0, apq))
            t = torch.where(tau >= 0.0, 1.0, -1.0) / (
                tau.abs() + torch.sqrt(1.0 + tau * tau))
            t = torch.where(zero, 0.0, t)
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = t * c
            j = eye.index_put((rows, cols), torch.cat([c, c, s, -s]))
            a = j.mT @ a @ j
            v = v @ j
    evals = torch.diagonal(a)
    return (v * torch.clamp(evals, min=0.0)) @ v.mT


def propagate_gh(post: gp_core.GPPosterior, norm: Normalization,
                 cfg: GPConfig, mu_z: torch.Tensor, cov_z: torch.Tensor,
                 *, order: int = 3, grid: str = "auto"
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gauss-Hermite / cubature moment matching: quadrature of
    mu_y = E[mu(z)], Sigma_y = Cov[mu(z)] + E[diag(var(z))] and
    C = Cov[z, mu(z)] under z ~ N(mu_z, Sigma_z), for any kernel.

    ``grid``: ``'tensor'``, the order**D Gauss-Hermite grid (all weights
    positive, Sigma_y PSD by construction; at most GH_MAX_POINTS points);
    ``'cubature5'``, the degree-5 cubature in 2 D^2 + 1 points, whose
    negative axial weights for D > 4 make this floor Sigma_y's eigenvalues
    at 0 (:func:`psd_floor`); ``'auto'``, the tensor grid while order**D
    <= 1000, above that cubature5 when order <= 3 (an explicitly higher
    order keeps the tensor grid and meets its cap)."""
    d = mu_z.shape[0]
    if grid not in ("auto", "tensor", "cubature5"):
        raise ValueError(f"gh_grid must be 'auto'|'tensor'|'cubature5'; "
                         f"got {grid!r}")
    use_cub = (grid == "cubature5"
               or (grid == "auto" and order <= 3 and order ** d > 1000))
    xi, wg = _gh_rule(d, order, use_cub, mu_z.dtype, mu_z.device)
    root = _sigma_root(cov_z)                                # lower
    offsets = xi @ root.T                                    # (P, D)
    pts = mu_z[None, :] + offsets
    mus, vars_ = _points_mean_var(post, norm, cfg, pts)      # (P, Ny)
    mu = wg @ mus
    dev = mus - mu[None, :]
    sigma = (dev * wg[:, None]).T @ dev + torch.diag(wg @ vars_)
    if use_cub and d > 4:       # negative axial weights only for d > 4
        sigma = psd_floor(0.5 * (sigma + sigma.T))
    c = (offsets * wg[:, None]).T @ dev                      # (D, Ny)
    return mu, sigma, c


PROPAGATORS = {
    "ME": propagate_me,
    "TA": propagate_ta,
    "EM": propagate_em,
    "UT": propagate_ut,
    "GH": propagate_gh,
}


def get_propagator(method: str):
    """Select the propagation scheme ('ME' | 'TA' | 'EM' | 'UT' | 'GH')."""
    try:
        return PROPAGATORS[method.upper()]
    except KeyError:
        raise ValueError(
            f"unknown gp_method {method!r}; expected ME, TA, EM, UT, or GH"
        ) from None
