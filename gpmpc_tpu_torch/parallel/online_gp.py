"""Online (streaming) GP conditioning with fixed-capacity posteriors.

Counterpart of ``gpmpc_tpu/parallel/online_gp.py``.  The posterior is
padded to a static ``capacity``: unused slots hold sentinel inputs far away
in normalized space (kernel values underflow to exactly 0) and identity
rows in the precision matrix, so

    K_pad = blkdiag(K_n, I)   =>   invK_pad = blkdiag(invK_n, I),

and padded predictions equal the unpadded ones.  Conditioning on a new
point at slot m = count is a bordered inverse (Schur-complement) update:

    invK' = [[invK + w w'/s, -w/s], [-w'/s, 1/s]],
    w = invK k,  s = kappa - k'w,

O(C^2) in matrix-vector products and one outer product per output dim.

Everything is fixed-shape and free of host syncs, and every function is
written for one rollout so that ``torch.func.vmap`` batches it: the slot
``idx`` is a tensor that differs from rollout to rollout, so slot reads
are ``gather``s and slot writes are ``torch.where`` on ``rows == idx``,
never Python indexing by a value.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch.func import vmap

from gpmpc_tpu_torch.models import gp_core
from gpmpc_tpu_torch.models.mean_functions import mean_value
from gpmpc_tpu_torch.models.propagate import Normalization
from gpmpc_tpu_torch.ops.kernels import kernel_cross

_SENTINEL = 1e6  # normalized-space position of unused slots


class OnlinePosterior(NamedTuple):
    """Fixed-capacity GP posterior (tensors only; the leaf order is the JAX
    package's, which ``batched.save_study`` checkpoints rely on)."""

    x: torch.Tensor        # (C, D) normalized inputs (sentinel-padded)
    y: torch.Tensor        # (C, Ny) normalized targets (zero-padded)
    inv_k: torch.Tensor    # (Ny, C, C) padded inverse of K + sn2 I
    alpha: torch.Tensor    # (Ny, C) invK (y - m(X)) (zero on unused slots)
    count: torch.Tensor    # () int32 number of live points
    log_ell: torch.Tensor  # (Ny, D)
    log_sf2: torch.Tensor  # (Ny,)
    sn2: torch.Tensor      # (Ny,) noise variance incl. floor
    mean_w: torch.Tensor   # (Ny, F) prior-mean weights (F=0 for 'zero')


def from_gp(gp, capacity: int) -> Tuple[OnlinePosterior, Normalization]:
    """Pad a trained :class:`gpmpc_tpu_torch.models.gp.GP` posterior to
    ``capacity``.  The trained prior mean rides along frozen (``mean_w``):
    ``alpha`` is residual-based, as in ``gp_core.posterior``."""
    if getattr(gp, "inducing", None):
        # the bordered-inverse update assumes post.inv_k is the data-space
        # precision (K + sn2 I)^-1, which a sparse posterior's is not
        raise ValueError("online conditioning requires a full (non-sparse) "
                         f"GP; got inducing={gp.inducing} — train without "
                         "`inducing`")
    n, d = gp.Xn.shape
    ny = gp.Ny
    if capacity < n:
        raise ValueError(f"capacity {capacity} < training size {n}")
    kw = dict(dtype=gp.Xn.dtype, device=gp.Xn.device)
    c = int(capacity)
    x_pad = torch.full((c, d), _SENTINEL, **kw)
    x_pad[:n] = gp.Xn
    y_pad = torch.zeros((c, ny), **kw)
    y_pad[:n] = gp.Yn
    invk_pad = torch.eye(c, **kw).repeat(ny, 1, 1)
    invk_pad[:, :n, :n] = gp.post.inv_k
    invk_pad[:, n:, :n] = 0.0
    alpha_pad = torch.zeros((ny, c), **kw)
    alpha_pad[:, :n] = gp.post.alpha
    sn2 = torch.exp(gp.hyper.log_sn2) + gp.cfg.min_noise
    post = OnlinePosterior(
        x=x_pad, y=y_pad, inv_k=invk_pad, alpha=alpha_pad,
        count=torch.tensor(n, dtype=torch.int32, device=kw["device"]),
        log_ell=gp.hyper.log_ell, log_sf2=gp.hyper.log_sf2, sn2=sn2,
        mean_w=gp.hyper.mean_w)
    return post, gp.norm


def as_gp_posterior(post: OnlinePosterior) -> gp_core.ExplicitInversePosterior:
    """View an OnlinePosterior as a GP posterior so the ME/TA/EM
    propagation stack runs on it.  The view is a
    :class:`gp_core.ExplicitInversePosterior`: it has no Cholesky factor
    (``chol`` is None), and its type makes ``gp_core.predict`` take the
    variance from ``inv_k``."""
    hypers = gp_core.GPHypers(log_ell=post.log_ell, log_sf2=post.log_sf2,
                              log_sn2=torch.log(post.sn2),
                              mean_w=post.mean_w)
    return gp_core.ExplicitInversePosterior(
        x=post.x, chol=None, alpha=post.alpha, inv_k=post.inv_k,
        hypers=hypers)


def _mean_n(post: OnlinePosterior, zn, kernel: str, mean_func: str):
    """Normalized predictive mean m(zn) + k*' alpha per output dim."""
    def one(log_ell, log_sf2, alpha, mw):
        ks = kernel_cross(kernel, zn[None], post.x, torch.exp(log_ell),
                          torch.exp(log_sf2))[0]
        return mean_value(zn, mw, mean_func) + torch.dot(ks, alpha)

    return vmap(one)(post.log_ell, post.log_sf2, post.alpha, post.mean_w)


def predict(post: OnlinePosterior, norm: Normalization, z_raw: torch.Tensor,
            kernel: str = "se", mean_func: str = "zero"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw-space predictive mean/variance at one point: (D,) -> ((Ny,),
    (Ny,)).  The variance is the explicit-inverse form sf2 - k*' K^-1 k*
    (the posterior has no factor), in full precision (TF32 stays off)."""
    zn = (z_raw - norm.z_mean) / norm.z_std

    def one(log_ell, log_sf2, inv_k, alpha, mw):
        sf2 = torch.exp(log_sf2)
        ks = kernel_cross(kernel, zn[None], post.x, torch.exp(log_ell),
                          sf2)[0]
        mu = mean_value(zn, mw, mean_func) + torch.dot(ks, alpha)
        var = torch.clamp(sf2 - torch.dot(ks, inv_k @ ks), min=0.0)
        return mu, var

    mu_n, var_n = vmap(one)(post.log_ell, post.log_sf2, post.inv_k,
                            post.alpha, post.mean_w)
    return norm.y_mean + norm.y_std * mu_n, (norm.y_std ** 2) * var_n


def predict_mean(post: OnlinePosterior, norm: Normalization,
                 z_raw: torch.Tensor, kernel: str = "se",
                 mean_func: str = "zero") -> torch.Tensor:
    """Raw-space predictive mean at one point, (D,) -> (Ny,): the mean of
    :func:`predict` without its variance (the MPC dynamics and their
    derivatives need only this)."""
    zn = (z_raw - norm.z_mean) / norm.z_std
    return norm.y_mean + norm.y_std * _mean_n(post, zn, kernel, mean_func)


def mean_fn(post: OnlinePosterior, norm: Normalization, kernel: str = "se",
            mean_func: str = "zero"):
    """Raw-space predictive mean closure z -> (Ny,) (for MPC dynamics)."""
    def f(z):
        return predict_mean(post, norm, z, kernel, mean_func)
    return f


def _slot(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """v[..., idx] for a 0-d index tensor, as a gather (one value per
    leading index), so a batch of rollouts may each have its own idx."""
    i = idx.reshape((1,) * v.ndim).expand(v.shape[:-1] + (1,))
    return torch.gather(v, -1, i.to(torch.int64))[..., 0]


def condition(post: OnlinePosterior, norm: Normalization,
              z_raw: torch.Tensor, y_raw: torch.Tensor,
              novelty_threshold: float = 1e-6, kernel: str = "se",
              policy: str = "saturate",
              mean_func: str = "zero") -> OnlinePosterior:
    """Bayesian update on one observed transition (z, y).

    Bordered Schur-complement inverse update at slot ``count`` and an O(C)
    alpha refresh, as in the JAX package.  The observation is dropped when
    (a) the buffer is full under ``policy='saturate'``, or (b) it fails the
    novelty gate: the prior-conditional variance s = k** - k*' invK k* of
    some output dim is below max(3 sn2, novelty_threshold (sf2 + sn2))
    (the kernel linear-independence test of online sparse GPs, Csato and
    Opper).  A rejected insert leaves the posterior untouched.

    ``policy='fifo'`` keeps adapting past capacity: the oldest live point
    is evicted by an exact downdate of the bordered inverse (its row and
    column reset to the identity padding, its input re-sentineled), then
    the new point takes the freed slot; ``count`` wraps into [C, 2C) so
    the cursor ``count % C`` cycles.  While the buffer fills the downdate
    is a no-op on the virgin slot, so both policies agree until then.
    """
    if policy not in ("saturate", "fifo"):
        raise ValueError(f"policy must be 'saturate' or 'fifo'; "
                         f"got {policy!r}")
    c = post.x.shape[0]
    m = post.count
    full = m >= c
    idx = torch.remainder(m, c) if policy == "fifo" else \
        torch.clamp(m, max=c - 1)

    zn = (z_raw - norm.z_mean) / norm.z_std
    yn = (y_raw - norm.y_mean) / norm.y_std

    rows = torch.arange(c, device=post.x.device)
    is_idx = rows == idx
    at_idx = is_idx[:, None] & is_idx[None, :]
    dtype = post.inv_k.dtype

    inv_k, alpha = post.inv_k, post.alpha
    if policy == "fifo":
        # exact downdate evicting slot idx: without row/col j the inverse
        # is P_~j,~j - q q'/p_jj (q = P[:, j]), and alpha - q alpha_j/p_jj;
        # row/col j masked back to the identity padding (the subtraction
        # leaves last-ulp residuals there).  On a virgin slot (q = e_j,
        # p_jj = 1) every step reproduces its inputs exactly.
        q = _slot(inv_k, idx)                          # (Ny, C)
        pjj = _slot(q, idx)                            # (Ny,)
        inv_e = inv_k - q[:, :, None] * q[:, None, :] / pjj[:, None, None]
        inv_k = torch.where(is_idx[:, None] | is_idx[None, :], 0.0, inv_e) \
            + at_idx.to(dtype)
        alpha = torch.where(is_idx, 0.0,
                            alpha - q * (_slot(alpha, idx) / pjj)[:, None])
        live = (rows < torch.clamp(m, max=c)) & ~is_idx
    else:
        live = rows < m
    # per dim: (k*, w = invK k*, s, gate, e), the accept decision global
    # across dims (the slot is shared)
    ell = torch.exp(post.log_ell)
    sf2 = torch.exp(post.log_sf2)
    sn2 = post.sn2
    ks = vmap(lambda e, s: kernel_cross(kernel, zn[None], post.x, e, s)[0])(
        ell, sf2)                                      # (Ny, C)
    ks = torch.where(live, ks, 0.0)   # the evicted slot (fifo) masked too
    w = (inv_k @ ks[:, :, None])[..., 0]               # zero beyond m
    s_raw = sf2 + sn2 - torch.sum(ks * w, dim=-1)
    ok = s_raw > torch.maximum(3.0 * sn2, novelty_threshold * (sf2 + sn2))
    s = torch.maximum(s_raw, 1e-12 * (sf2 + sn2))
    # border vector w_b = [w; -1] at the slot; exact bordered updates:
    #   inv_new = inv_k + w_b w_b'/s - e_idx e_idx',  alpha_new = alpha -
    #   w_b e with e = (r* - k*'alpha)/s, r* = y* - m(z*) (mean frozen)
    wb = torch.where(is_idx, -1.0, w)
    r = yn - vmap(lambda mw: mean_value(zn, mw, mean_func))(post.mean_w)
    e = (r - torch.sum(ks * alpha, dim=-1)) / s
    add = torch.all(ok) if policy == "fifo" else (~full) & torch.all(ok)

    x_new = torch.where(add & is_idx[:, None], zn, post.x)
    y_new = torch.where(add & is_idx[:, None], yn, post.y)
    upd = wb[:, :, None] * (wb[:, None, :] / s[:, None, None]) \
        - at_idx.to(dtype)
    inv_new = torch.where(add, inv_k + upd, post.inv_k)
    alpha_new = torch.where(add, alpha - wb * e[:, None], post.alpha)
    mp1 = m + 1
    if policy == "fifo":
        mp1 = torch.where(mp1 >= 2 * c, mp1 - c, mp1)
    return OnlinePosterior(
        x=x_new, y=y_new, inv_k=inv_new, alpha=alpha_new,
        count=torch.where(add, mp1, m).to(torch.int32),
        log_ell=post.log_ell, log_sf2=post.log_sf2, sn2=post.sn2,
        mean_w=post.mean_w)
