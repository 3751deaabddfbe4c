"""Covariance kernels — the GP compute core.

Counterpart of ``gpmpc_tpu/ops/kernels.py``: the SE-ARD family

    k(x, z) = sf2 * exp(-0.5 * sum_i (x_i - z_i)^2 / ell_i^2)

and the Matérn-ARD families nu = 5/2 and 3/2 (``matern52``, ``matern32``)
in r = ||(x - z) / ell||.  Shapes: N, M = numbers of points, D = input
dim.  The SE Gram goes through K4 (``ops/gp_cuda.py``): the CUDA kernel
for CUDA tensors, its plain version for CPU tensors, with the same
plain-PyTorch derivatives on both.  The Matérn Gram is plain PyTorch on
every device, as it is plain jnp in the JAX package (which has no Pallas
form of it); the Cholesky factor under it is K5 either way.
"""

from __future__ import annotations

import torch

from gpmpc_tpu_torch.ops import gp_cuda

#: supported kernel families (GPConfig.kernel)
KERNELS = ("se", "matern52", "matern32")


def sq_maha(x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Pairwise squared Euclidean distances, (..., N, D) x (..., M, D) ->
    (..., N, M) (a leading problem dim is the JAX package's vmap).

    The same f32/f64 op-order split as the JAX version: in f32 a
    single-point side uses the exact broadcast subtraction; otherwise (and
    always in f64, whose op order the x64 goldens pin) the norm expansion
    ||x||^2 + ||z||^2 - 2 x.z, clamped at zero against cancellation.  The
    package turns TF32 off, so the cross matmul runs in full f32."""
    if (x.shape[-2] == 1 or z.shape[-2] == 1) and x.dtype != torch.float64:
        d = x[..., :, None, :] - z[..., None, :, :]      # (..., N, M, D)
        return torch.sum(d * d, dim=-1)
    x2 = torch.sum(x * x, dim=-1, keepdim=True)          # (..., N, 1)
    z2 = torch.sum(z * z, dim=-1, keepdim=True).mT       # (..., 1, M)
    cross = x @ z.mT
    d2 = x2 + z2 - 2.0 * cross
    return torch.maximum(d2, torch.zeros_like(d2))


def se_ard(x: torch.Tensor, z: torch.Tensor, ell: torch.Tensor,
           sf2: torch.Tensor) -> torch.Tensor:
    """Single-pair SE-ARD kernel value k(x, z); x, z: (D,)."""
    d = (x - z) / ell
    return sf2 * torch.exp(-0.5 * torch.sum(d * d))


def se_ard_cross(x: torch.Tensor, z: torch.Tensor, ell: torch.Tensor,
                 sf2: torch.Tensor) -> torch.Tensor:
    """Cross-covariance matrix K(x, z): (N, D), (M, D) -> (N, M)."""
    return sf2 * torch.exp(-0.5 * sq_maha(x / ell, z / ell))


def se_ard_gram(x: torch.Tensor, ell: torch.Tensor, sf2, sn2=0.0,
                jitter: float = 0.0) -> torch.Tensor:
    """Gram matrix K(X, X) + (sn2 + jitter * sf2) * I with the diagonal
    written exactly (sf2 + sn2 + jitter * sf2): x (N, D), ell (D,) ->
    (N, N); with a leading problem dim, ell (P, D) and sf2, sn2 (P,) (or
    numbers) -> (P, N, N), all P problems in one K4 launch on the card.
    Differentiable in ell, sf2 and sn2 (``gp_cuda.SEARDGram``)."""
    single = ell.ndim == 1
    ells = ell[None] if single else ell
    kw = dict(dtype=x.dtype, device=x.device)
    sf2, sn2 = (torch.as_tensor(v, **kw).expand(ells.shape[0]).contiguous()
                for v in (sf2, sn2))
    k = gp_cuda.SEARDGram.apply(x.contiguous(), ells.contiguous(), sf2, sn2,
                                float(jitter))
    return k[0] if single else k


#: the Matérn families' nu by kernel name (half-integer closed forms)
_MATERN_NU = {"matern52": 2.5, "matern32": 1.5}


def _matern_cross(x: torch.Tensor, z: torch.Tensor, ell: torch.Tensor,
                  sf2, nu: float) -> torch.Tensor:
    """Matérn-ARD cross-covariance, nu in {1.5, 2.5}: (..., N, D),
    (..., M, D) with ell (..., 1, D) broadcast over the points, or (D,) ->
    (..., N, M), times sf2.  One ``sq_maha`` and an elementwise
    polynomial * exp, in the JAX version's op order.  The distance carries
    the floor sqrt(r2 + 1e-36), so the kernel is differentiable at r = 0
    (TA propagation takes ``jacfwd`` through it): the closed forms' odd
    powers of r have bounded derivatives, a bare sqrt(0) a NaN tangent."""
    r2 = sq_maha(x / ell, z / ell)
    r = torch.sqrt(r2 + 1e-36)
    if nu == 1.5:
        c = 1.7320508075688772  # sqrt(3)
        poly = 1.0 + c * r
    else:
        c = 2.23606797749979    # sqrt(5)
        poly = 1.0 + c * r + (5.0 / 3.0) * r2
    return sf2 * poly * torch.exp(-c * r)


def _check_kernel(name: str) -> None:
    if name not in KERNELS:
        raise ValueError(f"unknown kernel {name!r}; supported: {KERNELS}")


def kernel_cross(name: str, x: torch.Tensor, z: torch.Tensor,
                 ell: torch.Tensor, sf2: torch.Tensor) -> torch.Tensor:
    """Cross-covariance for the named kernel family: (N, D), (M, D) -> (N, M)."""
    _check_kernel(name)
    if name == "se":
        return se_ard_cross(x, z, ell, sf2)
    return _matern_cross(x, z, ell, sf2, _MATERN_NU[name])


def kernel_gram(name: str, x: torch.Tensor, ell: torch.Tensor,
                sf2: torch.Tensor, sn2=0.0, jitter: float = 0.0
                ) -> torch.Tensor:
    """Gram for the named kernel family, diagonal written exactly (every
    stationary kernel here has k(x, x) = sf2); shapes as
    :func:`se_ard_gram`.  The SE Gram is K4; a Matérn Gram is the plain
    cross-covariance of all P problems at once (ell (P, D) broadcast as
    (P, 1, D)), its diagonal replaced by sf2 + sn2 + jitter * sf2."""
    _check_kernel(name)
    if name == "se":
        return se_ard_gram(x, ell, sf2, sn2, jitter)
    single = ell.ndim == 1
    ells = ell[None] if single else ell
    kw = dict(dtype=x.dtype, device=x.device)
    sf2, sn2 = (torch.as_tensor(v, **kw).expand(ells.shape[0])
                for v in (sf2, sn2))
    k = _matern_cross(x, x, ells[:, None, :], sf2[:, None, None],
                      _MATERN_NU[name])
    eye = torch.eye(x.shape[0], **kw)
    diag = (sf2 + sn2 + jitter * sf2)[:, None, None]
    k = k * (1.0 - eye) + diag * eye
    return k[0] if single else k
