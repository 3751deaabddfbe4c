"""SE-ARD covariance kernels — the GP compute core.

Counterpart of ``gpmpc_tpu/ops/kernels.py``:

    k(x, z) = sf2 * exp(-0.5 * sum_i (x_i - z_i)^2 / ell_i^2)

Shapes: N, M = numbers of points, D = input dim.  Only the SE family is
ported; the Matérn families are ROADMAP slice F.  The Gram goes through
K4 (``ops/gp_cuda.py``): the CUDA kernel for CUDA tensors, its plain
version for CPU tensors, with the same plain-PyTorch derivatives on both.
"""

from __future__ import annotations

import torch

from gpmpc_tpu_torch.ops import gp_cuda

#: supported kernel families (GPConfig.kernel) in this package
KERNELS = ("se",)


def sq_maha(x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Pairwise squared Euclidean distances, (N, D) x (M, D) -> (N, M).

    The same f32/f64 op-order split as the JAX version: in f32 a
    single-point side uses the exact broadcast subtraction; otherwise (and
    always in f64, whose op order the x64 goldens pin) the norm expansion
    ||x||^2 + ||z||^2 - 2 x.z, clamped at zero against cancellation.  The
    package turns TF32 off, so the cross matmul runs in full f32."""
    if (x.shape[0] == 1 or z.shape[0] == 1) and x.dtype != torch.float64:
        d = x[:, None, :] - z[None, :, :]                # (N, M, D)
        return torch.sum(d * d, dim=-1)
    x2 = torch.sum(x * x, dim=-1, keepdim=True)          # (N, 1)
    z2 = torch.sum(z * z, dim=-1, keepdim=True).T        # (1, M)
    cross = x @ z.T
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


def kernel_cross(name: str, x: torch.Tensor, z: torch.Tensor,
                 ell: torch.Tensor, sf2: torch.Tensor) -> torch.Tensor:
    """Cross-covariance for the named kernel family: (N, D), (M, D) -> (N, M)."""
    if name == "se":
        return se_ard_cross(x, z, ell, sf2)
    raise NotImplementedError(
        f"kernel {name!r} is not ported yet (ROADMAP slice F item 2: "
        f"Matérn-5/2 and -3/2); supported: {KERNELS}")


def kernel_gram(name: str, x: torch.Tensor, ell: torch.Tensor,
                sf2: torch.Tensor, sn2=0.0, jitter: float = 0.0
                ) -> torch.Tensor:
    """Gram for the named kernel family, diagonal written exactly; shapes
    as :func:`se_ard_gram`."""
    if name == "se":
        return se_ard_gram(x, ell, sf2, sn2, jitter)
    raise NotImplementedError(
        f"kernel {name!r} is not ported yet (ROADMAP slice F item 2: "
        f"Matérn-5/2 and -3/2); supported: {KERNELS}")
