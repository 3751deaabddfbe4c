"""Cholesky factorization helpers.

Counterpart of ``gpmpc_tpu/ops/chol.py``: the plain Gram factor
(LAPACK/cuSOLVER through ``torch.linalg``; the plain version of K5, which
GP training and the posterior reach through ``gp_cuda.cholesky_auto``),
triangular solves, and the unrolled small-matrix forms the Riccati
sweeps use.  The unrolled forms build their result from Python lists (no
in-place writes), so ``torch.func`` transforms pass through them.
"""

from __future__ import annotations

import torch


def cholesky_psd(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors of SPD matrices (..., N, N).  Like
    ``jnp.linalg.cholesky`` a failed factorization gives NaN (in the whole
    lower triangle) instead of raising, so the posterior's retry logic sees
    it without a host sync."""
    l, info = torch.linalg.cholesky_ex(a)
    ok = (info == 0)[..., None, None]
    return torch.where(ok, l, torch.full_like(l, float("nan")).tril())


def tri_solve(l: torch.Tensor, b: torch.Tensor, *, trans: bool = False,
              lower: bool = True) -> torch.Tensor:
    """Triangular solve L x = b (or L^T x = b with trans=True); b may be a
    vector or a matrix."""
    vec = b.ndim == l.ndim - 1
    rhs = b[..., None] if vec else b
    if trans:
        x = torch.linalg.solve_triangular(l.mT, rhs, upper=lower)
    else:
        x = torch.linalg.solve_triangular(l, rhs, upper=not lower)
    return x[..., 0] if vec else x


def chol_solve(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b given A = L L^T."""
    return tri_solve(l, tri_solve(l, b), trans=True)


def chol_small(a: torch.Tensor, clamp: bool = True) -> torch.Tensor:
    """Unrolled Cholesky for small static n (stage matrices; n <= ~16).

    With ``clamp=False`` a non-PD pivot gives NaN (sqrt of a negative), which
    the Riccati sweep's finiteness flag reads."""
    n = a.shape[-1]
    cols = [[None] * n for _ in range(n)]      # cols[i][j] = l[..., i, j]
    zero = torch.zeros_like(a[..., 0, 0])
    for j in range(n):
        d = a[..., j, j] - sum((cols[j][k] * cols[j][k] for k in range(j)),
                               zero)
        dsqrt = torch.sqrt(torch.clamp(d, min=1e-30) if clamp else d)
        cols[j][j] = dsqrt
        for i in range(j + 1, n):
            s = a[..., i, j] - sum((cols[i][k] * cols[j][k]
                                    for k in range(j)), zero)
            cols[i][j] = s / dsqrt
    rows = [torch.stack([cols[i][j] if cols[i][j] is not None else zero
                         for j in range(n)], dim=-1) for i in range(n)]
    return torch.stack(rows, dim=-2)


def tri_solve_small(l: torch.Tensor, b: torch.Tensor,
                    trans: bool = False) -> torch.Tensor:
    """Unrolled triangular solve L x = b (or L^T x = b); L (..., n, n)
    lower, b (..., n) or (..., n, m)."""
    n = l.shape[-1]
    vec = b.ndim == l.ndim - 1
    if vec:
        b = b[..., None]
    x = [None] * n
    idx = range(n) if not trans else range(n - 1, -1, -1)
    for i in idx:
        acc = b[..., i, :]
        if not trans:
            for k in range(i):
                acc = acc - l[..., i, k, None] * x[k]
        else:
            for k in range(i + 1, n):
                acc = acc - l[..., k, i, None] * x[k]
        x[i] = acc / l[..., i, i, None]
    out = torch.stack(x, dim=-2)
    return out[..., 0] if vec else out


def ge_solve_small(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unrolled general linear solve A X = B for small static n by
    Gauss-Jordan elimination with partial pivoting, for the nonsymmetric
    (I + C J) systems of the parallel Riccati combine.  A (..., n, n), B
    (..., n) or (..., n, k).  A pivot below the dtype's smallest normal is
    replaced by it, as in the JAX version."""
    n = a.shape[-1]
    vec = b.ndim == a.ndim - 1
    if vec:
        b = b[..., None]
    m = torch.cat([a, b.expand(a.shape[:-2] + b.shape[-2:])], dim=-1)
    rows = torch.arange(n, device=a.device)
    tiny = torch.finfo(m.dtype).tiny
    for j in range(n):
        col = torch.where(rows >= j, torch.abs(m[..., :, j]), -torch.inf)
        p = torch.argmax(col, dim=-1)                   # partial pivot
        row_p = torch.take_along_dim(m, p[..., None, None], dim=-2)[..., 0, :]
        row_j = m[..., j, :]
        swap = (rows == j).to(m.dtype) - (rows == p[..., None]).to(m.dtype)
        m = m + swap[..., :, None] * (row_p - row_j)[..., None, :]
        pivot_row = m[..., j, :]
        piv = pivot_row[..., j:j + 1]
        piv = torch.where(torch.abs(piv) > tiny, piv, tiny)
        pivot_row = pivot_row / piv
        factors = torch.where(rows == j, 0.0, m[..., :, j])
        m = m - factors[..., :, None] * pivot_row[..., None, :]
        m = torch.where((rows == j)[:, None], pivot_row[..., None, :], m)
    x = m[..., n:]
    return x[..., 0] if vec else x
