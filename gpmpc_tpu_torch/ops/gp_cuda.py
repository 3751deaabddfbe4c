"""The GP path's hand-written CUDA kernels, their plain PyTorch versions,
the device-switching wrappers and the autograd functions around them.

Counterpart of the GP half of ``gpmpc_tpu/ops/pallas_kernels.py`` (and of
the routes ``gpmpc_tpu/ops/dispatch.py`` chooses).  Three kernels, CUDA C++
for ``sm_90a`` in ``gpmpc_tpu_torch/csrc/``, built into the one library of
:func:`gpmpc_tpu_torch.ops.cuda_kernels.build_library`:

* K4 ``se_ard_gram`` replaces ``se_ard_gram_pallas``: the SE-ARD Gram
  matrices of P problems over one point set, diagonal written exactly.
* K5 ``cholesky`` replaces ``cholesky_pallas``: lower Cholesky factors of P
  SPD matrices; a non-PD pivot gives NaN.
* K3 ``gp_predict_batch`` replaces ``gp_predict_batch_pallas``: k*(z, X)
  and the mean k* alpha for B queries and all Ny output dims.

Each takes a leading problem dim, so a GP fit evaluates every (start x
output dim) problem with one K4 and one K5 launch.  The wrappers run the
plain version on CPU tensors and launch the kernel on CUDA tensors, or
raise; they count launches in ``cuda_kernels.LAUNCHES``.  ``SEARDGram`` and
``Cholesky`` are ``torch.autograd.Function``s whose forward is the wrapper
and whose backward is plain PyTorch (the JAX package differentiates its
XLA forms; no TPU kernel has a backward), so the CPU tests exercise the
same backward the card runs.  ``check_*`` hold a kernel against its plain
version on the card, for the tests and the smoke script alike.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gpmpc_tpu_torch.ops import cuda_kernels as ck
from gpmpc_tpu_torch.ops.chol import cholesky_psd

#: tolerances of the JAX package's kernel tests (tests/test_pallas.py)
GRAM_TOL = 2e-5
CHOL_TOL = 2e-4          # x max|L|, against the plain version in f64
KS_TOL, MU_TOL = 2e-5, 2e-4

#: K5 factors a matrix of order N <= this on one block, in shared memory,
#: and a larger one by the blocked multi-block path over 32-column panels
#: (csrc/cholesky.cu).  Device ms per call, one-block vs blocked at P=4:
#: N=128 0.0338 vs 0.0401, N=160 0.0496 vs 0.0513, N=200 0.0793 vs 0.0704,
#: N=330 0.2469 vs 0.1156 (P=8 alike; ``chip_smoke.py --k5-paths``, H100
#: 80GB HBM3, 700 W)
CHOL_ONE_BLOCK_MAX_N = 160


# ------------------------------------------------------------- K4: Gram

def se_ard_gram_reference(x, ell, sf2, sn2, jitter: float = 0.0):
    """Plain version of K4: ``ops/kernels.py::se_ard_gram`` with a leading
    problem dim.  x (N, D) shared, ell (P, D), sf2 and sn2 (P,) ->
    (P, N, N) = sf2 exp(-0.5 d2) off the diagonal, sf2 + sn2 + jitter sf2
    on it (d2 by the norm expansion, as ``sq_maha``)."""
    xs = x / ell[:, None, :]                                   # (P, N, D)
    sq = torch.sum(xs * xs, dim=-1)
    d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * (xs @ xs.mT)
    k = sf2[:, None, None] * torch.exp(-0.5 * torch.clamp(d2, min=0.0))
    eye = torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
    diag = sf2 + sn2 + jitter * sf2
    return k * (1.0 - eye) + diag[:, None, None] * eye


#: K4's square tile: the constant ``TILE`` of ``csrc/se_ard_gram.cu`` (a
#: CPU test holds the two equal), the default of the schedule's mirror
GRAM_TILE = 32

#: K4 scales the points by this / ell, so that exp(-d2 / 2) = exp2(-d2'):
#: sqrt(log2(e) / 2), the constant ``SCALE`` of ``csrc/se_ard_gram.cu`` (and
#: of ``csrc/gp_predict_batch.cu``)
GRAM_EXP2_SCALE = math.sqrt(0.5 * math.log2(math.e))

#: K4 stages the features in chunks of this many: the constant ``DCHUNK``
#: of ``csrc/se_ard_gram.cu``; D <= it is one chunk
GRAM_DCHUNK = 256

#: K4's largest N: its kernel indexes one (N, N) matrix in int
GRAM_MAX_N = 46340


def se_ard_gram_pairs_reference(x, ell, sf2, sn2, jitter: float = 0.0,
                                tile: int = GRAM_TILE,
                                chunk: int = GRAM_DCHUNK):
    """K4's tile-pair schedule in plain PyTorch, for the tests only (no path
    of the port calls it): the points scaled by sqrt(log2(e)/2) / ell once;
    per tile pair I <= J of ``tile`` x ``tile`` tiles, sf2 exp2(-d2') with
    d2' the direct difference sum over D, walked in feature chunks of
    ``chunk``, written to (I, J) and, off the diagonal, transposed to
    (J, I); then the diagonal sf2 + sn2 + jitter sf2 exactly.  Arguments
    as :func:`se_ard_gram_reference`."""
    n, d = x.shape
    xs = x * (GRAM_EXP2_SCALE / ell[:, None, :])               # (P, N, D)
    out = torch.empty((ell.shape[0], n, n), dtype=x.dtype, device=x.device)
    for i0 in range(0, n, tile):
        for j0 in range(i0, n, tile):
            a, b = xs[:, i0:i0 + tile], xs[:, j0:j0 + tile]
            d2 = 0.0
            for f0 in range(0, d, chunk):       # the kernel's sum order
                for dim in range(f0, min(f0 + chunk, d)):
                    d2 = d2 + (a[:, :, None, dim] - b[:, None, :, dim]) ** 2
            k = sf2[:, None, None] * torch.exp2(-d2)
            out[:, i0:i0 + tile, j0:j0 + tile] = k
            if j0 != i0:
                out[:, j0:j0 + tile, i0:i0 + tile] = k.mT
    idx = torch.arange(n, device=x.device)
    out[:, idx, idx] = (sf2 + sn2 + jitter * sf2)[:, None]
    return out


def se_ard_gram(x, ell, sf2, sn2, jitter: float = 0.0):
    """K4 wrapper: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors.  Arguments as :func:`se_ard_gram_reference`; on CUDA all
    contiguous float32 on the card."""
    if x.device.type == "cpu":
        return se_ard_gram_reference(x, ell, sf2, sn2, jitter)
    if x.device.type != "cuda":
        raise ValueError(f"se_ard_gram: no kernel for device {x.device}")
    (n, d), p = x.shape, ell.shape[0]
    ck._check_cuda("se_ard_gram", (x, ell, sf2, sn2),
                   dict(x=(n, d), ell=(p, d), sf2=(p,), sn2=(p,)))
    if n > GRAM_MAX_N:
        raise ValueError(f"se_ard_gram: N={n} > {GRAM_MAX_N}, the largest "
                         f"N whose N x N matrix the kernel indexes in int")
    lib = ck.build_library()
    out = torch.empty((p, n, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.gpmpc_se_ard_gram_f32(
            x.data_ptr(), ell.data_ptr(), sf2.data_ptr(), sn2.data_ptr(),
            float(jitter), out.data_ptr(), p, n, d, stream)
    ck._raise_on_error("se_ard_gram", code)
    ck.LAUNCHES["se_ard_gram"] += 1
    return out


class SEARDGram(torch.autograd.Function):
    """K4 with its derivatives: forward :func:`se_ard_gram`; backward the
    analytic derivatives of K with respect to ell, sf2 and sn2 in plain
    PyTorch (the diagonal sf2 + sn2 + jitter sf2 exactly).  x is data and
    gets no gradient."""

    @staticmethod
    def forward(ctx, x, ell, sf2, sn2, jitter):
        k = se_ard_gram(x, ell, sf2, sn2, jitter)
        ctx.save_for_backward(x, ell, sf2, k)
        ctx.jitter = jitter
        return k

    @staticmethod
    def backward(ctx, g):
        x, ell, sf2, k = ctx.saved_tensors
        eye = torch.eye(x.shape[0], dtype=k.dtype, device=k.device)
        w = g * k * (1.0 - eye)                  # off-diagonal g_ij K_ij
        g_diag = torch.diagonal(g, dim1=-2, dim2=-1).sum(-1)
        g_sf2 = w.sum((-2, -1)) / sf2 + (1.0 + ctx.jitter) * g_diag
        # dK_ij/dell_k = K_ij (x_ik - x_jk)^2 / ell_k^3, one input dim at a
        # time so no (P, N, N, D) tensor is formed
        g_ell = torch.stack(
            [(w * (x[:, None, j] - x[None, :, j]) ** 2).sum((-2, -1))
             for j in range(x.shape[1])], dim=-1) / ell ** 3
        return None, g_ell, g_sf2, g_diag, None


# --------------------------------------------------------- K5: Cholesky

#: plain version of K5: the LAPACK/cuSOLVER factor through
#: ``torch.linalg.cholesky_ex``; a failed factorization gives NaN in the
#: whole lower triangle, like ``jnp.linalg.cholesky``.  a (..., N, N).
cholesky_reference = cholesky_psd


def cholesky_blocked_reference(a, nb: int = 32):
    """K5's blocked schedule in plain PyTorch, for the tests only (no path
    of the port calls it): per panel of ``nb`` columns (a) the unblocked
    factor of the diagonal tile, (b) the panel solve P L_kk^T = A below it,
    (c) the trailing update A -= P P^T, then (d) the upper triangle to 0
    and NaN over the whole lower triangle of each matrix that met a
    non-positive or NaN pivot.  a (..., N, N), lower triangle read."""
    n = a.shape[-1]
    l = a.tril().clone()
    bad = torch.zeros(a.shape[:-2], dtype=torch.bool, device=a.device)
    for off in range(0, n, nb):
        end = min(off + nb, n)
        d = l[..., off:end, off:end]                 # (a) diagonal tile
        for j in range(end - off):
            pivot = d[..., j, j].clone()
            bad |= ~(pivot > 0)
            d[..., j, j] = torch.sqrt(pivot)
            d[..., j + 1:, j] /= d[..., j, j, None]
            col = d[..., j + 1:, j]
            d[..., j + 1:, j + 1:] -= col[..., :, None] * col[..., None, :]
        if end == n:
            break
        p = l[..., end:, off:end]                    # (b) panel solve
        for j in range(end - off):
            p[..., :, j] /= d[..., j, j, None]
            p[..., :, j + 1:] -= p[..., :, j, None] * d[..., None, j + 1:, j]
        l[..., end:, end:] -= p @ p.mT               # (c) trailing update
    l = l.tril()                                     # (d) finish
    return torch.where(bad[..., None, None],
                       torch.full_like(l, float("nan")).tril(), l)


def cholesky(a):
    """K5 wrapper: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors.  a (..., N, N); on CUDA contiguous float32 on the card,
    any N.  Reads the lower triangle.  One call counts one launch, however
    many device kernels the blocked path enqueues."""
    if a.device.type == "cpu":
        return cholesky_reference(a)
    if a.device.type != "cuda":
        raise ValueError(f"cholesky: no kernel for device {a.device}")
    if a.ndim < 2 or a.shape[-2] != a.shape[-1] or a.numel() == 0:
        raise ValueError(f"cholesky: needs non-empty (..., N, N), got "
                         f"{tuple(a.shape)}")
    ck._check_cuda("cholesky", (a,), dict(a=tuple(a.shape)))
    n, p = a.shape[-1], a.numel() // (a.shape[-1] * a.shape[-1])
    lib = ck.build_library()
    blocked = n > CHOL_ONE_BLOCK_MAX_N
    out = torch.empty_like(a)
    # the blocked path's per-matrix failure flags and 32 x 32 diagonal-tile
    # scratch (cholesky.cu's panel width)
    flags = torch.zeros(p, dtype=torch.int32,
                        device=a.device) if blocked else None
    work = torch.empty((p, 32, 32), dtype=torch.float32,
                       device=a.device) if blocked else None
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        code = lib.gpmpc_cholesky_f32(
            a.data_ptr(), out.data_ptr(),
            *(None if t is None else t.data_ptr() for t in (flags, work)),
            p, n, int(blocked), stream)
    ck._raise_on_error("cholesky", code)
    ck.LAUNCHES["cholesky"] += 1
    return out


class Cholesky(torch.autograd.Function):
    """K5 with its derivative: forward :func:`cholesky`; backward the
    standard adjoint in plain PyTorch: with P = Phi(L^T Lbar) (the lower
    triangle, diagonal halved), Abar = sym(L^-T P L^-1), by two triangular
    solves.  A NaN factor gives a NaN gradient."""

    @staticmethod
    def forward(ctx, a):
        l = cholesky(a)
        ctx.save_for_backward(l)
        return l

    @staticmethod
    def backward(ctx, g):
        (l,) = ctx.saved_tensors
        phi = (l.mT @ g.tril()).tril()
        phi = phi - 0.5 * torch.diag_embed(torch.diagonal(phi, dim1=-2,
                                                          dim2=-1))
        s = torch.linalg.solve_triangular(l.mT, phi, upper=True)
        s = torch.linalg.solve_triangular(l, s, upper=False, left=False)
        return 0.5 * (s + s.mT)


def cholesky_auto(a):
    """Differentiable lower Cholesky factors of SPD matrices (..., N, N),
    all of them in one K5 launch on the card: the counterpart of
    ``gpmpc_tpu/ops/dispatch.py::cholesky_auto``, by device instead of a
    TPU policy."""
    return Cholesky.apply(a.contiguous())


# ------------------------------------------------------ K3: batched predict

def gp_predict_batch_reference(z, x, ell, sf2, alpha):
    """Plain version of K3: z (B, D) queries, x (N, D) points, ell (Ny, D),
    sf2 (Ny,), alpha (Ny, N) -> (mu (Ny, B), ks (Ny, B, N)) with
    ks = se_ard_cross(z, x, ell_d, sf2_d) per dim and mu = ks alpha."""
    zs = z / ell[:, None, :]                                   # (Ny, B, D)
    xs = x / ell[:, None, :]                                   # (Ny, N, D)
    d2 = (torch.sum(zs * zs, dim=-1)[:, :, None]
          + torch.sum(xs * xs, dim=-1)[:, None, :] - 2.0 * (zs @ xs.mT))
    ks = sf2[:, None, None] * torch.exp(-0.5 * torch.clamp(d2, min=0.0))
    return (ks @ alpha[:, :, None])[..., 0], ks


#: K3 walks the points in tiles of this many (32 lanes x 4) and the
#: features in chunks of ``PREDICT_FC``: the constants ``TILE_N`` and
#: ``FC`` of ``csrc/gp_predict_batch.cu``
PREDICT_TILE_N = 128
PREDICT_FC = 8


def gp_predict_batch_tiles_reference(z, x, ell, sf2, alpha,
                                     tile_n: int = PREDICT_TILE_N,
                                     fc: int = PREDICT_FC):
    """K3's schedule in plain PyTorch, for the tests only (no path of the
    port calls it): queries scaled by s = sqrt(log2(e)/2) / ell, per tile
    of ``tile_n`` points d2' = sum_k (z'_k - x_k s_k)^2 by direct
    differences over features walked in chunks of ``fc`` (the kernel forms
    x_k s_k inside one FMA), k* = sf2 exp2(-d2'); mu as the kernel sums it:
    lane l's partial over its points 4l .. 4l + 3 of every tile, in order,
    then a shuffle butterfly over the 32 lanes.  Arguments as
    :func:`gp_predict_batch_reference`."""
    (b, d), n = z.shape, x.shape[0]
    s = GRAM_EXP2_SCALE / ell                                  # (Ny, D)
    zq = z[None] * s[:, None, :]                               # (Ny, B, D)
    lanes = tile_n // 4
    tiles = -(-n // tile_n)
    xp = torch.zeros((tiles * tile_n, d), dtype=x.dtype, device=x.device)
    xp[:n] = x
    ap = torch.zeros((ell.shape[0], tiles * tile_n), dtype=x.dtype,
                     device=x.device)
    ap[:, :n] = alpha
    ks = torch.empty((ell.shape[0], b, tiles * tile_n), dtype=x.dtype,
                     device=x.device)
    acc = torch.zeros((ell.shape[0], b, lanes), dtype=x.dtype,
                      device=x.device)
    for n0 in range(0, tiles * tile_n, tile_n):
        xt = xp[n0:n0 + tile_n]
        d2 = 0.0
        for f0 in range(0, d, fc):
            for k in range(f0, min(f0 + fc, d)):
                diff = zq[:, :, None, k] - (xt[:, k] * s[:, k, None])[:, None]
                d2 = d2 + diff * diff
        kt = sf2[:, None, None] * torch.exp2(-d2)              # (Ny, B, T)
        ks[:, :, n0:n0 + tile_n] = kt
        prod = (kt * ap[:, None, n0:n0 + tile_n]).reshape(
            ell.shape[0], b, lanes, 4)
        for q in range(4):
            acc = acc + prod[..., q]
    lane = torch.arange(lanes, device=x.device)
    off = lanes // 2
    while off:
        acc = acc + acc[..., lane ^ off]
        off //= 2
    return acc[..., 0], ks[..., :n]


def gp_predict_batch(z, x, ell, sf2, alpha):
    """K3 wrapper: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors.  Arguments as :func:`gp_predict_batch_reference`; on
    CUDA all contiguous float32 on the card, any D."""
    if z.device.type == "cpu":
        return gp_predict_batch_reference(z, x, ell, sf2, alpha)
    if z.device.type != "cuda":
        raise ValueError(f"gp_predict_batch: no kernel for device {z.device}")
    (b, d), n, ny = z.shape, x.shape[0], ell.shape[0]
    ck._check_cuda("gp_predict_batch", (z, x, ell, sf2, alpha),
                   dict(z=(b, d), x=(n, d), ell=(ny, d), sf2=(ny,),
                        alpha=(ny, n)))
    lib = ck.build_library()
    kw = dict(dtype=torch.float32, device=z.device)
    mu = torch.empty((ny, b), **kw)
    ks = torch.empty((ny, b, n), **kw)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        code = lib.gpmpc_gp_predict_batch_f32(
            z.data_ptr(), x.data_ptr(), ell.data_ptr(), sf2.data_ptr(),
            alpha.data_ptr(), mu.data_ptr(), ks.data_ptr(), ny, b, n, d,
            stream)
    ck._raise_on_error("gp_predict_batch", code)
    ck.LAUNCHES["gp_predict_batch"] += 1
    return mu, ks


# ------------------------------------------ kernels against plain versions

def gram_inputs(n, d, p, seed, device=None, ell_scale: float = 1.0):
    """Inputs of the JAX package's Gram test, for ``p`` problems: x (n, d)
    uniform in [-2, 2], ell ~ ell_scale exp(0.3 N(0,1)), sf2 1.7, sn2 0.03,
    f32.  At wide D, ``ell_scale`` = sqrt(D) keeps d2 of order 1
    (unscaled, K underflows to 0 off the diagonal from D ~ 60 on)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, (n, d))
    ell = ell_scale * np.exp(0.3 * rng.standard_normal((p, d)))
    kw = dict(dtype=torch.float32, device=device)
    return (torch.tensor(x, **kw), torch.tensor(ell, **kw),
            torch.full((p,), 1.7, **kw), torch.full((p,), 0.03, **kw))


def spd_inputs(n, p, seed, device=None):
    """``p`` SPD matrices a a^T + n I of the JAX package's Cholesky test,
    f32 (p, n, n)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((p, n, n))
    spd = a @ np.swapaxes(a, -1, -2) + n * np.eye(n)
    return torch.tensor(spd, dtype=torch.float32, device=device)


def predict_inputs(n, d, b, ny, seed, device=None, ell_scale: float = 1.0):
    """Inputs of the JAX package's batched-predict test for ``ny`` dims:
    z (b, d), x (n, d) uniform in [-2, 2], ell ~ ell_scale exp(0.2
    N(0,1)), sf2 1.3, alpha ~ N(0,1), f32.  ``ell_scale`` as in
    :func:`gram_inputs`."""
    rng = np.random.default_rng(seed)
    kw = dict(dtype=torch.float32, device=device)
    return (torch.tensor(rng.uniform(-2, 2, (b, d)), **kw),
            torch.tensor(rng.uniform(-2, 2, (n, d)), **kw),
            torch.tensor(ell_scale * np.exp(0.2 * rng.standard_normal(
                (ny, d))), **kw),
            torch.full((ny,), 1.3, **kw),
            torch.tensor(rng.standard_normal((ny, n)), **kw))


def check_se_ard_gram(x, ell, sf2, sn2, jitter: float = 1e-6) -> float:
    """Launch K4 on CUDA tensors and its plain version on the same tensors;
    raise unless they agree within rtol and atol 2e-5, K4's output is
    exactly symmetric and its diagonal is bitwise sf2 + sn2 + jitter sf2.
    Returns the largest absolute difference."""
    got = se_ard_gram(x, ell, sf2, sn2, jitter)
    ref = se_ard_gram_reference(x, ell, sf2, sn2, jitter)
    err = float((got - ref).abs().max())
    if got.shape != ref.shape or not bool(torch.all(
            (got - ref).abs() <= GRAM_TOL + GRAM_TOL * ref.abs())):
        raise AssertionError(f"se_ard_gram disagrees with its plain version "
                             f"at {tuple(got.shape)}: max|err| {err}")
    diag = (sf2 + sn2 + jitter * sf2)[:, None].expand(-1, x.shape[0])
    if not torch.equal(got, got.mT) or not torch.equal(
            torch.diagonal(got, dim1=-2, dim2=-1), diag):
        raise AssertionError(f"se_ard_gram at {tuple(got.shape)} is not "
                             f"exactly symmetric with the exact diagonal")
    return err


def check_cholesky(a) -> float:
    """Launch K5 on CUDA tensors and hold it against its plain version in
    f64 on the same inputs: atol 2e-4 x max|L|.  Returns the largest
    absolute difference."""
    got = cholesky(a)
    ref = cholesky_reference(a.double())
    err = float((got.double() - ref).abs().max())
    if got.shape != ref.shape or not err <= CHOL_TOL * float(ref.abs().max()):
        raise AssertionError(f"cholesky disagrees with its plain version at "
                             f"{tuple(a.shape)}: max|err| {err}")
    return err


def check_cholesky_not_pd(a) -> None:
    """Raise unless K5 and its plain version both give NaN in the whole
    lower triangle of every matrix of ``a`` (each with a negative pivot)."""
    for l in (cholesky(a), cholesky_reference(a)):
        low = torch.tril(torch.ones_like(l, dtype=torch.bool))
        if not bool(torch.all(torch.isnan(l[low]))):
            raise AssertionError("cholesky gave finite values for a matrix "
                                 "that is not positive definite")


def check_gp_predict_batch(z, x, ell, sf2, alpha) -> float:
    """Launch K3 on CUDA tensors and its plain version on the same tensors;
    raise unless k* agrees within rtol and atol 2e-5 and mu within 2e-4.
    Returns the largest absolute difference of k*."""
    mu, ks = gp_predict_batch(z, x, ell, sf2, alpha)
    mu_r, ks_r = gp_predict_batch_reference(z, x, ell, sf2, alpha)
    err_k = float((ks - ks_r).abs().max())
    err_m = float((mu - mu_r).abs().max())
    if ks.shape != ks_r.shape or mu.shape != mu_r.shape or not (
            bool(torch.all((ks - ks_r).abs() <= KS_TOL + KS_TOL * ks_r.abs()))
            and bool(torch.all((mu - mu_r).abs()
                               <= MU_TOL + MU_TOL * mu_r.abs()))):
        raise AssertionError(f"gp_predict_batch disagrees with its plain "
                             f"version: max|err| k* {err_k}, mu {err_m}")
    return err_k
