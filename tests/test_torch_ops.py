"""Port parity: SE-ARD kernels and Cholesky helpers of gpmpc_tpu_torch.ops
against gpmpc_tpu.ops on the same numpy inputs (f64, atol 1e-10)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gpmpc_tpu.ops import chol as jchol
from gpmpc_tpu.ops import kernels as jk
from gpmpc_tpu_torch.ops import chol as tchol
from gpmpc_tpu_torch.ops import kernels as tk

ATOL = 1e-10


def _pair(a):
    return jnp.asarray(a), torch.as_tensor(a)


def _f64(v):
    return torch.tensor(v, dtype=torch.float64)


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("n,m,d", [(7, 5, 3), (1, 9, 6), (12, 1, 4)])
def test_se_ard_cross_and_sq_maha(n, m, d):
    rng = np.random.default_rng(n * 100 + m)
    x, z = rng.uniform(-2, 2, (n, d)), rng.uniform(-2, 2, (m, d))
    ell = np.exp(0.3 * rng.standard_normal(d))
    (jx, tx), (jz, tz), (je, te) = _pair(x), _pair(z), _pair(ell)
    _close(tk.sq_maha(tx, tz), jk.sq_maha(jx, jz))
    _close(tk.se_ard_cross(tx, tz, te, _f64(1.7)),
           jk.se_ard_cross(jx, jz, je, 1.7))
    _close(tk.kernel_cross("se", tx, tz, te, _f64(0.4)),
           jk.kernel_cross("se", jx, jz, je, 0.4))
    _close(tk.se_ard(tx[0], tz[0], te, _f64(1.3)),
           jk.se_ard(jx[0], jz[0], je, 1.3))


def test_sq_maha_f32_single_query_branch():
    """f32 with a one-point side takes the broadcast-subtraction form on both
    sides (the op-order split), so the two agree to f32 rounding."""
    rng = np.random.default_rng(5)
    z = rng.uniform(-2, 2, (1, 6)).astype(np.float32)
    x = rng.uniform(-2, 2, (40, 6)).astype(np.float32)
    got = tk.sq_maha(torch.as_tensor(z), torch.as_tensor(x))
    ref = jk.sq_maha(jnp.asarray(z), jnp.asarray(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


def test_se_ard_gram():
    rng = np.random.default_rng(0)
    x = rng.uniform(-2, 2, (30, 6))
    ell = np.exp(0.2 * rng.standard_normal(6))
    (jx, tx), (je, te) = _pair(x), _pair(ell)
    sf2, sn2 = _f64(1.3), 0.02
    _close(tk.se_ard_gram(tx, te, sf2, sn2, jitter=1e-5),
           jk.se_ard_gram(jx, je, 1.3, sn2, jitter=1e-5))
    _close(tk.kernel_gram("se", tx, te, sf2, sn2, jitter=1e-6),
           jk.kernel_gram("se", jx, je, 1.3, sn2, jitter=1e-6))


def test_unported_kernel_family_raises():
    """The Matérn families are ported (tests/test_torch_matern.py); a
    family neither package has raises, naming the supported ones."""
    x = torch.zeros((2, 3), dtype=torch.float64)
    with pytest.raises(ValueError, match="supported"):
        tk.kernel_cross("rq", x, x, torch.ones(3), torch.tensor(1.0))


def _spd(rng, n):
    a = rng.standard_normal((n, n))
    return a @ a.T + n * np.eye(n)


def test_cholesky_and_triangular_solves():
    rng = np.random.default_rng(1)
    a = _spd(rng, 9)
    b_vec, b_mat = rng.standard_normal(9), rng.standard_normal((9, 3))
    (ja, ta) = _pair(a)
    jl, tl = jchol.cholesky_psd(ja), tchol.cholesky_psd(ta)
    _close(tl, jl)
    for b in (b_vec, b_mat):
        jb, tb = _pair(b)
        for trans in (False, True):
            _close(tchol.tri_solve(tl, tb, trans=trans),
                   jchol.tri_solve(jl, jb, trans=trans))
        _close(tchol.chol_solve(tl, tb), jchol.chol_solve(jl, jb))


def test_cholesky_psd_not_pd_gives_nan_like_jax():
    a = np.array([[1.0, 2.0], [2.0, 1.0]])
    ja, ta = _pair(a)
    jl = np.asarray(jchol.cholesky_psd(ja))
    tl = tchol.cholesky_psd(ta).numpy()
    assert np.isnan(jl[0, 0]) and np.isnan(tl[0, 0])
    np.testing.assert_array_equal(np.isnan(tl), np.isnan(jl))


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_chol_small_and_tri_solve_small(n):
    rng = np.random.default_rng(n)
    a = np.stack([_spd(rng, n) for _ in range(4)])      # batched (4, n, n)
    b_vec, b_mat = rng.standard_normal((4, n)), rng.standard_normal((4, n, 2))
    ja, ta = _pair(a)
    for clamp in (True, False):
        _close(tchol.chol_small(ta, clamp=clamp),
               jchol.chol_small(ja, clamp=clamp))
    jl, tl = jchol.chol_small(ja), tchol.chol_small(ta)
    for b in (b_vec, b_mat):
        jb, tb = _pair(b)
        for trans in (False, True):
            _close(tchol.tri_solve_small(tl, tb, trans=trans),
                   jchol.tri_solve_small(jl, jb, trans=trans))


def test_chol_small_non_pd_pivot():
    """clamp=False keeps the NaN of a non-PD pivot (the Riccati ``ok`` flag
    reads it); clamp=True floors the pivot and stays finite — on both."""
    a = np.array([[-1.0, 0.2], [0.2, 2.0]])
    ja, ta = _pair(a)
    jl = np.asarray(jchol.chol_small(ja, clamp=False))
    tl = tchol.chol_small(ta, clamp=False).numpy()
    assert np.isnan(jl[0, 0]) and np.isnan(tl[0, 0])
    np.testing.assert_array_equal(np.isnan(tl), np.isnan(jl))
    _close(tchol.chol_small(ta, clamp=True), jchol.chol_small(ja, clamp=True))
    assert np.all(np.isfinite(tchol.chol_small(ta, clamp=True).numpy()))
