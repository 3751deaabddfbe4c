"""The GP path's kernels K3, K4 and K5 on the CPU: their plain versions
and the torch mirrors of K4's and K5's schedules against the JAX package
(its jnp forms in f64, its Pallas kernels in interpret mode in f32 at the
shapes of tests/test_pallas.py), the wrappers' device switch, and the
autograd functions' derivatives (gradcheck in f64).
The kernels themselves run only on the card (tests/test_torch_cuda.py)."""

import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gpmpc_tpu.ops import kernels as jk
from gpmpc_tpu.ops.pallas_kernels import (cholesky_pallas,
                                          gp_predict_batch_pallas,
                                          se_ard_gram_pallas)
from gpmpc_tpu_torch.ops import cuda_kernels as ck
from gpmpc_tpu_torch.ops import gp_cuda
from gpmpc_tpu_torch.ops import kernels as tk


def test_gram_reference_matches_jax_f64():
    """Plain K4 at (N, D) = (100, 6) for three problems, each against JAX's
    se_ard_gram with that problem's hypers: 1e-12 of sf2."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-2, 2, (100, 6))
    ell = np.exp(0.3 * rng.standard_normal((3, 6)))
    sf2, sn2 = np.array([1.7, 0.4, 3.0]), np.array([0.03, 1e-4, 0.2])
    got = gp_cuda.se_ard_gram_reference(*map(torch.as_tensor,
                                             (x, ell, sf2, sn2)), 1e-6)
    assert got.shape == (3, 100, 100)
    for p in range(3):
        ref = jk.se_ard_gram(jnp.asarray(x), jnp.asarray(ell[p]), sf2[p],
                             sn2[p], jitter=1e-6)
        np.testing.assert_allclose(got[p].numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-12 * sf2[p])
        assert np.all(np.diag(got[p].numpy())
                      == sf2[p] + sn2[p] + 1e-6 * sf2[p])


@pytest.mark.parametrize("n,tile", [(1, 32), (5, 4), (33, 32), (101, 32),
                                    (130, 32), (101, 8), (33, 64),
                                    (130, 256)])
def test_gram_pairs_schedule_matches_jax_f64(n, tile):
    """K4's tile-pair schedule (its torch mirror) in f64 at ragged N, with
    tiles on both sides of N, for two problems, each against JAX x64
    se_ard_gram with that problem's hypers: 1e-12 of sf2.  The diagonal is
    exactly sf2 + sn2 + jitter sf2, and the output symmetric to 2 ulps (on
    the card K4 is exactly symmetric; torch's CPU exp2 may round one input
    differently at two positions of a tensor, so the mirror's diagonal
    tiles can part by an ulp)."""
    rng = np.random.default_rng(n + tile)
    x = rng.uniform(-2, 2, (n, 6))
    ell = np.exp(0.3 * rng.standard_normal((2, 6)))
    sf2, sn2 = np.array([1.7, 0.4]), np.array([0.03, 1e-4])
    got = gp_cuda.se_ard_gram_pairs_reference(
        *map(torch.as_tensor, (x, ell, sf2, sn2)), 1e-6, tile)
    assert got.shape == (2, n, n)
    np.testing.assert_allclose(got.numpy(), got.mT.numpy(), rtol=2.0 ** -51,
                               atol=0)
    for p in range(2):
        ref = jk.se_ard_gram(jnp.asarray(x), jnp.asarray(ell[p]), sf2[p],
                             sn2[p], jitter=1e-6)
        np.testing.assert_allclose(got[p].numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-12 * sf2[p])
        assert np.all(np.diag(got[p].numpy())
                      == sf2[p] + sn2[p] + 1e-6 * sf2[p])


@pytest.mark.parametrize("n,d", [(33, 3), (101, 6), (130, 12)])
def test_gram_pairs_schedule_matches_pallas_interpret_f32(n, d):
    """K4's tile-pair schedule in f32 at ragged N against the Pallas kernel
    in interpret mode (one problem per call), at the JAX kernel test's
    rtol and atol 2e-5 (tests/test_pallas.py)."""
    x, ell, sf2, sn2 = gp_cuda.gram_inputs(n, d, 2, seed=n + d)
    got = gp_cuda.se_ard_gram_pairs_reference(x, ell, sf2, sn2, 1e-6)
    for p in range(2):
        ref = se_ard_gram_pallas(jnp.asarray(x.numpy()),
                                 jnp.asarray(ell[p].numpy()), float(sf2[p]),
                                 float(sn2[p]), jitter=1e-6, interpret=True)
        np.testing.assert_allclose(got[p].numpy(), np.asarray(ref),
                                   rtol=2e-5, atol=2e-5)


def test_gram_constants_mirror_the_kernel_source():
    """GRAM_TILE, the mirror's default tile, is the TILE constant of
    csrc/se_ard_gram.cu, and its SCALE is GRAM_EXP2_SCALE, sqrt(log2(e)/2),
    to f32 precision."""
    src = (ck.CSRC / "se_ard_gram.cu").read_text()
    assert re.findall(r"constexpr int TILE = (\d+);", src) == [
        str(gp_cuda.GRAM_TILE)]
    (scale,) = re.findall(r"constexpr float SCALE = ([0-9.]+)f;", src)
    assert np.float32(scale) == np.float32(gp_cuda.GRAM_EXP2_SCALE)
    assert abs(gp_cuda.GRAM_EXP2_SCALE ** 2 - 0.5 / np.log(2)) < 1e-15


@pytest.mark.parametrize("n", [16, 100, 128, 200])
def test_cholesky_reference_matches_pallas_interpret(n):
    """Plain K5 in f32 against the Pallas kernel in interpret mode and
    against numpy in f64: atol 2e-4 x max|L| (tests/test_pallas.py)."""
    rng = np.random.default_rng(n)
    a = rng.standard_normal((n, n))
    spd = (a @ a.T + n * np.eye(n)).astype(np.float32)
    ref = np.linalg.cholesky(spd.astype(np.float64))
    pallas = np.asarray(cholesky_pallas(jnp.asarray(spd), interpret=True))
    got = gp_cuda.cholesky_reference(torch.as_tensor(spd)[None])[0].numpy()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, atol=2e-4 * scale)
    np.testing.assert_allclose(got, pallas, atol=2e-4 * scale)


@pytest.mark.parametrize("n,d,b", [(90, 6, 33), (100, 6, 100)])
def test_predict_reference_matches_pallas_interpret(n, d, b):
    """Plain K3 for two output dims in f32 against the Pallas kernel (one
    dim per call) in interpret mode: k* within 2e-5, mu within 2e-4."""
    z, x, ell, sf2, alpha = gp_cuda.predict_inputs(n, d, b, 2, seed=n + b)
    mu, ks = gp_cuda.gp_predict_batch_reference(z, x, ell, sf2, alpha)
    assert mu.shape == (2, b) and ks.shape == (2, b, n)
    for dim in range(2):
        mu_p, ks_p = gp_predict_batch_pallas(
            jnp.asarray(z.numpy()), jnp.asarray(x.numpy()),
            jnp.asarray(ell[dim].numpy()), float(sf2[dim]),
            jnp.asarray(alpha[dim].numpy()), interpret=True)
        np.testing.assert_allclose(ks[dim].numpy(), np.asarray(ks_p),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(mu[dim].numpy(), np.asarray(mu_p),
                                   rtol=2e-4, atol=2e-4)


def test_predict_reference_matches_jax_cross_f64():
    rng = np.random.default_rng(5)
    z, x = rng.uniform(-2, 2, (7, 4)), rng.uniform(-2, 2, (11, 4))
    ell = np.exp(0.2 * rng.standard_normal((3, 4)))
    sf2, alpha = np.array([1.3, 0.7, 2.0]), rng.standard_normal((3, 11))
    mu, ks = gp_cuda.gp_predict_batch_reference(
        *map(torch.as_tensor, (z, x, ell, sf2, alpha)))
    for dim in range(3):
        ref = np.asarray(jk.se_ard_cross(jnp.asarray(z), jnp.asarray(x),
                                         jnp.asarray(ell[dim]), sf2[dim]))
        np.testing.assert_allclose(ks[dim].numpy(), ref, atol=1e-13)
        np.testing.assert_allclose(mu[dim].numpy(), ref @ alpha[dim],
                                   atol=1e-12)


def test_wrappers_on_cpu_are_the_plain_versions():
    before = dict(ck.LAUNCHES)
    args = gp_cuda.gram_inputs(30, 3, 2, seed=1)
    assert torch.equal(gp_cuda.se_ard_gram(*args, 1e-6),
                       gp_cuda.se_ard_gram_reference(*args, 1e-6))
    a = gp_cuda.spd_inputs(12, 3, seed=2)
    assert torch.equal(gp_cuda.cholesky(a), gp_cuda.cholesky_reference(a))
    pin = gp_cuda.predict_inputs(20, 3, 9, 2, seed=3)
    for got, ref in zip(gp_cuda.gp_predict_batch(*pin),
                        gp_cuda.gp_predict_batch_reference(*pin)):
        assert torch.equal(got, ref)
    assert ck.LAUNCHES == before         # the CPU path launches no kernel


def test_wrappers_refuse_devices_without_a_kernel():
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        gp_cuda.se_ard_gram(*(torch.empty(s, **meta) for s in
                              ((5, 2), (1, 2), (1,), (1,))))
    with pytest.raises(ValueError, match="no kernel for device"):
        gp_cuda.cholesky(torch.empty(1, 3, 3, **meta))
    with pytest.raises(ValueError, match="no kernel for device"):
        gp_cuda.gp_predict_batch(*(torch.empty(s, **meta) for s in
                                   ((2, 3), (4, 3), (1, 3), (1,), (1, 4))))


def test_cholesky_not_pd_gives_nan_in_the_lower_triangle():
    a = gp_cuda.spd_inputs(6, 2, seed=4)
    a[1, 3, 3] = -1.0
    l = gp_cuda.cholesky_reference(a)
    assert bool(torch.all(torch.isfinite(l[0])))
    gp_cuda.check_cholesky_not_pd(a[1:])
    assert bool(torch.all(l[1].triu(1) == 0.0))


@pytest.mark.parametrize("p", [1, 3])
@pytest.mark.parametrize("nb", [32, 64])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 63, 64, 65, 130, 257])
def test_cholesky_blocked_schedule_matches_jax_f64(n, nb, p):
    """K5's blocked schedule (its torch mirror) in f64, ragged last panels
    included, against JAX x64 jnp.linalg.cholesky and the plain version:
    1e-10."""
    a = gp_cuda.spd_inputs(n, p, seed=n + nb).double()
    got = gp_cuda.cholesky_blocked_reference(a, nb)
    ref = np.asarray(jnp.linalg.cholesky(jnp.asarray(a.numpy())))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-10)
    np.testing.assert_allclose(got.numpy(),
                               gp_cuda.cholesky_reference(a).numpy(),
                               rtol=0, atol=1e-10)
    assert bool(torch.all(got.triu(1) == 0.0))


@pytest.mark.parametrize("nb", [32, 64])
def test_cholesky_blocked_schedule_nan_in_last_panel(nb):
    """A negative pivot in the last panel of the middle matrix: NaN over its
    whole lower triangle (the panels before it included), the other two
    finite and equal to the plain version."""
    a = gp_cuda.spd_inputs(130, 3, seed=9).double()
    a[1, 129, 129] = -1e4
    got = gp_cuda.cholesky_blocked_reference(a, nb)
    low = torch.tril(torch.ones(130, 130, dtype=torch.bool))
    assert bool(torch.all(torch.isnan(got[1][low])))
    assert bool(torch.all(got[1][~low] == 0.0))
    ref = gp_cuda.cholesky_reference(a)
    for m in (0, 2):
        assert bool(torch.all(torch.isfinite(got[m])))
        np.testing.assert_allclose(got[m].numpy(), ref[m].numpy(), rtol=0,
                                   atol=1e-10)


def test_kernel_gram_single_and_batched_agree():
    rng = np.random.default_rng(6)
    x = torch.as_tensor(rng.uniform(-1, 1, (15, 3)))
    ell = torch.as_tensor(np.exp(0.2 * rng.standard_normal((2, 3))))
    sf2, sn2 = torch.tensor([1.1, 0.6], dtype=torch.float64), 0.01
    batched = tk.kernel_gram("se", x, ell, sf2, sn2, jitter=1e-6)
    for p in range(2):
        single = tk.kernel_gram("se", x, ell[p], sf2[p], sn2, jitter=1e-6)
        assert torch.equal(batched[p], single)


def test_gram_gradcheck():
    """The analytic backward of SEARDGram (ell, sf2, sn2) against finite
    differences in f64."""
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.uniform(-1, 1, (9, 3)))
    ell = torch.as_tensor(np.exp(0.3 * rng.standard_normal((2, 3))),
                          ).requires_grad_(True)
    sf2 = torch.tensor([1.3, 0.5], dtype=torch.float64, requires_grad=True)
    sn2 = torch.tensor([0.1, 0.02], dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda e, s, n: gp_cuda.SEARDGram.apply(x, e, s, n, 1e-3),
        (ell, sf2, sn2))


def test_cholesky_gradcheck():
    """The adjoint backward of Cholesky against finite differences in f64,
    on symmetric inputs (the factor reads the lower triangle, the adjoint
    is symmetric)."""
    a = gp_cuda.spd_inputs(6, 2, seed=8).double().requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda m: gp_cuda.cholesky_auto(0.5 * (m + m.mT)), (a,))
    # the symmetric adjoint equals torch's own Cholesky derivative on the
    # symmetrized input
    g = torch.randn(2, 6, 6, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0))
    (ours,) = torch.autograd.grad(
        gp_cuda.cholesky_auto(0.5 * (a + a.mT)), a, g)
    (torchs,) = torch.autograd.grad(torch.linalg.cholesky(0.5 * (a + a.mT)),
                                    a, g)
    np.testing.assert_allclose(ours.numpy(), torchs.numpy(), atol=1e-12)
