"""Port parity: the Riccati KKT sweep, its kernel's plain version, and the
LQR gain of gpmpc_tpu_torch against gpmpc_tpu on the same numpy inputs."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gpmpc_tpu.ops.pallas_kernels import riccati_sweep_pallas
from gpmpc_tpu.solvers import riccati as jric
from gpmpc_tpu_torch.ops.cuda_kernels import (LAUNCHES, riccati_sweep,
                                              riccati_sweep_reference)
from gpmpc_tpu_torch.solvers import riccati as tric


def random_qp(nt, nx, nu, seed):
    """The random stage QPs of tests/test_pallas.py (cross terms, defects,
    nonzero dx0), as numpy arrays in StageQP order plus dx0."""
    rng = np.random.default_rng(seed)
    a = 0.9 * np.eye(nx)[None] + 0.05 * rng.standard_normal((nt, nx, nx))
    b = 0.3 * rng.standard_normal((nt, nx, nu))
    c = 0.02 * rng.standard_normal((nt, nx))
    m = rng.standard_normal((nt, nx, nx))
    q_xx = 0.5 * (m @ np.swapaxes(m, 1, 2)) + 2.0 * np.eye(nx)[None]
    q_uu = np.tile(0.5 * np.eye(nu)[None], (nt, 1, 1))
    q_xu = 0.1 * rng.standard_normal((nt, nx, nu))
    q_x = 0.1 * rng.standard_normal((nt, nx))
    q_u = 0.1 * rng.standard_normal((nt, nu))
    qf_xx = 5.0 * np.eye(nx)
    qf_x = 0.1 * rng.standard_normal(nx)
    dx0 = 0.3 * rng.standard_normal(nx)
    return (a, b, c, q_xx, q_uu, q_xu, q_x, q_u, qf_xx, qf_x), dx0


@pytest.mark.parametrize("nt,nx,nu,seed", [(20, 4, 2, 0), (13, 5, 3, 1),
                                           (8, 2, 1, 2)])
def test_solve_matches_jax_f64(nt, nx, nu, seed):
    qp, dx0 = random_qp(nt, nx, nu, seed)
    ref = jric.solve(jric.StageQP(*map(jnp.asarray, qp)), jnp.asarray(dx0),
                     1e-6)
    got = tric.solve(tric.StageQP(*map(torch.as_tensor, qp)),
                     torch.as_tensor(dx0), 1e-6)
    for name in ("dx", "du", "gain_k", "ff_k", "exp_dec"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=0, atol=1e-10, err_msg=name)
    assert bool(got.ok) and bool(ref.ok)


def test_sweep_reference_matches_pallas_interpret_f32():
    """The kernel's plain version against the TPU kernel (Pallas interpret)
    at the tolerances of tests/test_pallas.py."""
    nt, nx, nu = 8, 4, 2
    qp, dx0 = random_qp(nt, nx, nu, 3)
    qp32 = [x.astype(np.float32) for x in qp]
    dx0_32 = dx0.astype(np.float32)
    ref = riccati_sweep_pallas(*map(jnp.asarray, qp32), jnp.asarray(dx0_32),
                               1e-6, interpret=True)
    got = riccati_sweep_reference(*map(torch.as_tensor, qp32),
                                  torch.as_tensor(dx0_32),
                                  torch.tensor(1e-6))
    scale = float(np.abs(np.asarray(ref[0])).max()) + 1.0
    for i, atol in ((0, 1e-5 * scale), (1, 1e-5 * scale), (2, 2e-5)):
        assert got[i].dtype == torch.float32
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref[i]),
                                   atol=atol)
    np.testing.assert_allclose(float(got[4]), float(ref[4]), rtol=1e-4,
                               atol=1e-6)


def test_sweep_reference_batched_equals_per_problem():
    """The batch dim (one kernel thread per problem) gives each problem the
    answer it gets alone; reg may differ per problem."""
    probs = [random_qp(6, 4, 2, s) for s in range(3)]
    regs = [1e-6, 1e-3, 0.1]
    stack = [torch.as_tensor(np.stack([p[0][i] for p in probs]))
             for i in range(10)]
    dx0 = torch.as_tensor(np.stack([p[1] for p in probs]))
    out = riccati_sweep_reference(*stack, dx0, torch.tensor(regs,
                                                            dtype=torch.float64))
    for k, ((qp, d0), reg) in enumerate(zip(probs, regs)):
        one = riccati_sweep_reference(*map(torch.as_tensor, qp),
                                      torch.as_tensor(d0), reg)
        for got, ref in zip(out, one):
            np.testing.assert_allclose(got[k].numpy(), ref.numpy(),
                                       rtol=1e-12, atol=1e-14)


def test_indefinite_quu_gives_not_ok():
    """An indefinite H_uu (negative q_uu, no reg) yields NaN and ok=False in
    the sequential sweep and in the fused path (its plain version on CPU),
    like the JAX sweep."""
    qp, dx0 = random_qp(8, 2, 1, 2)
    qp = list(qp)
    qp[4] = -qp[4]
    assert not bool(jric.solve(jric.StageQP(*map(jnp.asarray, qp)),
                               jnp.asarray(dx0), 0.0).ok)
    assert not bool(tric.solve(tric.StageQP(*map(torch.as_tensor, qp)),
                               torch.as_tensor(dx0), 0.0).ok)
    qp32 = tric.StageQP(*(torch.as_tensor(x, dtype=torch.float32)
                          for x in qp))
    before = dict(LAUNCHES)
    sol = tric.solve_fused(qp32, torch.as_tensor(dx0, dtype=torch.float32),
                           0.0)
    assert not bool(sol.ok)
    assert LAUNCHES == before        # the CPU path launches no kernel


def test_wrapper_on_cpu_is_the_plain_version():
    qp, dx0 = random_qp(5, 4, 2, 4)
    args = [torch.as_tensor(x, dtype=torch.float32) for x in qp]
    d0 = torch.as_tensor(dx0, dtype=torch.float32)
    reg = torch.tensor(1e-4)
    for got, ref in zip(riccati_sweep(*args, d0, reg),
                        riccati_sweep_reference(*args, d0, reg)):
        assert torch.equal(got, ref)


def test_select_backend():
    assert tric.select_backend(20, torch.float32, fused=True) is \
        tric.solve_fused
    assert tric.select_backend(500, torch.float32, fused=True) is \
        tric.solve_fused             # no horizon cap: the kernel loops
    assert tric.select_backend(20, torch.float32) is tric.solve_parallel
    assert tric.select_backend(19, torch.float32) is tric.solve
    assert tric.select_backend(20, torch.float64) is tric.solve
    assert tric.select_backend(20, torch.float32, parallel=True) is \
        tric.solve_parallel
    with pytest.raises(ValueError, match="f32"):
        tric.select_backend(20, torch.float64, fused=True)
    qp, dx0 = random_qp(4, 2, 1, 0)
    with pytest.raises(ValueError, match="f32"):
        tric.solve_fused(tric.StageQP(*map(torch.as_tensor, qp)),
                         torch.as_tensor(dx0), 1e-6)


@pytest.mark.parametrize("nt", [3, 5, 8, 19, 20, 60, 256])
@pytest.mark.parametrize("f64", [False, True])
@pytest.mark.parametrize("fused,parallel", [(False, False), (False, True),
                                            (True, False), (True, True)])
def test_select_backend_matches_jax(nt, f64, fused, parallel):
    """The port picks the KKT solve the JAX package picks, by name, over
    horizons on both sides of PARALLEL_MIN_NT and up to JAX's fused_max_nt
    (beyond it JAX degrades fused to the associative scan; the port's sweep
    kernel loops at run time and keeps it, tested in
    test_select_backend)."""
    tdt, jdt = ((torch.float64, jnp.float64) if f64
                else (torch.float32, jnp.float32))
    if fused and f64:
        with pytest.raises(ValueError):
            jric.select_backend(nt, jdt, fused=fused, parallel=parallel)
        with pytest.raises(ValueError):
            tric.select_backend(nt, tdt, fused=fused, parallel=parallel)
        return
    assert tric.select_backend(nt, tdt, fused=fused, parallel=parallel
                               ).__name__ == jric.select_backend(
        nt, jdt, fused=fused, parallel=parallel).__name__


@pytest.mark.parametrize("nt,nx,nu,seed", [(20, 4, 2, 0), (13, 5, 3, 1),
                                           (8, 2, 1, 2), (1, 3, 2, 3)])
def test_solve_parallel_matches_jax_f64(nt, nx, nu, seed):
    """The associative-scan Riccati solve against JAX x64 solve_parallel on
    the stage QPs of tests/test_pallas.py: rtol 1e-8 (scale-relative)."""
    qp, dx0 = random_qp(nt, nx, nu, seed)
    ref = jric.solve_parallel(jric.StageQP(*map(jnp.asarray, qp)),
                              jnp.asarray(dx0), 1e-6)
    got = tric.solve_parallel(tric.StageQP(*map(torch.as_tensor, qp)),
                              torch.as_tensor(dx0), 1e-6)
    for name in ("dx", "du", "gain_k", "ff_k", "exp_dec"):
        r = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(getattr(got, name).numpy(), r, rtol=1e-8,
                                   atol=1e-8 * (1.0 + np.abs(r).max()))
    assert bool(got.ok) and bool(ref.ok)
    seq = tric.solve(tric.StageQP(*map(torch.as_tensor, qp)),
                     torch.as_tensor(dx0), 1e-6)
    np.testing.assert_allclose(got.dx.numpy(), seq.dx.numpy(), atol=1e-9)


def test_solve_parallel_indefinite_gives_not_ok():
    qp, dx0 = random_qp(8, 2, 1, 2)
    qp = list(qp)
    qp[4] = -qp[4]
    got = tric.solve_parallel(tric.StageQP(*map(torch.as_tensor, qp)),
                              torch.as_tensor(dx0), 0.0)
    assert not bool(got.ok)


@pytest.mark.parametrize("seed", [0, 1])
def test_lqr_gain_matches_jax(seed):
    rng = np.random.default_rng(seed)
    a = np.eye(4) + 0.1 * rng.standard_normal((4, 4))
    b = rng.standard_normal((4, 2))
    q, r = np.diag([20.0, 20.0, 0.1, 0.1]), 0.05 * np.eye(2)
    k_j, ok_j = jric.lqr_gain(*map(jnp.asarray, (a, b, q, r)),
                              return_converged=True)
    k_t, ok_t = tric.lqr_gain(*map(torch.as_tensor, (a, b, q, r)),
                              return_converged=True)
    assert ok_t == bool(ok_j)
    np.testing.assert_allclose(k_t.numpy(), np.asarray(k_j), rtol=1e-8,
                               atol=1e-10)
