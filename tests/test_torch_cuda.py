"""The CUDA kernels on the card against their plain PyTorch versions, and
the paths that launch them (closed loop, GP training and validation).

A CUDA kernel has no interpret mode, so every test here needs an NVIDIA GPU
(marker ``cuda``) and skips without one.  On the card:
``python -m pytest tests/test_torch_cuda.py -q``.
"""

import numpy as np
import pytest
import torch

from gpmpc_tpu_torch.ops import cuda_kernels as ck
from gpmpc_tpu_torch.ops import gp_cuda
from gpmpc_tpu_torch.systems import four_tank_ode

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels run only on the card")
    return torch.device("cuda")


CH = ck.RICCATI_CHUNK


@pytest.mark.parametrize("nt,nx,nu,batch", [
    (20, 4, 2, None), (13, 5, 3, None), (8, 2, 1, None), (20, 4, 2, 8),
    # around the kernel's shared-memory chunk, and past two chunks (where
    # the forward pass re-stages the gains it stored)
    (CH - 1, 4, 2, None), (CH, 4, 2, None), (CH + 1, 4, 2, None),
    (2 * CH + 1, 4, 2, None), (300, 4, 2, None),
    # a warp per problem: many blocks, and last blocks with idle warps
    (20, 4, 2, 1024), (13, 5, 3, 8), (8, 2, 1, 8), (40, 5, 3, 5),
    (70, 2, 1, 6)])
def test_riccati_kernel_matches_plain_version(dev, nt, nx, nu, batch):
    args = ck.stage_qp_inputs(nt, nx, nu, nt + nx, batch, device=dev)
    reg = torch.full(() if batch is None else (batch,), 1e-6, device=dev)
    before = ck.LAUNCHES["riccati_sweep"]
    ck.check_riccati_sweep(args, reg)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["riccati_sweep"] == before + 1


def test_riccati_kernel_indefinite_gives_nan(dev):
    ck.check_riccati_sweep_bad_pivot("indefinite", device=dev)


def test_riccati_kernel_zero_pivot_gives_non_finite_gains(dev):
    ck.check_riccati_sweep_bad_pivot("zero", device=dev)


@pytest.mark.parametrize("n_sub", [1, 7, 10])
@pytest.mark.parametrize("batch", [None, 8, 1024])
def test_rk4_kernel_matches_plain_version(dev, batch, n_sub):
    """K2 with the main path's n_sub=10 (compiled in) and other counts (the
    run-time loop), over one rollout, a batch and the batched study's width;
    the batches' first rollout has a drained tank, on the 1e-6 clamp."""
    x, u = ck.rk4_inputs(batch, n_sub + (batch or 1), dev)
    before = ck.LAUNCHES["rk4_substeps"]
    ck.check_rk4_substeps(four_tank_ode, x, u, 0.3, n_sub)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["rk4_substeps"] == before + 1


def test_closed_loop_on_cuda_goes_through_both_kernels(dev):
    from benchmarks.bench_spec import (DT, MODEL_R, Q_W, R_W, ULB, UUB, X0,
                                       XLB, XSP, XUB)
    from gpmpc_tpu_torch import MPC, Model
    from gpmpc_tpu_torch.models.convert import gp_from_fixture

    m = Model(Nx=4, Nu=2, ode=four_tank_ode, dt=DT, R=MODEL_R,
              clip_negative=True, integrator_substeps=10,
              fused_integrator=True, device=dev)
    g = gp_from_fixture(n=30, device=dev, gp_method="TA",
                        optimizer_opts=dict(jitter=1e-5, min_noise=1e-4))
    mpc = MPC(horizon=5 * DT, model=m, gp=g, Q=Q_W, R=R_W, ulb=ULB, uub=UUB,
              xlb=XLB, xub=XUB, percentile=0.95, cov_updates=1, op_x=XSP,
              op_u=np.array([3.0, 3.0]),
              solver_opts=dict(al_iters=2, max_iters=2, fused_kkt=True),
              init_solver_opts=dict(al_iters=1, max_iters=3))
    ck.reset_launches()
    xs, _ = mpc.solve(X0, 3 * DT, XSP, noise=False)
    assert ck.LAUNCHES == {"riccati_sweep": 3 * 4, "rk4_substeps": 3,
                           "se_ard_gram": 0, "cholesky": 0,
                           "gp_predict_batch": 0}
    assert xs.device.type == "cuda" and bool(torch.all(torch.isfinite(xs)))


def test_main_path_launches_k1_four_times_a_step(dev):
    """The main path at full width (fixture GP, Nt=20, the RTI budget,
    f32): K1 launches al_iters x max_iters = 4 times a control step and K2
    once, after the cold start."""
    from benchmarks.bench_spec import (DT, MODEL_R, NT, Q_W, R_W, ULB, UUB,
                                       X0, XLB, XSP, XUB)
    from gpmpc_tpu_torch import MPC, Model
    from gpmpc_tpu_torch.models.convert import gp_from_fixture

    opts = dict(jitter=1e-5, min_noise=1e-4)
    m = Model(Nx=4, Nu=2, ode=four_tank_ode, dt=DT, R=MODEL_R,
              clip_negative=True, integrator_substeps=10,
              fused_integrator=True, device=dev)
    g = gp_from_fixture(device=dev, gp_method="TA", optimizer_opts=opts)
    mpc = MPC(horizon=NT * DT, model=m, gp=g, gp_method="TA",
              discrete_method="gp", Q=Q_W, R=R_W,
              ulb=ULB, uub=UUB, xlb=XLB, xub=XUB, percentile=0.95,
              feedback=True, cov_updates=1, op_x=XSP,
              op_u=np.array([3.0, 3.0]),
              solver_opts=dict(al_iters=2, max_iters=2, ls_steps=8,
                               penalty_init=1e3, fused_kkt=True))
    ck.reset_launches()
    xs, us = mpc.solve(X0, 2 * DT, XSP, noise=False)
    assert ck.LAUNCHES == {"riccati_sweep": 2 * 4, "rk4_substeps": 2,
                           "se_ard_gram": 0, "cholesky": 0,
                           "gp_predict_batch": 0}
    assert bool(torch.all(torch.isfinite(xs))) and \
        bool(torch.all(torch.isfinite(us)))


@pytest.mark.parametrize("n,d,p", [
    # the JAX package's kernel-test shapes
    (40, 6, 8), (100, 6, 8), (200, 12, 8), (130, 3, 8),
    # below one tile, across a tile edge, N % 4 != 0 (rows not 16-byte
    # aligned: the kernel's 4-byte stores)
    *[(n, d, p) for n in (1, 5, 33, 101, 130) for d in (3, 6, 12)
      for p in (1, 8)],
    # where the output write bounds it
    (1000, 6, 4), (2048, 6, 1)])
def test_gram_kernel_matches_plain_version(dev, n, d, p):
    """K4 within rtol and atol 2e-5 of the plain version, exactly symmetric,
    its diagonal bitwise sf2 + sn2 + jitter sf2 (check_se_ard_gram)."""
    args = gp_cuda.gram_inputs(n, d, p, seed=n * d + p, device=dev)
    before = ck.LAUNCHES["se_ard_gram"]
    gp_cuda.check_se_ard_gram(*args, 1e-6)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["se_ard_gram"] == before + 1


@pytest.mark.parametrize("n,p", [(16, 3), (100, 8), (128, 2), (160, 4),
                                 (161, 4), (200, 2), (330, 4), (331, 4),
                                 (500, 4), (1000, 4), (1024, 1), (2048, 1)])
def test_cholesky_kernel_matches_plain_version(dev, n, p):
    before = ck.LAUNCHES["cholesky"]
    gp_cuda.check_cholesky(gp_cuda.spd_inputs(n, p, seed=n, device=dev))
    torch.cuda.synchronize()
    assert ck.LAUNCHES["cholesky"] == before + 1


def test_cholesky_kernel_not_pd_gives_nan(dev):
    a = gp_cuda.spd_inputs(100, 2, seed=1, device=dev)
    a[1, 40, 40] = -1e4
    l = gp_cuda.cholesky(a)
    assert bool(torch.all(torch.isfinite(l[0])))
    gp_cuda.check_cholesky_not_pd(a[1:])


def test_cholesky_blocked_not_pd_in_last_panel_gives_nan(dev):
    """The blocked path at N=1000, P=3, a negative pivot in the last panel
    of the middle matrix: NaN over its whole lower triangle, the other two
    finite and within the plain version's tolerance."""
    a = gp_cuda.spd_inputs(1000, 3, seed=3, device=dev)
    a[1, 999, 999] = -1e4
    l = gp_cuda.cholesky(a)
    gp_cuda.check_cholesky_not_pd(a[1:2])
    assert bool(torch.all(l[1].triu(1) == 0.0))
    for m in (0, 2):
        assert bool(torch.all(torch.isfinite(l[m])))
        gp_cuda.check_cholesky(a[m:m + 1].contiguous())


@pytest.mark.parametrize("n", [500, 1000])
def test_posterior_on_the_card_matches_the_cpu(dev, n):
    """gp_core.posterior at N training points (the blocked K5 path, three
    launches) in f32 on the card against the plain versions in f64 on the
    CPU: the factor within 2e-4 x max|L|."""
    from gpmpc_tpu_torch.models import gp_core
    from gpmpc_tpu_torch.utils.config import GPConfig

    rng = np.random.default_rng(n)
    x, y = rng.uniform(-2, 2, (n, 6)), rng.standard_normal((n, 2))
    h = (0.3 * rng.standard_normal((2, 6)), np.zeros(2),
         np.log([0.1, 0.05]), np.zeros((2, 0)))
    cfg = GPConfig(jitter=1e-5, min_noise=1e-4)
    out = []
    for device, dtype in ((dev, torch.float32), ("cpu", torch.float64)):
        kw = dict(device=device, dtype=dtype)
        ck.reset_launches()
        post = gp_core.posterior(torch.tensor(x, **kw), torch.tensor(y, **kw),
                                 gp_core.GPHypers(*(torch.tensor(v, **kw)
                                                    for v in h)), cfg)
        out.append((post.chol.cpu().double(), ck.LAUNCHES["cholesky"]))
    (card, k5_card), (cpu, k5_cpu) = out
    assert (k5_card, k5_cpu) == (3, 0)
    assert bool(torch.all(torch.isfinite(card)))
    err = float((card - cpu).abs().max())
    assert err <= gp_cuda.CHOL_TOL * float(cpu.abs().max()), err


@pytest.mark.parametrize("n,d,b", [(90, 6, 33), (100, 6, 100)])
def test_predict_kernel_matches_plain_version(dev, n, d, b):
    before = ck.LAUNCHES["gp_predict_batch"]
    gp_cuda.check_gp_predict_batch(*gp_cuda.predict_inputs(n, d, b, 4,
                                                            seed=b,
                                                            device=dev))
    torch.cuda.synchronize()
    assert ck.LAUNCHES["gp_predict_batch"] == before + 1


def test_nll_gradient_on_the_card_matches_the_cpu(dev):
    """The NLL of the fixture's four dims and its gradient through the
    kernels (K4, K5 forward; plain backward) in f32 on the card against the
    plain versions in f64 on the CPU, at log_sn2 = -3: there the Gram is
    conditioned well enough for f32 (the CPU's own f32 gradient is 3e-5 of
    the largest entry off f64; at the fixture's 1e-4 noise floor it is
    off by up to 13%, on either device)."""
    from gpmpc_tpu_torch.models import gp_core
    from gpmpc_tpu_torch.models.convert import FIXTURE
    from gpmpc_tpu_torch.utils.config import GPConfig

    f = np.load(FIXTURE)
    x = f["tank_X"].astype(np.float64)
    y = f["tank_Y"].astype(np.float64)
    x, y = (x - x.mean(0)) / x.std(0), (y - y.mean(0)) / y.std(0)
    cfg = GPConfig(jitter=1e-5, min_noise=1e-4)
    out = []
    for device, dtype in ((dev, torch.float32), ("cpu", torch.float64)):
        kw = dict(device=device, dtype=dtype)
        h = [torch.tensor(f["tank_log_ell"], **kw),
             torch.tensor(f["tank_log_sf2"], **kw),
             torch.full((4,), -3.0, **kw)]
        h = [t.requires_grad_(True) for t in h]
        v = gp_core.nll_batch(*h, torch.zeros((4, 0), **kw),
                              torch.tensor(x, **kw), torch.tensor(y.T, **kw),
                              cfg, "zero")
        g = torch.autograd.grad(v.sum(), h)
        out.append((v.detach().cpu().double(),
                    [t.cpu().double() for t in g]))
    (v32, g32), (v64, g64) = out
    np.testing.assert_allclose(v32.numpy(), v64.numpy(), rtol=1e-5)
    for a, b in zip(g32, g64):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-3 * float(b.abs().max()))


def test_training_and_validation_on_the_card_count_their_launches(dev):
    """A small fit through the GP entry point: one K4 and one K5 launch per
    objective evaluation, one K4 and three K5 for the posterior, one K3 per
    validate."""
    from gpmpc_tpu_torch import GP
    from gpmpc_tpu_torch.models.convert import FIXTURE

    f = np.load(FIXTURE)
    ck.reset_launches()
    gp = GP(f["tank_X"][:50], f["tank_Y"][:50], multistart=2, max_iters=20,
            optimizer_opts=dict(jitter=1e-5, min_noise=1e-4), device=dev)
    assert ck.LAUNCHES == {"riccati_sweep": 0, "rk4_substeps": 0,
                           "se_ard_gram": gp.n_evals + 1,
                           "cholesky": gp.n_evals + 3,
                           "gp_predict_batch": 0}
    assert bool(torch.all(torch.isfinite(gp.nll)))
    smse, mnlp, rmse = gp.validate(f["tank_X"][50:], f["tank_Y"][50:],
                                   verbose=False)
    assert ck.LAUNCHES["gp_predict_batch"] == 1
    assert np.all(np.isfinite(mnlp)) and np.all(smse < 0.1)
