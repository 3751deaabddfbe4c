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
    (70, 2, 1, 6),
    # the car with the delta-u augmentation: (6, 2), one problem and a
    # batch, its path's Nt=20 and a horizon across the chunks
    (20, 6, 2, None), (300, 6, 2, None), (20, 6, 2, 64), (300, 6, 2, 64)])
def test_riccati_kernel_matches_plain_version(dev, nt, nx, nu, batch):
    args = ck.stage_qp_inputs(nt, nx, nu, nt + nx, batch, device=dev)
    reg = torch.full(() if batch is None else (batch,), 1e-6, device=dev)
    before = ck.LAUNCHES["riccati_sweep"]
    ck.check_riccati_sweep(args, reg)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["riccati_sweep"] == before + 1


@pytest.mark.parametrize("shape", [None, (20, 6, 2)])
def test_riccati_kernel_indefinite_gives_nan(dev, shape):
    ck.check_riccati_sweep_bad_pivot("indefinite", device=dev, shape=shape)


@pytest.mark.parametrize("shape", [None, (20, 6, 2)])
def test_riccati_kernel_zero_pivot_gives_non_finite_gains(dev, shape):
    ck.check_riccati_sweep_bad_pivot("zero", device=dev, shape=shape)


def test_riccati_kernel_refuses_an_uninstantiated_shape(dev):
    args = ck.stage_qp_inputs(8, 3, 1, 0, device=dev)
    with pytest.raises(ValueError, match="no kernel instantiated"):
        ck.riccati_sweep(*args, torch.tensor(1e-6, device=dev))


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


@pytest.mark.parametrize("n_sub", [1, 10])
@pytest.mark.parametrize("batch", [None, 200, 1024])
def test_rk4_kernel_car_functor_matches_plain_version(dev, batch, n_sub):
    """K2's Car functor (ode_id 1) over one rollout, the car validation's
    200 and the batched width; the batches steer at +-0.5 rad and head
    past +-pi."""
    from gpmpc_tpu_torch.systems import car_ode
    x, u = ck.car_inputs(batch, n_sub + (batch or 1), dev)
    before = ck.LAUNCHES["rk4_substeps"]
    ck.check_rk4_substeps(car_ode, x, u, 0.01, n_sub)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["rk4_substeps"] == before + 1


def test_fused_integrator_without_a_functor_raises_on_the_card(dev):
    from gpmpc_tpu_torch import Model
    from gpmpc_tpu_torch.systems import car_ode
    with pytest.raises(ValueError, match="compiled into the RK4 kernel"):
        Model(Nx=4, Nu=2, ode=lambda x, u: car_ode(x, u), dt=0.1,
              fused_integrator=True, device=dev)
    x, u = ck.car_inputs(8, 0, dev)
    with pytest.raises(ValueError, match="no CUDA functor"):
        ck.rk4_substeps(lambda a, b: car_ode(a, b), x, u, 0.01, 10)


def test_car_closed_loop_on_the_card_counts_its_launches(dev):
    """The car (EM, hybrid, delta-u, both obstacles through con_par) at
    Nt=8 with the fixture GP's first 40 points and the RTI preset: the
    posterior's one K4 and three K5, K1 at (6, 2) al x mi times a step and
    in the fused cold start, no K2 (the plant is unfused), then one K2 Car
    launch for a fused plant step."""
    from gpmpc_tpu_torch import MPC, Model
    from gpmpc_tpu_torch.models.convert import gp_from_fixture
    from gpmpc_tpu_torch.systems import (CAR_OBSTACLES, CAR_U_LB, CAR_U_UB,
                                         CAR_X0, CAR_XSP, car_ode,
                                         ellipse_obstacle_constraints)
    ck.reset_launches()
    m = Model(Nx=4, Nu=2, ode=car_ode, dt=0.1,
              R=np.diag([1e-5, 1e-5, 1e-6, 1e-5]), integrator_substeps=10,
              device=dev)
    g = gp_from_fixture(prefix="car", n=40, device=dev, gp_method="EM")
    cb, n_par = ellipse_obstacle_constraints(2, scale=2.0)
    mpc = MPC(horizon=0.8, model=m, gp=g, gp_method="EM",
              discrete_method="hybrid", Q=np.diag([5.0, 20.0, 0.5, 1.0]),
              R=np.diag([0.1, 1.0]), S=np.diag([0.05, 0.5]), ulb=CAR_U_LB,
              uub=CAR_U_UB, xlb=[-5.0, -4.0, -2.0, 0.0],
              xub=[25.0, 4.0, 2.0, 10.0], percentile=0.95, feedback=True,
              op_x=CAR_X0, inequality_constraints=cb, num_con_par=n_par,
              cov_updates=1, solver_opts="rti",
              init_solver_opts=dict(al_iters=1, max_iters=4, fused_kkt=True))
    par = CAR_OBSTACLES.reshape(-1)
    xs, us = mpc.solve(CAR_X0, 0.3, CAR_XSP, noise=False,
                       con_par_func=lambda k: par)
    assert ck.LAUNCHES == {"riccati_sweep": 3 * 24 + 4, "rk4_substeps": 0,
                           "se_ard_gram": 1, "cholesky": 3,
                           "gp_predict_batch": 0}
    assert xs.device.type == "cuda" and bool(torch.all(torch.isfinite(xs)))
    assert bool(torch.all(torch.isfinite(us)))
    fused = Model(Nx=4, Nu=2, ode=car_ode, dt=0.1, integrator_substeps=10,
                  fused_integrator=True, device=dev)
    x1 = fused.integrate(xs[-1], us[-1])
    assert ck.LAUNCHES["rk4_substeps"] == 1
    torch.testing.assert_close(x1, m.integrate(xs[-1], us[-1]), rtol=1e-5,
                               atol=1e-6)


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


@pytest.mark.parametrize("n,d,p", [(100, 257, 2), (300, 300, 1)])
def test_gram_kernel_takes_any_d(dev, n, d, p):
    """K4 past one feature chunk (D > GRAM_DCHUNK = 256) against the plain
    version, exactly symmetric, its diagonal bitwise; ell scaled by
    sqrt(D), so K is not 0."""
    args = gp_cuda.gram_inputs(n, d, p, seed=n + d, device=dev,
                               ell_scale=np.sqrt(d))
    before = ck.LAUNCHES["se_ard_gram"]
    gp_cuda.check_se_ard_gram(*args, 1e-6)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["se_ard_gram"] == before + 1


def test_gram_kernel_takes_n_past_46340(dev):
    """K4 at N = 46341, D = 6, P = 1, the first N whose N x N Gram (8.6 GB)
    passes 2^31 elements (its offsets are 64-bit): the last tile row and
    column (rows >= 46336) and three diagonal tiles against the plain
    cross-covariance of those rows, at the plain version's tolerance;
    exactly symmetric there, the diagonal bitwise sf2 + sn2 + jitter sf2."""
    from gpmpc_tpu_torch.ops.kernels import se_ard_cross
    n, jitter = 46341, 1e-6
    x, ell, sf2, sn2 = gp_cuda.gram_inputs(n, 6, 1, seed=n, device=dev)
    before = ck.LAUNCHES["se_ard_gram"]
    k = gp_cuda.se_ard_gram(x, ell, sf2, sn2, jitter)[0]
    torch.cuda.synchronize()
    assert ck.LAUNCHES["se_ard_gram"] == before + 1
    diag = sf2 + sn2 + jitter * sf2
    tol = gp_cuda.GRAM_TOL
    for r0, r1 in ((46336, n), (0, 32), (23168, 23200)):
        rows = k[r0:r1]
        ref = se_ard_cross(x[r0:r1], x, ell[0], sf2[0])
        idx = torch.arange(r0, r1, device=dev)
        ref[idx - r0, idx] = diag[0]
        assert bool(torch.all((rows - ref).abs() <= tol + tol * ref.abs()))
        assert torch.equal(rows, k[:, r0:r1].T)
        assert torch.equal(rows[idx - r0, idx], diag.expand(r1 - r0))


def test_cholesky_kernel_takes_n_past_4096(dev):
    """K5's blocked path at N = 4097 (past 4096; its indices are 64-bit)
    against the plain version in f64."""
    before = ck.LAUNCHES["cholesky"]
    gp_cuda.check_cholesky(gp_cuda.spd_inputs(4097, 1, seed=4097,
                                              device=dev))
    torch.cuda.synchronize()
    assert ck.LAUNCHES["cholesky"] == before + 1


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


@pytest.mark.parametrize("ny,b,n,d", [
    # the --large-fit validation's shape; ragged (N % 4 != 0: 4-byte
    # stores, a partial last point tile); one query, one point
    (4, 1000, 1000, 6), (4, 1000, 500, 6), (3, 37, 101, 6), (1, 1, 1, 6),
    (2, 9, 129, 3),
    # D past one feature chunk of 8, and past 64
    (4, 19, 130, 9), (4, 19, 130, 65), (2, 33, 101, 300)])
def test_predict_kernel_wide_and_large_shapes(dev, ny, b, n, d):
    """K3 within k* 2e-5 and mu 2e-4 of the plain version (ell scaled by
    sqrt(D) past D = 6, so k* is not 0), one launch a call, and mu the same
    bits on a second call (no atomics)."""
    args = gp_cuda.predict_inputs(n, d, b, ny, seed=b + n, device=dev,
                                  ell_scale=np.sqrt(d) if d > 6 else 1.0)
    before = ck.LAUNCHES["gp_predict_batch"]
    gp_cuda.check_gp_predict_batch(*args)
    mu1, ks1 = gp_cuda.gp_predict_batch(*args)
    mu2, ks2 = gp_cuda.gp_predict_batch(*args)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["gp_predict_batch"] == before + 3
    assert torch.equal(mu1, mu2) and torch.equal(ks1, ks2)


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


def _study(dev, fused, b):
    """Bench config 5's study (the fixture GP, capacity 128, Nt=8, the
    al1 x mi3 x ls4 budget) on the card, f32; with ``fused`` the KKT sweep
    kernel and the fused plant.  Returns the study, x0s and 2 steps of
    noise."""
    from benchmarks.bench_spec import DT, MODEL_R
    from gpmpc_tpu_torch import Model
    from gpmpc_tpu_torch.models.convert import gp_from_fixture
    from gpmpc_tpu_torch.parallel import BatchedStudy

    model = Model(Nx=4, Nu=2, ode=four_tank_ode, dt=DT, R=MODEL_R,
                  clip_negative=True, integrator_substeps=10,
                  fused_integrator=fused, device=dev)
    gp = gp_from_fixture(device=dev, optimizer_opts=dict(jitter=1e-5,
                                                         min_noise=1e-4))
    budget = dict(al_iters=1, max_iters=3, ls_steps=4, fused_kkt=fused)
    study = BatchedStudy(model, gp, horizon=8 * DT,
                         Q=np.diag([10.0, 10.0, 0.1, 0.1]),
                         R=0.01 * np.eye(2), ulb=[0.0, 0.0], uub=[8.0, 8.0],
                         capacity=128, solver_opts=budget)
    rng = np.random.default_rng(0)
    x0s = np.array([8.0, 9.0, 1.0, 1.0]) + 0.5 * rng.uniform(size=(b, 4))
    noise = 0.01 * rng.standard_normal((b, 2, 4))
    return study, x0s, noise


#: the study's setpoint (bench.py:432)
XSP = np.array([12.4, 12.7, 1.8, 1.4])


def test_study_step_on_the_card_batches_its_kernels(dev):
    """One study step at B=64 with ``fused_kkt`` and the fused plant: one
    K1 launch per inner SQP step (3) and one K2 launch for all 64 rollouts,
    and the next states within 1e-3 (relative to 1 + |x|) of the same step
    with the plain batched KKT sweep and plant (f32 rounding of the kernels
    can flip a line-search choice); the second step too."""
    fused, x0s, noise = _study(dev, True, 64)
    plain, _, _ = _study(dev, False, 64)
    ck.reset_launches()
    got = fused.run(x0s, XSP, 1, noise_ws=noise[:, :1])
    torch.cuda.synchronize()
    assert ck.LAUNCHES == {"riccati_sweep": 3, "rk4_substeps": 1,
                           "se_ard_gram": 0, "cholesky": 0,
                           "gp_predict_batch": 0}
    ref = plain.run(x0s, XSP, 1, noise_ws=noise[:, :1])
    assert ck.LAUNCHES["riccati_sweep"] == 3
    x, r = got.x_traj[:, -1].cpu(), ref.x_traj[:, -1].cpu()
    assert bool(torch.all((x - r).abs() <= 1e-3 * (1.0 + r.abs())))
    two = fused.run(x0s, XSP, 2, noise_ws=noise)
    assert ck.LAUNCHES["riccati_sweep"] == 3 + 6
    assert ck.LAUNCHES["rk4_substeps"] == 1 + 2
    assert bool(torch.all(torch.isfinite(two.x_traj)))


def test_riccati_vmap_rule_launches_once_on_the_card(dev):
    """The K1 wrapper under ``torch.func.vmap`` on CUDA tensors: one launch
    for the batch of 16 (the vmap rule of ``gpmpc::riccati_sweep``), equal
    to the kernel's batched call; K2 the same."""
    from torch.func import vmap
    args = ck.stage_qp_inputs(8, 4, 2, 3, batch=16, device=dev)
    reg = torch.full((16,), 1e-6, device=dev)
    ck.reset_launches()
    got = vmap(ck.riccati_sweep, in_dims=(0,) * 10 + (None, 0))(
        *args[:10], args[10][0], reg)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["riccati_sweep"] == 1
    ref = ck.riccati_sweep(*args[:10], args[10][0].expand(16, 4)
                           .contiguous(), reg)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    x, u = ck.rk4_inputs(16, 3, dev)
    y = vmap(lambda a, b: ck.rk4_substeps(four_tank_ode, a, b, 0.3, 10))(x, u)
    assert ck.LAUNCHES["rk4_substeps"] == 1
    assert torch.equal(y, ck.rk4_substeps(four_tank_ode, x, u, 0.3, 10))
