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


@pytest.mark.parametrize("shape", [None, (20, 6, 2), (5, 4, 4), (8, 3, 3)])
def test_riccati_kernel_indefinite_gives_nan(dev, shape):
    ck.check_riccati_sweep_bad_pivot("indefinite", device=dev, shape=shape)


@pytest.mark.parametrize("shape", [None, (20, 6, 2), (5, 4, 4), (8, 3, 3)])
def test_riccati_kernel_zero_pivot_gives_non_finite_gains(dev, shape):
    ck.check_riccati_sweep_bad_pivot("zero", device=dev, shape=shape)


def test_riccati_kernel_refuses_an_uninstantiated_shape(dev):
    """Every (nx, nu) launches a kernel: a pair past the warp kernel's lane
    limits, (31, 2) and (4, 33), launches once on the block path (no
    library of its own), within the plain version's tolerances; nx < 1
    raises ValueError before any launch."""
    for nx, nu in [(31, 2), (4, 33)]:
        assert ck.riccati_path(nx, nu) == "block"
        args = ck.stage_qp_inputs(8, nx, nu, 0, device=dev)
        before = ck.LAUNCHES["riccati_sweep"]
        ck.check_riccati_sweep(args, torch.tensor(1e-6, device=dev))
        torch.cuda.synchronize()
        assert ck.LAUNCHES["riccati_sweep"] == before + 1
        assert (nx, nu) not in ck.RICCATI_BUILDS
    with pytest.raises(ValueError, match="nx >= 1"):
        ck.riccati_entry(0, 2)


#: K1's block path: past each lane limit, the four-tank network's MPC (40,
#: 20) and MHE (40, 40), and a pair whose working set passes shared memory
K1_BLOCK_SHAPES = [(31, 2), (4, 33), (40, 20), (40, 40), (96, 48)]


@pytest.mark.parametrize("nt", [3, 20, 33])
@pytest.mark.parametrize("batch", [None, 64])
@pytest.mark.parametrize("nx,nu", K1_BLOCK_SHAPES)
def test_riccati_block_path_matches_plain_version(dev, nx, nu, batch, nt):
    """K1's block path at one problem and a batch, horizons of 3, 20 and
    33 stages: one launch, within the plain version's tolerances
    (``riccati_check_tolerances``: widened to 3x the plain version's own
    f32-versus-f64 gap where that is larger, never past 1e-4 x scale)."""
    assert ck.riccati_path(nx, nu) == "block"
    args = ck.stage_qp_inputs(nt, nx, nu, nt + nx + nu, batch, device=dev)
    reg = torch.full(() if batch is None else (batch,), 1e-6, device=dev)
    ck.reset_launches()
    ck.check_riccati_sweep(args, reg)
    torch.cuda.synchronize()
    assert ck.RICCATI_LAUNCHES == {(nx, nu): 1}


@pytest.mark.parametrize("kind", ["indefinite", "zero"])
@pytest.mark.parametrize("nx,nu", K1_BLOCK_SHAPES)
def test_riccati_block_path_bad_pivot_gives_non_finite_gains(dev, nx, nu,
                                                             kind):
    ck.check_riccati_sweep_bad_pivot(kind, device=dev, shape=(8, nx, nu))


@pytest.mark.parametrize("nx,nu", [(40, 20), (40, 40), (96, 48)])
def test_riccati_block_path_vmap_rule_launches_once(dev, nx, nu):
    """Under ``torch.func.vmap`` a block-path pair goes through the custom
    operator's vmap rule: one launch for B = 64, within the plain
    version's tolerances, bitwise the batched call's; a run repeats
    bitwise (the decrease sums in a fixed order)."""
    from torch.func import vmap
    args = ck.stage_qp_inputs(20, nx, nu, 13, batch=64, device=dev)
    reg = torch.full((64,), 1e-6, device=dev)
    ck.reset_launches()
    ck.check_riccati_sweep(args, reg, vmapped=True)
    torch.cuda.synchronize()
    assert ck.RICCATI_LAUNCHES == {(nx, nu): 1}
    for g, r in zip(vmap(ck.riccati_sweep)(*args, reg),
                    ck.riccati_sweep(*args, reg)):
        assert torch.equal(g, r)


#: K1's block path at its tile and panel edges: nu on both sides of one
#: and two 32-column Cholesky panels, nx on both sides of the warp kernel's
#: lane limit and of 32 and 64 (4-row tiles, a float4's padding)
K1_EDGE_NU = [32, 33, 64, 65]
K1_EDGE_NX = [31, 32, 63, 64, 65]
#: and one pair of each layout no edge pair takes: one stage buffer beside
#: a working set in shared memory (52, 52); one beside a working set in
#: the workspace (130, 5); a stage past shared memory, so in the workspace
#: too (200, 3)
K1_LAYOUT_PAIRS = [(52, 52), (130, 5), (200, 3)]


@pytest.mark.parametrize("batch", [None, 64])
@pytest.mark.parametrize("nx,nu", [(nx, nu) for nx in K1_EDGE_NX
                                   for nu in K1_EDGE_NU] + K1_LAYOUT_PAIRS)
def test_riccati_block_path_at_tile_and_panel_edges(dev, nx, nu, batch):
    """At Nt = 3, one problem and a batch of 64 through the vmap rule (one
    launch): within the plain version's tolerances, and a repeated launch
    bitwise the same; at one problem also an indefinite and a zero H_uu
    pivot give non-finite gains."""
    assert ck.riccati_path(nx, nu) == "block"
    args = ck.stage_qp_inputs(3, nx, nu, 3 + nx + nu, batch, device=dev)
    reg = torch.full(() if batch is None else (batch,), 1e-6, device=dev)
    ck.reset_launches()
    ck.check_riccati_sweep(args, reg, vmapped=batch is not None)
    torch.cuda.synchronize()
    assert ck.RICCATI_LAUNCHES == {(nx, nu): 1}
    for g, r in zip(ck.riccati_sweep(*args, reg),
                    ck.riccati_sweep(*args, reg)):
        assert torch.equal(g, r)
    if batch is None:
        for kind in ("indefinite", "zero"):
            ck.check_riccati_sweep_bad_pivot(kind, device=dev,
                                             shape=(3, nx, nu))


@pytest.mark.parametrize("nx,nu", [(40, 20), (40, 40), (65, 33), (96, 48)])
def test_riccati_block_path_takes_an_asymmetric_cost_as_the_plain_version(
        dev, nx, nu):
    """Q_xx and Q_uu with a strictly upper triangular part added: the
    plain version factors H_uu's lower triangle as given and takes V and
    the decrease from the whole of Q; the block path agrees within its
    tolerances."""
    args = ck.stage_qp_inputs(3, nx, nu, 7 + nx + nu, device=dev)
    gen = torch.Generator().manual_seed(nx * 100 + nu)
    for i, n in ((3, nx), (4, nu)):
        upper = torch.triu(0.1 * torch.randn((3, n, n), generator=gen), 1)
        args[i] = (args[i] + upper.to(dev)).contiguous()
    ck.check_riccati_sweep(args, torch.tensor(1e-6, device=dev))


def test_riccati_block_layout_is_the_library_s(dev):
    """``riccati_block_layout`` is the layout the built kernel takes, on
    both sides of every break for nx = nu and at lopsided pairs."""
    import ctypes
    lib = ck.build_library()
    out = (ctypes.c_int * 4)()
    for nx in range(1, 130, 3):
        for nu in (1, 2, 7, 20, 33, 48, nx):
            lib.gpmpc_riccati_block_layout(nx, nu, out)
            assert (out[0], bool(out[1]), out[2], out[3]) == tuple(
                ck.riccati_block_layout(nx, nu)), (nx, nu)


#: (nx, nu) of K1 beyond the car's: the four-tank MHE's pre-built (4, 4),
#: and (3, 3) (the linear MHE tests' NLP) and (5, 1), built at first use
K1_MORE_SHAPES = [(4, 4), (3, 3), (5, 1)]


@pytest.mark.parametrize("nt", [5, 20, CH + 1])
@pytest.mark.parametrize("batch", [None, 64])
@pytest.mark.parametrize("nx,nu", K1_MORE_SHAPES)
def test_riccati_kernel_at_more_shapes(dev, nx, nu, batch, nt):
    """K1 at (4, 4) and at pairs not pre-built, one problem and a batch,
    horizons inside and across a chunk: within the plain version's
    tolerances, one launch; a pair not pre-built has its own library."""
    args = ck.stage_qp_inputs(nt, nx, nu, nt + 7 * nx + nu, batch,
                              device=dev)
    reg = torch.full(() if batch is None else (batch,), 1e-6, device=dev)
    before = ck.LAUNCHES["riccati_sweep"]
    ck.check_riccati_sweep(args, reg)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["riccati_sweep"] == before + 1
    if (nx, nu) not in ck.RICCATI_SHAPES:
        assert ck.riccati_library_path(nx, nu).exists()
        assert ck.RICCATI_BUILDS[(nx, nu)]["path"] == str(
            ck.riccati_library_path(nx, nu))


@pytest.mark.parametrize("nx,nu", K1_MORE_SHAPES)
def test_riccati_vmap_rule_at_more_shapes(dev, nx, nu):
    """Under ``torch.func.vmap`` K1 at these pairs goes through the custom
    operator's vmap rule: one launch for a batch of 64, within the plain
    version's tolerances, bitwise the batched call's."""
    from torch.func import vmap
    args = ck.stage_qp_inputs(8, nx, nu, 11, batch=64, device=dev)
    reg = torch.full((64,), 1e-6, device=dev)
    ck.reset_launches()
    ck.check_riccati_sweep(args, reg, vmapped=True)
    torch.cuda.synchronize()
    assert ck.RICCATI_LAUNCHES == {(nx, nu): 1}
    for g, r in zip(vmap(ck.riccati_sweep)(*args, reg),
                    ck.riccati_sweep(*args, reg)):
        assert torch.equal(g, r)


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


def test_traced_k2_runs_a_wrapped_car_ode_on_the_card(dev, monkeypatch):
    """A wrapped car ODE (no tag) is traced into a functor of its own at
    Model construction, and ``integrate`` launches that spec without
    registering again: fused on the card it agrees with the plain version
    and with the hand-written Car functor, one launch each, counted by its
    ode_id; an op outside the lowering raises at Model construction,
    before any launch."""
    from gpmpc_tpu_torch import Model
    from gpmpc_tpu_torch.systems import car_ode
    ck.reset_launches()
    m = Model(Nx=4, Nu=2, ode=lambda x, u: car_ode(x, u), dt=0.1,
              integrator_substeps=10, fused_integrator=True, device=dev)
    assert m.k2.functor is not None and m.k2.ode_id >= len(ck.CUDA_ODES)
    x, u = ck.car_inputs(200, 3, dev)
    with monkeypatch.context() as mp:
        mp.setattr(ck, "register_ode", None)    # integrate must not call it
        got = m.integrate(x, u)
    ref = ck.rk4_substeps_rollouts(m.ode, x, u, 0.01, 10)
    car = ck.rk4_substeps(car_ode, x, u, 0.01, 10)
    torch.cuda.synchronize()
    assert torch.all((got - ref).abs() <= 1e-6 + 1e-5 * ref.abs())
    assert torch.all((got - car).abs() <= 1e-6 + 1e-5 * car.abs())
    assert ck.K2_LAUNCHES == {m.k2.ode_id: 1, ck.CUDA_ODES["car"][0]: 1}
    with pytest.raises(ValueError, match=r"aten\.cumsum"):
        Model(Nx=4, Nu=2, ode=lambda x, u: torch.cumsum(car_ode(x, u), 0),
              dt=0.1, fused_integrator=True, device=dev)
    assert ck.LAUNCHES["rk4_substeps"] == 2


@pytest.mark.parametrize("batch", [None, 8, 1024])
@pytest.mark.parametrize("which", ["four_tank", "quadrotor", "pendulum",
                                   "closure"])
def test_traced_k2_matches_plain_version(dev, which, batch):
    """K2 traced for the lambda-wrapped four-tank ODE (bench.py's plant),
    the 1.3 kg quadrotor through functools.partial, the pendulum
    walkthrough's ODE (written for one point) and a closure over a CUDA
    tensor, against the plain version over each rollout, at K2's card
    tolerance (rtol 1e-5, atol 1e-6); one launch a call."""
    import functools
    from gpmpc_tpu_torch.examples.pendulum import pendulum_ode
    from gpmpc_tpu_torch.systems import QUAD_PARAMS, planar_quadrotor_ode
    c = torch.tensor([1.0, 2.0, 3.0], device=dev)
    rng = np.random.default_rng(11)
    lead = () if batch is None else (batch,)
    ode, nx, nu, h, n_sub, x, u = {
        "four_tank": (lambda a, b: four_tank_ode(a, b), 4, 2, 0.3, 10,
                      np.abs(rng.standard_normal(lead + (4,))) * 4 + 0.5,
                      np.abs(rng.standard_normal(lead + (2,))) * 3),
        "quadrotor": (functools.partial(planar_quadrotor_ode,
                                        p=dict(QUAD_PARAMS, m=1.3)),
                      6, 2, 0.0125, 4,
                      rng.uniform(-1.0, 1.0, lead + (6,)),
                      rng.uniform(2.0, 9.0, lead + (2,))),
        "pendulum": (pendulum_ode, 2, 1, 0.01, 10,
                     rng.uniform(-3.0, 3.0, lead + (2,)),
                     rng.uniform(-5.0, 5.0, lead + (1,))),
        "closure": (lambda a, b: torch.where(
            a > 1.0, torch.clamp(a * c, 0.1, 5.0) ** 2, (1.0 - a) / 2.0
            + b[..., 0:1]), 3, 1, 0.05, 10,
            rng.uniform(-2.0, 2.5, lead + (3,)),
            rng.uniform(-1.0, 1.0, lead + (1,))),
    }[which]
    kw = dict(dtype=torch.float32, device=dev)
    x, u = torch.tensor(x, **kw), torch.tensor(u, **kw)
    spec = ck.register_ode(ode, nx, nu, dev)
    assert spec.functor is not None
    before = ck.K2_LAUNCHES.get(spec.ode_id, 0)
    ck.check_rk4_substeps(ode, x, u, h, n_sub, spec=spec)
    torch.cuda.synchronize()
    assert ck.K2_LAUNCHES[spec.ode_id] == before + 1


def test_traced_k2_vmap_rule_is_one_launch(dev):
    """Under vmap a traced functor goes through gpmpc::rk4_substeps, whose
    vmap rule launches it once for the batch (the quadrotor's residual
    data, as examples/quadrotor.py draws it)."""
    import functools
    from gpmpc_tpu_torch.systems import QUAD_PARAMS, planar_quadrotor_ode
    from gpmpc_tpu_torch import Model
    plant = Model(Nx=6, Nu=2, dt=0.05, integrator_substeps=4,
                  ode=functools.partial(planar_quadrotor_ode,
                                        p=dict(QUAD_PARAMS, m=1.3)),
                  fused_integrator=True, device=dev)
    rng = np.random.default_rng(12)
    kw = dict(dtype=torch.float32, device=dev)
    x = torch.tensor(rng.uniform(-1.0, 1.0, (40, 6)), **kw)
    u = torch.tensor(rng.uniform(2.0, 9.0, (40, 2)), **kw)
    ck.reset_launches()
    got = torch.func.vmap(plant.integrate)(x, u)
    torch.cuda.synchronize()
    assert ck.K2_LAUNCHES == {plant.k2.ode_id: 1}
    ref = ck.rk4_substeps_rollouts(plant.ode, x, u, 0.0125, 4)
    assert torch.all((got - ref).abs() <= 1e-6 + 1e-5 * ref.abs())


def test_traced_k2_refuses_a_trace_on_the_card(dev):
    """Recording a traced functor's K2 into a graph raises (its ode_id
    means nothing in another process); a hand-written one's is recorded
    as gpmpc::rk4_substeps."""
    from torch.fx.experimental.proxy_tensor import make_fx
    x, u = ck.rk4_inputs(None, 1, dev)
    with pytest.raises(RuntimeError, match="ROADMAP §2 item 2"):
        make_fx(lambda a, b: ck.rk4_substeps(
            lambda p, q: four_tank_ode(p, q), a, b, 0.3, 10))(x, u)
    g = make_fx(lambda a, b: ck.rk4_substeps(four_tank_ode, a, b, 0.3,
                                             10))(x, u)
    assert any(n.target is torch.ops.gpmpc.rk4_substeps.default
               for n in g.graph.nodes)


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


def _study(dev, fused, b, mesh=None, ode=four_tank_ode):
    """Bench config 5's study (the fixture GP, capacity 128, Nt=8, the
    al1 x mi3 x ls4 budget) on the card, f32; with ``fused`` the KKT sweep
    kernel and the fused plant (of ``ode``); sharded over ``mesh``.
    Returns the study, x0s and 2 steps of noise."""
    from benchmarks.bench_spec import DT, MODEL_R
    from gpmpc_tpu_torch import Model
    from gpmpc_tpu_torch.models.convert import gp_from_fixture
    from gpmpc_tpu_torch.parallel import BatchedStudy

    model = Model(Nx=4, Nu=2, ode=ode, dt=DT, R=MODEL_R,
                  clip_negative=True, integrator_substeps=10,
                  fused_integrator=fused, device=dev)
    gp = gp_from_fixture(device=dev, optimizer_opts=dict(jitter=1e-5,
                                                         min_noise=1e-4))
    budget = dict(al_iters=1, max_iters=3, ls_steps=4, fused_kkt=fused)
    study = BatchedStudy(model, gp, horizon=8 * DT,
                         Q=np.diag([10.0, 10.0, 0.1, 0.1]),
                         R=0.01 * np.eye(2), ulb=[0.0, 0.0], uub=[8.0, 8.0],
                         capacity=128, solver_opts=budget, mesh=mesh)
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


def test_one_rank_nccl_study_is_the_local_study(dev, tmp_path):
    """The study at B=64 through ``mesh=`` on a one-rank NCCL group (a
    ``file://`` rendezvous): K1 3 launches a step and K2 1, each for all 64
    rollouts, as without a mesh, and every result bitwise the same; the
    group destroyed afterwards."""
    import torch.distributed as dist
    from gpmpc_tpu_torch.parallel import distributed

    assert distributed.initialize_multihost(
        coordinator_address=f"file://{tmp_path / 'rendezvous'}",
        num_processes=1, process_id=0, backend="nccl", device="cuda",
        timeout=120)
    try:
        mesh = distributed.make_study_mesh()
        assert mesh.mesh_dim_names == ("dp",) and mesh.size() == 1
        results = []
        for m in (None, mesh):
            study, x0s, noise = _study(dev, True, 64, mesh=m)
            ck.reset_launches()
            results.append(study.run(x0s, XSP, 2, noise_ws=noise))
            torch.cuda.synchronize()
            assert ck.LAUNCHES == {"riccati_sweep": 6, "rk4_substeps": 2,
                                   "se_ard_gram": 0, "cholesky": 0,
                                   "gp_predict_batch": 0}
        local, sharded = results
        for name in ("x_traj", "u_traj", "cost", "obj", "gp_points",
                     "mean_cost"):
            assert torch.equal(getattr(sharded, name), getattr(local, name))
        for a, b in zip(sharded.post, local.post):
            assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()


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


# ------------------------------------------------- slice F, part 1

#: (Ny, B, N, D) of K3 on the control path: the fixture GP's UT sigma
#: points (2D + 1 = 13) and its order-3 GH tensor grid (3^6 = 729)
SIGMA_POINT_SHAPES = [(4, 13, 100, 6), (4, 729, 100, 6)]


@pytest.mark.parametrize("ny,b,n,d", SIGMA_POINT_SHAPES)
def test_predict_kernel_at_the_sigma_point_shapes(dev, ny, b, n, d):
    before = ck.LAUNCHES["gp_predict_batch"]
    gp_cuda.check_gp_predict_batch(*gp_cuda.predict_inputs(n, d, b, ny, b,
                                                           device=dev))
    torch.cuda.synchronize()
    assert ck.LAUNCHES["gp_predict_batch"] == before + 1


def _to_cpu(v):
    """Tensors, and (named) tuples of them, moved to the CPU."""
    if torch.is_tensor(v):
        return v.cpu()
    return type(v)(*map(_to_cpu, v)) if hasattr(v, "_fields") else v


def _sigma_point_mpc(dev, method, ode=four_tank_ode, **kw):
    """The fixture GP (N=100) at Nt=5 with UT or GH propagation, tightening
    and feedback, f32 on the card, fused KKT and plant (of ``ode``)."""
    from benchmarks.bench_spec import (DT, MODEL_R, Q_W, R_W, ULB, UUB, XLB,
                                       XSP, XUB)
    from gpmpc_tpu_torch import MPC, Model
    from gpmpc_tpu_torch.models.convert import gp_from_fixture

    m = Model(Nx=4, Nu=2, ode=ode, dt=DT, R=MODEL_R,
              clip_negative=True, integrator_substeps=10,
              fused_integrator=True, device=dev)
    g = gp_from_fixture(device=dev, gp_method=method,
                        optimizer_opts=dict(jitter=1e-5, min_noise=1e-4))
    return MPC(horizon=5 * DT, model=m, gp=g, gp_method=method, Q=Q_W,
               R=R_W, ulb=ULB, uub=UUB, xlb=XLB, xub=XUB, percentile=0.95,
               feedback=True, cov_updates=1, op_x=XSP,
               op_u=np.array([3.0, 3.0]),
               solver_opts=dict(al_iters=2, max_iters=2, fused_kkt=True),
               init_solver_opts=dict(al_iters=1, max_iters=3,
                                     fused_kkt=True), device=dev, **kw)


@pytest.mark.parametrize("method", ["UT", "GH"])
def test_sigma_point_solve_step_launches_k3_once_a_stage(dev, method):
    """A cold and a warm UT or GH solve_step on the card: K3 once per stage
    per covariance pass (Nt = 5), K1 once per inner SQP step, no other
    kernel; finite, and the step's covariances within 1e-2 of the same
    propagation on the CPU from the card's posterior (chip_smoke.py's
    F_PROP_TOL: K3's errors carried by the sigma points' deviations)."""
    from benchmarks.bench_spec import X0, XSP

    mpc = _sigma_point_mpc(dev, method)
    ck.reset_launches()
    u0, warm, sig, _ = mpc.solve_step(X0, XSP)
    x1 = mpc.model.integrate(torch.as_tensor(X0, dtype=torch.float32,
                                             device=dev), u0)
    u1, _, sig1, _ = mpc.solve_step(x1, XSP, warm=warm, u_prev=u0)
    torch.cuda.synchronize()
    assert ck.LAUNCHES == {"riccati_sweep": 3 + 4, "rk4_substeps": 1,
                           "se_ard_gram": 0, "cholesky": 0,
                           "gp_predict_batch": 2 * 5}
    assert bool(torch.all(torch.isfinite(sig1))) and \
        bool(torch.all(torch.isfinite(u1)))
    cpu = _sigma_point_mpc(torch.device("cpu"), method)
    cpu.consts = _to_cpu(mpc.consts)
    sig_c = cpu.propagate_covariances(warm.x.cpu(), warm.u.cpu(),
                                      torch.zeros((4, 4)), cpu.consts)
    sig_d = mpc.propagate_covariances(warm.x, warm.u,
                                      torch.zeros((4, 4), device=dev),
                                      mpc.consts)
    torch.testing.assert_close(sig_d.cpu(), sig_c, rtol=0,
                               atol=1e-2 * float(sig_c.abs().max()))


def test_predict_kernel_raises_under_a_transform(dev):
    """On a CUDA tensor K3's wrapper refuses a derivative transform (K3 has
    no derivative) instead of running the plain version; under ``vmap`` it
    launches (its vmap rule, one launch)."""
    z, x, ell, sf2, alpha = gp_cuda.predict_inputs(100, 6, 13, 4, 0,
                                                   device=dev)
    with pytest.raises(RuntimeError, match="no derivative"):
        torch.func.jacfwd(lambda zz: gp_cuda.gp_predict_batch(
            zz.reshape(-1, 6), x, ell, sf2, alpha)[0])(z)
    before = ck.LAUNCHES["gp_predict_batch"]
    mu, _ = torch.func.vmap(lambda zz: gp_cuda.gp_predict_batch(
        zz[None], x, ell, sf2, alpha))(z)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["gp_predict_batch"] == before + 1
    assert mu.shape == (13, 4, 1)


# ------------------------------------------------- slice F, part 3

@pytest.mark.parametrize("lanes,n,per_lane", [(16, 100, False),
                                              (64, 100, False),
                                              (16, 128, True),
                                              (5, 33, True)])
def test_predict_vmap_rule_on_the_card(dev, lanes, n, per_lane):
    """K3 under ``torch.func.vmap`` on the card: the lanes' 13 sigma points
    against one posterior (folded into the query dim) or against a
    posterior of each lane's own (the lanes on the kernel's problem dim),
    one launch per vmapped call, each lane within k* 2e-5 and mu 2e-4 of
    its plain version (tests/test_pallas.py's tolerances)."""
    from torch.func import vmap
    z, x, ell, sf2, alpha = gp_cuda.predict_inputs(n, 6, 13 * lanes, 4,
                                                   lanes, device=dev)
    z = z.reshape(lanes, 13, 6)
    if per_lane:
        g = torch.Generator(device=dev).manual_seed(lanes)
        args = (z, (x + 0.1 * torch.randn((lanes, n, 6), generator=g,
                                          device=dev)).contiguous(),
                ell.expand(lanes, 4, 6).contiguous(),
                sf2.expand(lanes, 4).contiguous(),
                (alpha + 0.1 * torch.randn((lanes, 4, n), generator=g,
                                           device=dev)).contiguous())
        fn = vmap(gp_cuda.gp_predict_batch)
    else:
        args = (z,)
        fn = vmap(lambda zz: gp_cuda.gp_predict_batch(zz, x, ell, sf2,
                                                      alpha))
    before = ck.LAUNCHES["gp_predict_batch"]
    mu, ks = fn(*args)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["gp_predict_batch"] == before + 1
    assert mu.shape == (lanes, 4, 13) and ks.shape == (lanes, 4, 13, n)
    for i in range(lanes):
        one = ([a[i] for a in args] if per_lane
               else [z[i], x, ell, sf2, alpha])
        mu_r, ks_r = gp_cuda.gp_predict_batch_reference(*one)
        torch.testing.assert_close(ks[i], ks_r, rtol=gp_cuda.KS_TOL,
                                   atol=gp_cuda.KS_TOL)
        torch.testing.assert_close(mu[i], mu_r, rtol=gp_cuda.MU_TOL,
                                   atol=gp_cuda.MU_TOL)


@pytest.mark.parametrize("n,p", [(32, 4), (32, 8), (12, 2), (64, 8)])
def test_cholesky_kernel_at_the_sparse_shapes(dev, n, p):
    """K5 at the sparse GP's M x M shapes (P = starts x Ny problems of the
    VFE fit, Ny of its posterior), on K_MM-like matrices (the SE kernel of
    M points plus the 800-ulp jitter) and on I + A A': within 2e-4 max|L|
    of the plain version in f64."""
    from gpmpc_tpu_torch.ops.kernels import kernel_cross
    rng = np.random.default_rng(n + p)
    z = torch.tensor(rng.uniform(-2, 2, (n, 6)), dtype=torch.float32,
                     device=dev)
    ell = torch.tensor(np.exp(rng.normal(0.5, 0.3, (p, 1, 6))),
                       dtype=torch.float32, device=dev)
    eye = torch.eye(n, device=dev)
    k = kernel_cross("se", z, z, ell, torch.ones((p, 1, 1), device=dev))
    k_mm = (k * (1.0 - eye) + (1.0 + 1e-4) * eye).contiguous()
    gp_cuda.check_cholesky(k_mm)
    a = torch.tensor(rng.standard_normal((p, n, 3 * n)), dtype=torch.float32,
                     device=dev)
    gp_cuda.check_cholesky((eye + a @ a.mT / n).contiguous())


def test_sparse_fit_on_the_card_counts_its_launches(dev):
    """GP(inducing=16) on 50 fixture points: K4 and K5 once per evaluation
    of the exact subset fit, two K5 per VFE evaluation and two for the
    posterior, nothing else; its validate one K3 launch."""
    from gpmpc_tpu_torch import GP
    from gpmpc_tpu_torch.models.convert import FIXTURE

    f = np.load(FIXTURE)
    ck.reset_launches()
    gp = GP(f["tank_X"][:50], f["tank_Y"][:50], inducing=16, multistart=1,
            max_iters=20, optimizer_opts=dict(jitter=1e-5, min_noise=1e-4),
            device=dev)
    torch.cuda.synchronize()
    ev = gp.fit_evals
    assert ck.LAUNCHES == {"riccati_sweep": 0, "rk4_substeps": 0,
                           "se_ard_gram": ev["exact"],
                           "cholesky": ev["exact"] + 2 * ev["vfe"] + 2,
                           "gp_predict_batch": 0}
    assert bool(torch.all(torch.isfinite(gp.nll)))
    ck.reset_launches()
    smse, mnlp, _ = gp.validate(f["tank_X"][50:], f["tank_Y"][50:],
                                verbose=False)
    assert ck.LAUNCHES["gp_predict_batch"] == 1
    assert np.all(np.isfinite(mnlp)) and np.all(smse < 0.1)


@pytest.mark.parametrize("method", ["TA", "UT"])
def test_solve_mc_on_the_card_counts_its_launches(dev, method):
    """MPC.solve_mc, 8 lanes x 3 steps at Nt = 5 (fused KKT and plant):
    K1 once per inner SQP step and K2 once per control step, each for all
    lanes; with UT K3 once per stage per covariance pass (one vmapped call
    for all lanes); finite, with every lane's convergence flags."""
    from benchmarks.bench_spec import DT, X0, XSP
    mpc = _sigma_point_mpc(dev, method)
    ck.reset_launches()
    xs, us = mpc.solve_mc(X0, 3 * DT, XSP, 8)
    torch.cuda.synchronize()
    assert ck.LAUNCHES == {"riccati_sweep": 3 + 3 * 4, "rk4_substeps": 3,
                           "se_ard_gram": 0, "cholesky": 0,
                           "gp_predict_batch": (5 * 4 if method == "UT"
                                                else 0)}
    assert xs.shape == (8, 4, 4) and bool(torch.all(torch.isfinite(xs)))
    assert mpc.last_mc["converged"].shape == (8, 3)


def test_traced_plant_under_the_study_and_solve_mc(dev):
    """The fused plant's other consumers with its ODE traced (a lambda, as
    bench.py builds it): a BatchedStudy step at B=64 (the plant under
    vmap: one K2 launch for all rollouts) within 1e-3 of the same step
    with the hand-written FourTank, and solve_mc (8 lanes x 2 steps: one
    batched K2 launch a step)."""
    from benchmarks.bench_spec import DT, X0
    lam = lambda x, u: four_tank_ode(x, u)                  # noqa: E731
    traced, x0s, noise = _study(dev, True, 64, ode=lam)
    hand, _, _ = _study(dev, True, 64)
    ck.reset_launches()
    got = traced.run(x0s, XSP, 1, noise_ws=noise[:, :1])
    torch.cuda.synchronize()
    assert ck.K2_LAUNCHES == {traced.model.k2.ode_id: 1}
    assert traced.model.k2.ode_id >= len(ck.CUDA_ODES)
    ref = hand.run(x0s, XSP, 1, noise_ws=noise[:, :1])
    x, r = got.x_traj[:, -1].cpu(), ref.x_traj[:, -1].cpu()
    assert bool(torch.all((x - r).abs() <= 1e-3 * (1.0 + r.abs())))
    mpc = _sigma_point_mpc(dev, "TA", ode=lam)
    ck.reset_launches()
    xs, _ = mpc.solve_mc(X0, 2 * DT, XSP, 8)
    torch.cuda.synchronize()
    assert ck.K2_LAUNCHES == {mpc.model.k2.ode_id: 2}
    assert bool(torch.all(torch.isfinite(xs)))


def test_adaptive_plant_on_the_card_matches_the_cpu(dev):
    """The adaptive DOPRI5 integrator on 16 lanes of the four-tank plant
    in f64 on the card against the CPU within 1e-10; a lane whose budget
    runs out is NaN on both."""
    from gpmpc_tpu_torch import Model
    rng = np.random.default_rng(4)
    x = rng.uniform(1.0, 15.0, (16, 4))
    u = rng.uniform(0.0, 6.0, (16, 2))
    out = []
    for d in (dev, torch.device("cpu")):
        m = Model(Nx=4, Nu=2, ode=four_tank_ode, dt=3.0,
                  integrator="adaptive", device=d, dtype=torch.float64)
        out.append(m.integrate(torch.tensor(x, device=d),
                               torch.tensor(u, device=d)).cpu())
    torch.testing.assert_close(out[0], out[1], rtol=0, atol=1e-10)
    stiff = Model(Nx=1, Nu=1, ode=lambda x, u: -u * x, dt=1.0,
                  integrator="adaptive", rtol=1e-10, atol=1e-12,
                  max_adaptive_steps=50, device=dev, dtype=torch.float64)
    got = stiff.integrate(torch.ones((2, 1), dtype=torch.float64, device=dev),
                          torch.tensor([[1.0], [1e9]], dtype=torch.float64,
                                       device=dev)).cpu()
    assert bool(torch.isfinite(got[0]).all()) and bool(torch.isnan(got[1]).all())


def test_cubature5_on_the_card_makes_no_host_sync(dev):
    """propagate_gh with the cubature5 rule at D = 8 (its PSD floor by
    fixed Jacobi sweeps) under torch.cuda.set_sync_debug_mode("error"): no
    host sync; K3 launched once; Sigma_y PSD and within 1e-2 of the CPU's
    f64 result (mu_y within 2e-4)."""
    from gpmpc_tpu_torch.models.convert import gp_from_numpy
    from gpmpc_tpu_torch.models.propagate import propagate_gh

    rng = np.random.default_rng(8)
    x = rng.uniform(-2, 2, (60, 8))
    y = np.stack([np.sin(x[:, 0]) + x[:, 1], np.cos(x[:, 2]) * x[:, 3],
                  x[:, 4] * x[:, 7]], axis=1)
    hyp = dict(log_ell=0.3 * rng.standard_normal((3, 8)),
               log_sf2=np.zeros(3), log_sn2=np.full(3, -4.0))
    g = gp_from_numpy(x, y, **hyp, device=dev)
    gc = gp_from_numpy(x, y, **hyp, device="cpu", dtype=torch.float64)
    a = 0.3 * rng.standard_normal((8, 8))
    mu, cov = rng.uniform(-1, 1, 8), a @ a.T
    args = [torch.tensor(v, dtype=torch.float32, device=dev)
            for v in (mu, cov)]
    propagate_gh(g.post, g.norm, g.cfg, *args, grid="cubature5")   # warm
    torch.cuda.synchronize()
    ck.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = propagate_gh(g.post, g.norm, g.cfg, *args, grid="cubature5")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert ck.LAUNCHES["gp_predict_batch"] == 1
    ref = propagate_gh(gc.post, gc.norm, gc.cfg, torch.tensor(mu),
                       torch.tensor(cov), grid="cubature5")
    for o, r, tol in zip(out, ref, (2e-4, 1e-2, 1e-2)):
        torch.testing.assert_close(o.cpu().double(), r, rtol=0,
                                   atol=tol * float(r.abs().max()))
    assert float(torch.linalg.eigvalsh(out[1].double()).min()) >= \
        -1e-6 * float(out[1].abs().max())


def test_matern_fit_on_the_card_launches_k5_only(dev):
    """A Matérn-5/2 fit through the GP entry point: one K5 and no K4 per
    objective evaluation (the Matérn Gram is plain PyTorch), three K5 for
    the posterior, and no K3 in its validate (K3 is SE-only)."""
    from gpmpc_tpu_torch import GP
    from gpmpc_tpu_torch.models.convert import FIXTURE

    f = np.load(FIXTURE)
    ck.reset_launches()
    gp = GP(f["tank_X"][:50], f["tank_Y"][:50], kernel="matern52",
            multistart=2, max_iters=20,
            optimizer_opts=dict(jitter=1e-5, min_noise=1e-4), device=dev)
    assert ck.LAUNCHES == {"riccati_sweep": 0, "rk4_substeps": 0,
                           "se_ard_gram": 0, "cholesky": gp.n_evals + 3,
                           "gp_predict_batch": 0}
    assert bool(torch.all(torch.isfinite(gp.nll)))
    smse, mnlp, _ = gp.validate(f["tank_X"][50:], f["tank_Y"][50:],
                                verbose=False)
    assert ck.LAUNCHES["gp_predict_batch"] == 0
    assert np.all(np.isfinite(mnlp)) and np.all(smse < 0.1)


# ------------------------------------------------- slice F, part 2a

def _tank_mhe(dev, dtype=torch.float32):
    """The four-tank MHE of the output-feedback golden's shape on the
    fixture GP: window 4, two levels measured, GP dynamics, the filtered
    arrival cost, fused_kkt (K1 at (4, 4))."""
    from gpmpc_tpu_torch import MHE, Model
    from gpmpc_tpu_torch.models.convert import gp_from_fixture
    model = Model(Nx=4, Nu=2, ode=four_tank_ode, dt=3.0,
                  R=np.diag([1e-3] * 4), clip_negative=True,
                  integrator_substeps=10, device=dev, dtype=dtype)
    gp = gp_from_fixture(device=dev, dtype=dtype,
                         optimizer_opts=dict(jitter=1e-5, min_noise=1e-4))
    c = torch.tensor([[1.0, 0, 0, 0], [0, 1.0, 0, 0]], dtype=dtype,
                     device=dev)
    return MHE(model, gp, window=4, Q_noise=model.R,
               R_meas=np.diag([2.5e-3, 2.5e-3]),
               P_arrival=np.diag([0.5] * 4), h=lambda x: c @ x,
               xlb=[0.0] * 4, discrete_method="gp", arrival_update=True,
               solver_opts=dict(al_iters=2, max_iters=4, fused_kkt=True))


def test_mhe_step_on_the_card_makes_no_host_sync(dev):
    """One MHE filter step on the card (K1 at (4, 4) under fused_kkt, the
    EKF arrival update) under torch.cuda.set_sync_debug_mode("error"):
    no host sync; K1 launched al_iters x max_iters times; the estimate
    within 1e-3 relative of the same step on the CPU."""
    mhe = _tank_mhe(dev)
    x0 = torch.tensor([8.0, 9.0, 1.0, 1.0], device=dev)
    state = mhe.init_filter(x0 + 0.3, x0[:2])
    u = torch.tensor([3.0, 3.0], device=dev)
    for _ in range(mhe.M + 1):                # past the fill-in
        state, _ = mhe._step(state, x0[:2], u)
    torch.cuda.synchronize()
    ck.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        new, (x_hat, res) = mhe._step(state, x0[:2] + 0.01, u)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    cfg = mhe.sqp_cfg
    assert ck.LAUNCHES["riccati_sweep"] == cfg.al_iters * cfg.max_iters
    assert bool(torch.all(torch.isfinite(x_hat)))
    def to_cpu(v):
        if v is None or torch.is_tensor(v):
            return v if v is None else v.cpu()
        return type(v)(*(to_cpu(a) for a in v))

    cpu = _tank_mhe(torch.device("cpu"))
    cpu.consts = to_cpu(mhe.consts)
    _, (x_ref, _) = cpu._step(to_cpu(state), (x0[:2] + 0.01).cpu(), u.cpu())
    assert float(((x_hat.cpu() - x_ref).abs() / x_ref.abs()).max()) < 1e-3


@pytest.mark.parametrize("which", ["riccati_sweep", "rk4_substeps",
                                   "gp_predict_batch"])
def test_opcheck_on_cuda_inputs(dev, which):
    """Schema, fake implementation and AOT dispatch of each kernel's
    custom operator on CUDA tensors (the kernel is the operator's body)."""
    if which == "riccati_sweep":
        args = (*ck.stage_qp_inputs(20, 4, 2, 0, device=dev),
                torch.full((), 1e-6, device=dev))
        op = ck.riccati_sweep_op
    elif which == "rk4_substeps":
        x, u = ck.rk4_inputs(8, 1, device=dev)
        args, op = (x, u, ck.CUDA_ODES["four_tank"][0], 0.3, 10), \
            ck.rk4_substeps_op
    else:
        args = gp_cuda.predict_inputs(100, 6, 13, 4, 2, device=dev)
        op = gp_cuda.gp_predict_batch_op
    torch.library.opcheck(op, args)


def test_cpu_built_artifact_moved_to_the_card_launches_k1(dev):
    """An f32 fused_kkt solve step exported on the CPU for "cuda" runs on
    the card through gpmpc::riccati_sweep: 4 K1 launches a step (al2 x
    mi2), u0 within 1e-3 (relative) of the live step on the card."""
    from benchmarks.bench_spec import DT, MODEL_R, Q_W, R_W, ULB, UUB, \
        X0, XLB, XSP, XUB
    from gpmpc_tpu_torch import MPC, Model
    from gpmpc_tpu_torch.models.convert import gp_from_fixture
    from gpmpc_tpu_torch.utils import export as ex

    def build(device):
        m = Model(Nx=4, Nu=2, ode=four_tank_ode, dt=DT, R=MODEL_R,
                  clip_negative=True, dtype=torch.float32,
                  integrator_substeps=10, device=device)
        g = gp_from_fixture(n=30, dtype=torch.float32, device=device,
                            optimizer_opts=dict(jitter=1e-5, min_noise=1e-4))
        return MPC(horizon=5 * DT, model=m, gp=g, Q=Q_W, R=R_W, ulb=ULB,
                   uub=UUB, xlb=XLB, xub=XUB, percentile=0.95,
                   feedback=True, cov_updates=1, op_x=XSP,
                   op_u=np.array([3.0, 3.0]), device=device,
                   solver_opts=dict(al_iters=2, max_iters=2, ls_steps=8,
                                    penalty_init=1e3, fused_kkt=True))

    step = ex.load_solve_step(ex.export_solve_step(build("cpu"),
                                                   device="cuda"))
    mpc = build(dev)
    args = ex._example_args(mpc, X0, XSP)
    ck.reset_launches()
    u0, warm, _ = step(*args)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["riccati_sweep"] == 4
    u0_l = torch.clamp(mpc._solve_step(*args)[1], mpc.consts.ulb,
                       mpc.consts.uub)
    torch.testing.assert_close(u0, u0_l, rtol=1e-3, atol=1e-3)
    assert warm.x.device.type == "cuda"
