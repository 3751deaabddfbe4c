"""The CUDA kernels on the card against their plain PyTorch versions.

A CUDA kernel has no interpret mode, so every test here needs an NVIDIA GPU
(marker ``cuda``) and skips without one.  On the card:
``python -m pytest tests/test_torch_cuda.py -q``.
"""

import numpy as np
import pytest
import torch

from gpmpc_tpu_torch.ops import cuda_kernels as ck
from gpmpc_tpu_torch.systems import four_tank_ode

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("nt,nx,nu,batch", [(20, 4, 2, None), (13, 5, 3, None),
                                            (8, 2, 1, None), (20, 4, 2, 8)])
def test_riccati_kernel_matches_plain_version(dev, nt, nx, nu, batch):
    args = ck.stage_qp_inputs(nt, nx, nu, nt + nx, batch, device=dev)
    reg = torch.full(() if batch is None else (batch,), 1e-6, device=dev)
    before = ck.LAUNCHES["riccati_sweep"]
    ck.check_riccati_sweep(args, reg)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["riccati_sweep"] == before + 1


def test_riccati_kernel_indefinite_gives_nan(dev):
    args = ck.stage_qp_inputs(8, 2, 1, 2, device=dev)
    args[4] = -args[4]
    got = ck.riccati_sweep(*args, torch.zeros((), device=dev))
    assert not bool(torch.all(torch.isfinite(got[2])))


@pytest.mark.parametrize("batch", [None, 8])
def test_rk4_kernel_matches_plain_version(dev, batch):
    rng = np.random.default_rng(0)
    lead = () if batch is None else (batch,)
    x = torch.tensor(np.abs(rng.standard_normal(lead + (4,))) * 4 + 0.5,
                     dtype=torch.float32, device=dev)
    u = torch.tensor(np.abs(rng.standard_normal(lead + (2,))) * 3,
                     dtype=torch.float32, device=dev)
    before = ck.LAUNCHES["rk4_substeps"]
    ck.check_rk4_substeps(four_tank_ode, x, u, 0.3, 10)
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
    assert ck.LAUNCHES == {"riccati_sweep": 3 * 4, "rk4_substeps": 3}
    assert xs.device.type == "cuda" and bool(torch.all(torch.isfinite(xs)))
