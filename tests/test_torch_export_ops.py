"""The kernels' custom operators under a trace, on the CPU: their fake
implementations (``torch.library.opcheck``), the wrappers taking them while
``make_fx`` records, a launch outside its operator refused, and the f32
``fused_kkt`` solve step exported with K1 as four ``gpmpc::riccati_sweep``
nodes (the main path's form; on the CPU each node's body is the plain
version), against the live f32 step.  Moving a CPU-built artifact to the
card (``move_to_device_pass``) needs a CUDA build of torch: the card test
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 18 run it."""

import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from benchmarks.bench_spec import X0, XSP
from gpmpc_tpu_torch.ops import cuda_kernels as ck
from gpmpc_tpu_torch.ops import gp_cuda as gc
from gpmpc_tpu_torch.systems import four_tank_ode
from gpmpc_tpu_torch.utils import export as ex

from test_torch_mpc import _port_side


def _k1_args(batch=None):
    return (*ck.stage_qp_inputs(5, 4, 2, 0, batch=batch),
            torch.full(() if batch is None else (batch,), 1e-6))


def _k2_args():
    x, u = ck.rk4_inputs(8, 1)
    return x, u, ck.CUDA_ODES["four_tank"][0], 0.3, 10


def _k3_args():
    return gc.predict_inputs(30, 6, 7, 4, 2)


@pytest.mark.parametrize("which", ["riccati_sweep", "rk4_substeps",
                                   "gp_predict_batch"])
def test_opcheck_on_cpu_inputs(which):
    """Schema, fake implementation (the outputs' shapes and dtypes against
    the CPU body's) and AOT dispatch of each operator on CPU tensors."""
    op, args = {"riccati_sweep": (ck.riccati_sweep_op, _k1_args()),
                "rk4_substeps": (ck.rk4_substeps_op, _k2_args()),
                "gp_predict_batch": (gc.gp_predict_batch_op,
                                     _k3_args())}[which]
    torch.library.opcheck(op, args)
    if which == "riccati_sweep":
        torch.library.opcheck(op, _k1_args(batch=3))


def test_wrappers_take_their_operators_under_a_trace():
    """While make_fx records, each wrapper on CPU tensors is one operator
    node whose value is the plain version's; outside a trace the wrappers
    run the plain versions (no node to record)."""
    k1, (x, u, _, h, n_sub), k3 = _k1_args(), _k2_args(), _k3_args()

    def f(k1, x, u, k3):
        return (ck.riccati_sweep(*k1), ck.rk4_substeps(four_tank_ode, x, u,
                                                       h, n_sub),
                gc.gp_predict_batch(*k3))

    gm = make_fx(f, tracing_mode="real")(k1, x, u, k3)
    ops = ex.op_counts(gm.graph)
    assert ops["gpmpc::riccati_sweep"] == ops["gpmpc::rk4_substeps"] == \
        ops["gpmpc::gp_predict_batch"] == 1
    assert not ck.tracing()
    got, want = gm(k1, x, u, k3), f(k1, x, u, k3)
    ref = (ck.riccati_sweep_reference(*k1),
           ck.rk4_substeps_reference(four_tank_ode, x, u, h, n_sub),
           gc.gp_predict_batch_reference(*k3))
    for g, w, r in zip(torch.utils._pytree.tree_leaves(got),
                       torch.utils._pytree.tree_leaves(want),
                       torch.utils._pytree.tree_leaves(ref)):
        assert torch.equal(g, w) and torch.equal(w, r)


def test_launch_outside_its_operator_under_a_trace_raises():
    """A kernel launch called directly while a trace records would leave
    the graph its empty outputs: it raises before reaching the card."""
    k1 = _k1_args()
    with pytest.raises(RuntimeError, match="outside its custom operator"):
        make_fx(lambda *a: ck._riccati_sweep_launch(*a),
                tracing_mode="real")(*k1)


def test_f32_fused_artifact_holds_k1_and_matches_live():
    """The main path's form at Nt=3: f32, fused_kkt, al2 x mi2.  The
    artifact holds exactly 4 gpmpc::riccati_sweep nodes and no call of a
    Python function, and equals the live f32 step bit for bit on inputs
    other than the traced ones."""
    mpc = _port_side(torch.float32, "TA", "gp", True, nt=3,
                     solver_opts=dict(al_iters=2, max_iters=2, ls_steps=8,
                                      penalty_init=1e3, fused_kkt=True))
    blob = ex.export_solve_step(mpc)
    ops = ex.EXPORT_INFO["ops"]
    assert ops["gpmpc::riccati_sweep"] == 4
    assert all(k.startswith(("aten::", "gpmpc::")) or k == "getitem"
               for k in ops)
    step = ex.load_solve_step(blob)
    assert ex.op_counts(step.module.graph)["gpmpc::riccati_sweep"] == 4
    args = ex._example_args(mpc, X0 - 1.0, XSP)
    u0, warm, obj = step(*args)
    state, u0_l, _, info = mpc._solve_step(*args)
    assert u0.dtype == torch.float32
    assert torch.equal(u0, torch.clamp(u0_l, mpc.consts.ulb,
                                       mpc.consts.uub))
    assert torch.equal(warm.x, state.x) and torch.equal(obj, info.obj)
    assert np.isfinite(warm.x.numpy()).all()
