"""Deployment artifacts for the controller (the serving path).

Counterpart of ``gpmpc_tpu/utils/export.py``.  The whole RTI solve step
(the covariance refresh, the AL-SQP with its KKT sweeps, the GP posterior)
is traced once into one graph of ATen operations, serialized with
``torch.export``, and run later, in another process, without the
controller object, its construction code or a retrace: build offline,
ship bytes, serve.

The artifact closes over nothing: every tensor (warm start, setpoint
window, GP posterior, weights) rides the argument list, exactly as in the
live ``MPC._solve_step``.

``torch.export`` cannot trace the ``torch.func`` transforms the NLP is
built from (``jacfwd``, ``hessian``, ``vmap``; torch 2.13), so the step is
traced in two stages:

1. ``make_fx`` in real mode under ``enable_grad`` over the step's pytree
   leaves runs the step once on example inputs and records every ATen
   operation the transforms dispatch.  While it records, the kernel
   wrappers take their custom operators on either device
   (``ops/cuda_kernels.tracing``), so K1 stays one
   ``gpmpc::riccati_sweep`` node (K2 and K3 likewise where a step runs
   them), and the AL-SQP runs its masked budget: nothing in the graph
   depends on the example inputs' values.
2. Dead-code elimination drops what the step does not return (its other
   diagnostics) and the forward-mode zero tangents that ``jacfwd``
   records as ZeroTensor constants copied to the meta device, which
   ``torch.export.save`` cannot serialize; the ZeroTensor factory calls
   left become plain zeros.  Then ``torch.export.export``
   of that graph and ``torch.export.save`` into bytes, with the in/out
   tree structures as extra files.

Usage::

    blob = export_solve_step(mpc)            # bytes
    step = load_solve_step(blob)             # callable
    u0, warm, obj = step(warm, x0, x_sp, u_prev, sigma0, con_par, consts)
    # feed `warm` back into the next call (RTI warm start); the predicted
    # state trajectory is warm.x

``warm``/``consts`` for the first call come from the live MPC
(``mpc._init_warm(...)``, ``mpc.consts``, or :func:`_example_args`) or
from any persisted copies of those tensors.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import os
import time
import typing

import torch
import torch.utils._pytree as pytree
from torch._guards import TracingContext, tracing
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.export.passes import move_to_device_pass
from torch.fx.experimental.proxy_tensor import make_fx

from gpmpc_tpu_torch.models.gp_core import (ExplicitInversePosterior,
                                            GPHypers, GPPosterior,
                                            SparsePosterior)
from gpmpc_tpu_torch.models.propagate import Normalization
from gpmpc_tpu_torch.mpc.controller import MPCConsts, StepInfo
from gpmpc_tpu_torch.ops import cuda_kernels, gp_cuda  # noqa: F401 (ops)
from gpmpc_tpu_torch.solvers.al_sqp import SolverState, SolveResult

#: what the last :func:`export_solve_step` did: seconds of the trace, of
#: ``torch.export.export`` and of ``torch.export.save``, the exported
#: graph's node count and its call counts by operator, and the bytes
EXPORT_INFO = {}


def _register_pytrees():
    """The tree structures ride the artifact; the NamedTuple containers
    need stable serialized names to be written and read back."""
    for cls in (MPCConsts, StepInfo, GPHypers, GPPosterior,
                ExplicitInversePosterior, SparsePosterior, Normalization,
                SolverState, SolveResult):
        if cls not in pytree.SUPPORTED_NODES:
            pytree._register_namedtuple(
                cls, serialized_type_name=f"gpmpc_tpu_torch.{cls.__name__}")


_register_pytrees()


def _example_args(mpc, x0=None, x_sp=None):
    """The step's arguments at ``x0`` and ``x_sp`` (zeros when None): the
    cold warm start rolled out from x0, zero last input, covariance and
    constraint parameters, and the MPC's constants."""
    kw = dict(dtype=mpc.dtype, device=mpc.device)
    x0 = torch.zeros(mpc.Nx, **kw) if x0 is None else mpc._tensor(x0)
    x_sp = mpc._ref_window(torch.zeros(mpc.Nx, **kw) if x_sp is None
                           else x_sp)
    u_prev = torch.zeros(mpc.Nu, **kw)
    sigma0 = torch.zeros((mpc.Nx, mpc.Nx), **kw)
    con_par = torch.zeros(mpc.num_con_par, **kw)
    warm = mpc._init_warm(mpc._augment_x0(x0, u_prev), x_sp)
    return warm, x0, x_sp, u_prev, sigma0, con_par, mpc.consts


def op_counts(graph) -> collections.Counter:
    """Calls by operator name in an FX graph, e.g.
    ``op_counts(g)["gpmpc::riccati_sweep"]``; a call of a plain
    Python function (a kernel launched outside its operator) counts under
    its own name."""
    return collections.Counter(
        (t.name() if isinstance(t, torch._ops.OpOverload)
         else getattr(t, "__name__", str(t)))
        for t in (n.target for n in graph.nodes
                  if n.op == "call_function"))


def refuse_traced_k2(graph) -> None:
    """Raise ``ValueError`` where ``graph`` calls ``gpmpc::rk4_substeps`` on
    a traced functor: its ode_id names a functor traced and built in this
    process, which a loading process would not have (ROADMAP §2 item 2).
    A hand-written functor's ode_id is the same in every process."""
    for n in graph.nodes:
        if (n.op == "call_function"
                and n.target is torch.ops.gpmpc.rk4_substeps.default
                and cuda_kernels.is_traced_ode_id(n.args[2])):
            raise ValueError(
                f"export_solve_step: {cuda_kernels.TRACED_EXPORT_LIMIT}")


def _prune(gm) -> None:
    """Drop the nodes the outputs do not read, then the tensor constants
    no node reads any more (the ZeroTensor tangents, which
    ``torch.export.save`` cannot write).  The ZeroTensor tangents made by
    factory calls become plain zeros of the same size, dtype and device:
    the same values, and a device move (torch 2.11's
    ``move_to_device_pass``) cannot copy a ZeroTensor."""
    gm.graph.eliminate_dead_code()
    read = {n.target for n in gm.graph.nodes if n.op == "get_attr"}
    for name in [k for k, _ in gm.named_buffers() if k not in read]:
        delattr(gm, name)
    for n in gm.graph.nodes:
        if n.target is torch.ops.aten._efficientzerotensor.default:
            n.target = torch.ops.aten.zeros.default
    gm.recompile()


@contextlib.contextmanager
def _no_stack_traces():
    """Trace without a Python stack trace per recorded node (a third of a
    trace's time at ~15000 nodes in torch 2.13), where torch has the
    switch (torch 2.11 has none)."""
    cfg = torch.fx.config
    if not hasattr(cfg, "do_not_emit_stack_traces"):
        yield
        return
    old = cfg.do_not_emit_stack_traces
    cfg.do_not_emit_stack_traces = True
    try:
        yield
    finally:
        cfg.do_not_emit_stack_traces = old


def export_solve_step(mpc, path: str | None = None, device=None) -> bytes:
    """Serialize one full MPC solve step (covariance refresh + AL-SQP) as
    a ``torch.export`` artifact.  Returns the bytes; writes them to
    ``path`` if given.  The exported signature is ``(warm, x0, x_sp,
    u_prev, sigma0, con_par, consts) -> (u0, warm_next, obj)`` with the
    live MPC's tree structures, u0 clamped to the input box.
    ``warm_next`` is the solver state (shifted trajectory + AL
    multipliers): a deployed receding loop must feed it back as the next
    call's ``warm``, as the RTI budgets assume.

    The step is traced on the MPC's own device at :func:`_example_args`;
    the graph does not depend on their values.
    ``device`` (the port's form of the JAX export's ``platforms``) is
    where the artifact runs, by default the MPC's: a CPU-built artifact
    for ``"cuda"`` is moved there by ``move_to_device_pass`` and still
    runs K1 through ``gpmpc::riccati_sweep``.

    Raises ``ValueError`` for a step that reads a value on the host
    (``discrete_method="exact"`` with ``integrator="adaptive"``: its
    stop test; ROADMAP §1), which a trace would freeze at the example's
    value, and for a graph that would carry a traced ODE's K2
    (:func:`refuse_traced_k2`)."""
    if mpc.discrete_method == "exact" and mpc.model.integrator == "adaptive":
        raise ValueError(
            "export_solve_step: discrete_method='exact' with "
            "integrator='adaptive' reads the integrator's stop test on the "
            "host inside the step; a trace would freeze it at the example "
            "inputs' step count (ROADMAP §1, adaptive integrator under a "
            "transform)")
    leaves, in_spec = pytree.tree_flatten(_example_args(mpc))
    out_specs = []

    def flat_step(*flat):
        warm, x0, x_sp, u_prev, sigma0, con_par, consts = \
            pytree.tree_unflatten(list(flat), in_spec)
        state, u0, _sigmas, info = mpc._solve_step(
            warm, x0, x_sp, u_prev, sigma0, con_par, consts)
        u0 = torch.clamp(u0, consts.ulb, consts.uub)
        out, spec = pytree.tree_flatten((u0, state, info.obj))
        out_specs.append(spec)
        return out

    t0 = time.perf_counter()
    # in real mode make_fx builds a fake mode for each node's metadata
    # (each reading the Python stack) unless a tracing context offers one:
    # one shared mode halves the trace
    with _no_stack_traces(), torch.enable_grad(), tracing(TracingContext(
            FakeTensorMode(allow_fallback_kernels=True))):
        gm = make_fx(flat_step, tracing_mode="real")(*leaves)
    refuse_traced_k2(gm.graph)
    _prune(gm)
    t1 = time.perf_counter()
    with _no_stack_traces():
        program = torch.export.export(gm, tuple(leaves), strict=False)
    target = torch.device(device) if device is not None else mpc.device
    if target != mpc.device:
        program = move_to_device_pass(program, str(target))
    t2 = time.perf_counter()
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={
        "in_spec": pytree.treespec_dumps(in_spec),
        "out_spec": pytree.treespec_dumps(out_specs[0]),
        "none_leaves": json.dumps(_none_leaves(leaves))})
    blob = buf.getvalue()
    EXPORT_INFO.clear()
    EXPORT_INFO.update(trace_s=t1 - t0, export_s=t2 - t1,
                       save_s=time.perf_counter() - t2,
                       nodes=len(program.graph.nodes),
                       ops=op_counts(program.graph), bytes=len(blob))
    if path is not None:
        with open(path, "wb") as fh:
            fh.write(blob)
    return blob


def _none_leaves(leaves):
    """Where the leaves are None (an option the MPC does not use, such as
    ``consts.s``): the pytree counts None as a leaf, and the artifact has
    no input there."""
    return [i for i, leaf in enumerate(leaves) if leaf is None]


@contextlib.contextmanager
def _cached_type_hints():
    """``torch.export.load`` resolves its schema classes' type hints once
    per serialized value (torch 2.13: half of a load's time at ~9000
    nodes); they cannot change during a load, so they are cached for its
    duration."""
    get = typing.get_type_hints
    cache = {}

    def cached(obj, globalns=None, localns=None, include_extras=False):
        key = (obj, include_extras)
        if key not in cache:
            cache[key] = get(obj, globalns, localns, include_extras)
        return cache[key]

    typing.get_type_hints = cached
    try:
        yield
    finally:
        typing.get_type_hints = get


class SolveStep:
    """A loaded solve step: ``step(warm, x0, x_sp, u_prev, sigma0,
    con_par, consts) -> (u0, warm_next, obj)`` with the live MPC's tree
    structures.  ``module`` is the graph it runs (its calls by operator:
    ``op_counts(step.module.graph)``)."""

    def __init__(self, program, in_spec, out_spec, none_leaves):
        self.module = program.module()
        self.in_spec, self.out_spec = in_spec, out_spec
        self.none_leaves = none_leaves

    def __call__(self, *args):
        leaves, spec = pytree.tree_flatten(args)
        if spec != self.in_spec or _none_leaves(leaves) != self.none_leaves:
            raise ValueError(f"the arguments' structure is not the exported "
                             f"step's:\n{spec}\nexpected\n{self.in_spec}")
        return pytree.tree_unflatten(list(self.module(*leaves)),
                                     self.out_spec)


def load_solve_step(blob_or_path) -> SolveStep:
    """Rehydrate an exported solve step into a callable.  Accepts the bytes
    returned by :func:`export_solve_step`, or a filesystem path (str or
    os.PathLike).  The serving process needs torch and the port's
    operator registrations (importing ``gpmpc_tpu_torch``, as this module
    does, registers them); it needs no ``MPC``, ``GP`` or construction
    code."""
    if isinstance(blob_or_path, (str, os.PathLike)):
        with open(blob_or_path, "rb") as fh:
            blob = fh.read()
    else:
        blob = blob_or_path
    extra = {"in_spec": "", "out_spec": "", "none_leaves": ""}
    with _cached_type_hints():
        program = torch.export.load(io.BytesIO(blob), extra_files=extra)
    return SolveStep(program, pytree.treespec_loads(extra["in_spec"]),
                     pytree.treespec_loads(extra["out_spec"]),
                     json.loads(extra["none_leaves"]))
