"""A plant ODE traced into the RK4 kernel (K2) of ``csrc/rk4_substeps.cu``.

Counterpart of the body tracing in
``gpmpc_tpu/ops/pallas_kernels.py:rk4_substeps_pallas``, where the user's
pure-jnp ODE is traced into the Pallas kernel's body.  Here:

1. :func:`trace_ode` records the ODE once, on one point (x ``(nx,)``, u
   ``(nu,)``, f32), as a graph of ATen operations (``make_fx`` in fake
   mode, functionalized, so that an ODE may also write its result in
   place).  A closure's tensors become graph constants whose values are
   read once, here, as JAX's ``jit`` captures closure constants.
2. :func:`lower` scalarizes the graph: every value has a small static
   shape, so each element becomes one named ``float`` and every op one
   scalar operation per output element (shape ops only move names).
3. :func:`emit` writes the scalar program as a C++ functor with the
   ``NX``/``NU``/``NW``/``prep``/``eval`` shape of the hand-written
   ``FourTank`` and ``Car``: ``prep`` computes once a rollout what
   depends on the input alone, ``eval`` the rest.  Its name carries a
   hash of its text, so equal programs share one build.

``ops/cuda_kernels.py`` builds the functor with ``nvcc`` at its first
launch into a K2 library of its own (``csrc/rk4_substeps.cu`` included
with ``GPMPC_RK4_TRACED`` naming it), compiled with ``--fmad=false`` so
that each ATen op rounds once, as PyTorch's elementwise kernels do.  The
functor takes the accurate ``sqrtf``, ``sinf``, ``expf``, ... (no ``__``
intrinsics, no fast math); a Python scalar enters as ``static_cast<float>``
of its 17-digit double (PyTorch's f32 ops take it as their opmath float);
``pow`` copies the exponents PyTorch special-cases (0, 1, 2, 3, 0.5, -0.5,
-1, -2).  :func:`run_lowered` runs the scalar program with PyTorch's own
ops on 0-d tensors, the check that the scalarization is the ODE.

Any op outside the lowering raises ``ValueError`` naming the ATen op and
the ODE; so does a branch on the data, an output that is not ``(nx,)`` or
a value that is not f32 (bool is taken from comparisons and casts,
``x.bool()`` as ``x != 0``; arithmetic that PyTorch keeps in bool raises).
There is no fallback.
"""

from __future__ import annotations

import functools
import hashlib
import operator
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
from torch.fx.experimental.proxy_tensor import make_fx


def ode_name(ode) -> str:
    """A readable name of ``ode`` for messages: module, qualified name and
    source line of a function, the function of a ``functools.partial``."""
    if isinstance(ode, functools.partial):
        return f"functools.partial({ode_name(ode.func)}, ...)"
    code = getattr(ode, "__code__", None)
    qual = getattr(ode, "__qualname__", None)
    if qual is None:
        return repr(ode)
    where = (f" ({code.co_filename}:{code.co_firstlineno})" if code
             else "")
    return f"{getattr(ode, '__module__', '?')}.{qual}{where}"


# ------------------------------------------------------------------ trace

def trace_ode(ode: Callable, nx: int, nu: int, device=None):
    """The ATen graph (a ``torch.fx.GraphModule``) of ``ode(x, u)`` on one
    point, x ``(nx,)`` and u ``(nu,)`` f32 on ``device`` (a CUDA device in
    a build without CUDA traces on the CPU: the graph is the same).  Raises
    ``ValueError`` naming the ODE when it branches on the data, when its
    output is not f32 of shape ``(nx,)`` or when a value is not f32."""
    name = ode_name(ode)
    dev = torch.device(device if device is not None else "cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        dev = torch.device("cpu")
    kw = dict(dtype=torch.float32, device=dev)

    def two(x, u):                # partials and defaults become a closure
        return ode(x, u)

    from torch.fx.experimental.symbolic_shapes import (
        GuardOnDataDependentSymNode)
    from torch._subclasses.fake_tensor import (DataDependentOutputException,
                                               DynamicOutputShapeException)
    try:
        # functionalized: writes through views and in-place ops (dx[0] =
        # ..., y.mul_(2)) become select_scatter, slice_scatter and copy
        gm = make_fx(torch.func.functionalize(two), tracing_mode="fake",
                     _allow_non_fake_inputs=True)(
            torch.zeros(nx, **kw), torch.zeros(nu, **kw))
    except (GuardOnDataDependentSymNode, DataDependentOutputException,
            DynamicOutputShapeException) as e:
        raise ValueError(
            f"trace_ode: the ODE {name} branches on (or reads on the host) "
            f"the value of its state or input, which a kernel traced once "
            f"cannot follow; write the branch with torch.where: "
            f"{type(e).__name__}: {str(e).splitlines()[0]}") from e
    except Exception as e:
        raise ValueError(f"trace_ode: cannot trace the ODE {name} on one "
                         f"point (x ({nx},), u ({nu},), f32): "
                         f"{type(e).__name__}: {e}") from e
    for node in gm.graph.nodes:
        for v in _vals(node.meta.get("val")):
            if isinstance(v, torch.Tensor) and v.dtype not in (
                    torch.float32, torch.bool):
                raise ValueError(
                    f"trace_ode: the ODE {name} makes a value of dtype "
                    f"{v.dtype} ({node.format_node()}); the kernel computes "
                    f"in f32")
    out = next(n for n in gm.graph.nodes if n.op == "output").args[0]
    val = out.meta.get("val") if isinstance(out, torch.fx.Node) else None
    if (not isinstance(val, torch.Tensor) or tuple(val.shape) != (nx,)
            or val.dtype != torch.float32):
        got = (f"{tuple(val.shape)} {val.dtype}"
               if isinstance(val, torch.Tensor) else type(out).__name__)
        raise ValueError(f"trace_ode: the ODE {name} returns {got}, "
                         f"expected a float32 tensor of shape ({nx},)")
    gm.ode_name = name
    gm.nx, gm.nu = nx, nu
    return gm


def _vals(v):
    return v if isinstance(v, (list, tuple)) else [v]


# ------------------------------------------------------------------ lower

class Ref:
    """One scalar of the lowered program: ``x[i]``, ``u[i]``, temporary
    ``t[i]`` or a constant (``kind`` "x", "u", "t", "k"; a constant's
    ``val`` is the double whose f32 rounding it stands for, or a bool)."""
    __slots__ = ("kind", "val")

    def __init__(self, kind, val):
        self.kind, self.val = kind, val

    def __eq__(self, other):
        return (isinstance(other, Ref) and self.kind == other.kind
                and repr(self.val) == repr(other.val))

    def __hash__(self):
        return hash((self.kind, repr(self.val)))

    def __repr__(self):
        return f"{self.kind}[{self.val!r}]"


@dataclass(frozen=True)
class Instr:
    """``kind(args; params)``: one scalar operation (bool when ``boolean``)."""
    kind: str
    args: tuple
    params: tuple = ()
    boolean: bool = False


@dataclass(frozen=True)
class Lowered:
    """The scalar program of an ODE: temporaries ``t[i] = instrs[i]`` in
    order, and the ``nx`` outputs."""
    nx: int
    nu: int
    instrs: tuple
    out: tuple
    name: str = ""


#: unary f32 ops: ATen name -> kind (the C++ and the mirror by kind below)
_UNARY = {f"aten.{k}.default": k for k in (
    "neg", "abs", "sign", "sqrt", "rsqrt", "reciprocal", "exp", "expm1",
    "log", "log1p", "sin", "cos", "tan", "asin", "acos", "atan", "sinh",
    "cosh", "tanh", "sigmoid")}
_BINARY = {"aten.mul.Tensor": "mul", "aten.mul.Scalar": "mul",
           "aten.div.Tensor": "div", "aten.div.Scalar": "div",
           "aten.maximum.default": "maximum",
           "aten.minimum.default": "minimum",
           "aten.atan2.default": "atan2", "aten.pow.Tensor_Tensor": "powf"}
_COMPARE = {f"aten.{k}.{o}": k for k in ("gt", "ge", "lt", "le", "eq", "ne")
            for o in ("Tensor", "Scalar")}
#: logical ops, and the bitwise ones on bool (``&``, ``|``, ``^``)
_LOGICAL = {"aten.logical_and.default": "logical_and",
            "aten.logical_or.default": "logical_or",
            "aten.logical_xor.default": "logical_xor",
            "aten.bitwise_and.Tensor": "logical_and",
            "aten.bitwise_or.Tensor": "logical_or",
            "aten.bitwise_xor.Tensor": "logical_xor"}
_IDENTITY = {"aten.clone.default", "aten.alias.default",
             "aten.detach.default", "aten.lift_fresh_copy.default",
             "aten.contiguous.default"}
#: ops whose result is a number: on bool values (where PyTorch's ``+``,
#: ``*`` or ``max`` stay bool) they raise rather than compute in f32
_ARITH = {"aten.add.Tensor", "aten.add.Scalar", "aten.sub.Tensor",
          "aten.sub.Scalar", "aten.rsub.Tensor", "aten.rsub.Scalar",
          "aten.clamp.default", "aten.clamp_min.default",
          "aten.clamp_max.default", "aten.pow.Tensor_Scalar",
          "aten.pow.Scalar", "aten.sum.default", "aten.sum.dim_IntList",
          "aten.mean.default", "aten.mean.dim", "aten.prod.default",
          "aten.prod.dim_int", "aten.amax.default", "aten.amin.default",
          "aten.max.default", "aten.min.default", "aten.dot.default",
          "aten.mv.default", "aten.mm.default", "aten.addmv.default",
          "aten.addmm.default"}
#: C-order reshapes: the result takes the node's own shape
_RESHAPE = {"aten.view.default", "aten._unsafe_view.default",
            "aten.reshape.default", "aten.unsqueeze.default",
            "aten.squeeze.dim", "aten.squeeze.dims", "aten.squeeze.default",
            "aten.squeeze_.dim", "aten.squeeze_.dims",
            "aten.squeeze_.default", "aten.unsqueeze_.default"}


def _obj(ref) -> np.ndarray:
    a = np.empty((), dtype=object)
    a[()] = ref
    return a


def _arr(v) -> np.ndarray:
    """A value as an object array of refs (a Python scalar as a 0-d
    constant)."""
    if isinstance(v, np.ndarray):
        return v
    if isinstance(v, Ref):
        return _obj(v)
    if isinstance(v, (bool, np.bool_)):
        return _obj(Ref("k", bool(v)))
    if isinstance(v, (int, float, np.integer, np.floating)):
        return _obj(Ref("k", float(v)))
    raise TypeError(f"not a value: {v!r}")


class _Lowering:
    def __init__(self, name):
        self.name = name
        self.instrs = []

    def unsupported(self, node, why=""):
        raise ValueError(
            f"lower: the ODE {self.name} uses {node.target}"
            f"{' ' + why if why else ''} ({node.format_node()}), which the "
            f"K2 lowering does not cover")

    def is_bool(self, ref):
        return ((ref.kind == "k" and isinstance(ref.val, bool))
                or (ref.kind == "t" and self.instrs[ref.val].boolean))

    def op(self, kind, args, params=(), boolean=False):
        if not boolean and kind not in ("where", "float"):
            args = [self.op("float", [a]) if self.is_bool(a) else a
                    for a in args]
        self.instrs.append(Instr(kind, tuple(args), tuple(params), boolean))
        return Ref("t", len(self.instrs) - 1)

    def ew(self, kind, vals, params=(), boolean=False):
        """Elementwise ``kind`` over the broadcast of ``vals``."""
        arrs = np.broadcast_arrays(*[_arr(v) for v in vals])
        out = np.empty(arrs[0].shape, dtype=object)
        for idx in np.ndindex(out.shape):
            out[idx] = self.op(kind, [a[idx] for a in arrs], params, boolean)
        return out

    def fold(self, kind, refs):
        acc = refs[0]
        for r in refs[1:]:
            acc = self.op(kind, [acc, r])
        return acc

    def reduce(self, kind, x, dims, empty):
        x = _arr(x)
        dims = list(range(x.ndim)) if not dims else \
            [d % x.ndim for d in dims]
        keep = [d for d in range(x.ndim) if d not in dims]
        flat = np.transpose(x, keep + dims).reshape(
            [x.shape[d] for d in keep] + [-1])
        out = np.empty(flat.shape[:-1], dtype=object)
        for idx in np.ndindex(out.shape):
            row = list(flat[idx])
            out[idx] = self.fold(kind, row) if row else Ref("k", empty)
        return out

    def products(self, a, b):
        """``a @ b`` for 2-d ``a`` and 1-d or 2-d ``b``: each entry the
        products summed in order."""
        a, b = _arr(a), _arr(b)
        vec = b.ndim == 1
        b2 = b[:, None] if vec else b
        out = np.empty((a.shape[0], b2.shape[1]), dtype=object)
        for i, j in np.ndindex(out.shape):
            out[i, j] = self.fold("add", [self.op("mul", [a[i, k], b2[k, j]])
                                          for k in range(a.shape[1])])
        return out[:, 0] if vec else out

    def const(self, t, node):
        if not isinstance(t, torch.Tensor):
            self.unsupported(node, "(a constant that is not a tensor)")
        if t.dtype not in (torch.float32, torch.bool):
            raise ValueError(f"lower: the ODE {self.name} closes over a "
                             f"tensor of dtype {t.dtype} ({node.target}); the "
                             f"kernel computes in f32")
        vals = t.detach().cpu().numpy()
        out = np.empty(vals.shape, dtype=object)
        for idx in np.ndindex(vals.shape):
            v = vals[idx]
            out[idx] = Ref("k", bool(v) if t.dtype == torch.bool
                           else float(v))
        return out


def _shape(node):
    return tuple(node.meta["val"].shape)


def lower(gm) -> Lowered:
    """The scalar program of a graph from :func:`trace_ode`.  Raises
    ``ValueError`` naming the ATen op and the ODE for an op outside the
    lowering."""
    name = getattr(gm, "ode_name", "?")
    lw = _Lowering(name)
    env = {}
    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    for ph, kind, n in ((placeholders[0], "x", gm.nx),
                        (placeholders[1], "u", gm.nu)):
        env[ph] = np.empty(n, dtype=object)
        env[ph][:] = [Ref(kind, i) for i in range(n)]

    def sub(a):
        if isinstance(a, torch.fx.Node):
            return env[a]
        if isinstance(a, (list, tuple)):
            return [sub(b) for b in a]
        if isinstance(a, dict):
            return {k: sub(v) for k, v in a.items()}
        return a

    for node in gm.graph.nodes:
        if node.op == "placeholder":
            continue
        if node.op == "get_attr":
            env[node] = lw.const(getattr(gm, node.target), node)
            continue
        if node.op == "output":
            out = _arr(env[node.args[0]])
            break
        if node.op != "call_function":
            lw.unsupported(node)
        if node.target is operator.getitem:
            env[node] = env[node.args[0]][node.args[1]]
            continue
        target = str(node.target)
        args, kw = sub(node.args), sub(node.kwargs)
        env[node] = _lower_op(lw, node, target, args, kw)
        if target.split(".")[1].endswith("_"):
            # squeeze_ and the like change their input's shape in place
            # (functionalization keeps them)
            env[node.args[0]] = env[node]
        if isinstance(env[node], np.ndarray) and \
                env[node].shape != _shape(node):
            raise AssertionError(f"lower: {node.format_node()} gave shape "
                                 f"{env[node].shape}, traced {_shape(node)}")
    return Lowered(gm.nx, gm.nu, tuple(lw.instrs), tuple(out.reshape(-1)),
                   name)


def _lower_op(lw, node, target, args, kw):
    """One ATen op on object arrays of refs."""
    val = node.meta.get("val")
    if (isinstance(val, torch.Tensor) and val.dtype == torch.bool
            and (target in _UNARY or target in _BINARY or target in _ARITH)):
        lw.unsupported(node, "on bool values")
    if target == "aten._to_copy.default":
        return _lower_cast(lw, node, args[0])
    if target in _UNARY:
        return lw.ew(_UNARY[target], [args[0]])
    if target in _BINARY:
        if kw.get("rounding_mode") is not None:
            lw.unsupported(node, "with a rounding mode")
        return lw.ew(_BINARY[target], args[:2])
    if target in ("aten.add.Tensor", "aten.add.Scalar", "aten.sub.Tensor",
                  "aten.sub.Scalar", "aten.rsub.Tensor", "aten.rsub.Scalar"):
        alpha = kw.get("alpha", args[2] if len(args) > 2 else 1)
        a, b = args[:2]
        if target.startswith("aten.rsub"):
            a, b = b, a
        if target.startswith(("aten.sub", "aten.rsub")):
            alpha = -alpha
        if alpha == 1:
            return lw.ew("add", [a, b])
        if alpha == -1:
            return lw.ew("sub", [a, b])
        return lw.ew("add_alpha", [a, b], (float(alpha),))
    if target in _COMPARE:
        return lw.ew(_COMPARE[target], args[:2], boolean=True)
    if target in _LOGICAL:
        return lw.ew(_LOGICAL[target], args[:2], boolean=True)
    if target in ("aten.logical_not.default", "aten.bitwise_not.default"):
        return lw.ew("logical_not", [args[0]], boolean=True)
    if target == "aten.where.self":
        return lw.ew("where", args[:3])
    if target in ("aten.clamp.default", "aten.clamp_min.default",
                  "aten.clamp_max.default"):
        if target == "aten.clamp.default":
            lo = kw.get("min", args[1] if len(args) > 1 else None)
            hi = kw.get("max", args[2] if len(args) > 2 else None)
        elif target == "aten.clamp_min.default":
            lo, hi = args[1], None
        else:
            lo, hi = None, args[1]
        if any(isinstance(v, np.ndarray) for v in (lo, hi)):
            lw.unsupported(node, "with tensor bounds")
        return lw.ew("clamp", [args[0]], (lo, hi))
    if target == "aten.pow.Tensor_Scalar":
        return lw.ew("pow", [args[0]], (args[1],))
    if target == "aten.pow.Scalar":
        return lw.ew("pow_base", [args[1]], (args[0],))
    # shapes
    if target in _IDENTITY:
        return args[0]
    if target in _RESHAPE:
        return _arr(args[0]).reshape(_shape(node))
    if target == "aten.expand.default":
        return np.broadcast_to(_arr(args[0]), _shape(node))
    if target == "aten.select.int":
        x = _arr(args[0])
        return _arr(np.moveaxis(x, args[1], 0)[args[2]])
    if target == "aten.slice.Tensor":
        x = _arr(args[0])
        dim = args[1] if len(args) > 1 else 0
        start = args[2] if len(args) > 2 else None
        end = args[3] if len(args) > 3 else None
        step = args[4] if len(args) > 4 else 1
        idx = [slice(None)] * x.ndim
        idx[dim] = slice(start, end, step)
        return x[tuple(idx)]
    if target in ("aten.permute.default",):
        return np.transpose(_arr(args[0]), args[1])
    if target in ("aten.t.default", "aten.t_.default"):
        return _arr(args[0]).T
    if target in ("aten.transpose.int", "aten.transpose_.default"):
        return np.swapaxes(_arr(args[0]), args[1], args[2])
    if target == "aten.flip.default":
        return np.flip(_arr(args[0]), args[1])
    if target == "aten.cat.default":
        return np.concatenate([_arr(a) for a in args[0]],
                              axis=args[1] if len(args) > 1 else 0)
    if target == "aten.stack.default":
        return np.stack([_arr(a) for a in args[0]],
                        axis=args[1] if len(args) > 1 else 0)
    if target == "aten.unbind.int":
        x = np.moveaxis(_arr(args[0]), args[1] if len(args) > 1 else 0, 0)
        return [_arr(x[i]) for i in range(x.shape[0])]
    if target in ("aten.split.Tensor", "aten.split_with_sizes.default"):
        x = _arr(args[0])
        dim = args[2] if len(args) > 2 else 0
        n = x.shape[dim]
        sizes = (args[1] if target.endswith("sizes.default")
                 else [min(args[1], n - s) for s in range(0, n, args[1])])
        return np.split(x, np.cumsum(sizes)[:-1], axis=dim)
    if target == "aten.copy.default":
        return np.broadcast_to(_arr(args[1]), _shape(node)).copy()
    if target in ("aten.select_scatter.default",
                  "aten.slice_scatter.default"):
        out = _arr(args[0]).copy()
        dim = args[2] if len(args) > 2 else kw.get("dim", 0)
        idx = [slice(None)] * out.ndim
        if target == "aten.select_scatter.default":
            idx[dim] = args[3]
        else:
            idx[dim] = slice(*(list(args[3:6]) + [None] * 3)[:3])
        src = _arr(args[1])
        shape = np.shape(out[tuple(idx)])
        out[tuple(idx)] = (src.reshape(())[()] if shape == ()
                           else np.broadcast_to(src, shape))
        return out
    # constants
    if target in ("aten.full.default", "aten.full_like.default",
                  "aten.new_full.default", "aten.scalar_tensor.default",
                  "aten.zeros.default", "aten.zeros_like.default",
                  "aten.new_zeros.default", "aten.ones.default",
                  "aten.ones_like.default", "aten.new_ones.default"):
        if "zeros" in target:
            v = 0.0
        elif "ones" in target:
            v = 1.0
        elif target == "aten.scalar_tensor.default":
            v = args[0]
        elif target == "aten.full.default":
            v = args[1]
        else:
            v = args[1] if target == "aten.full_like.default" else args[2]
        if node.meta["val"].dtype == torch.bool:
            v = bool(v)
        return np.broadcast_to(_arr(v), _shape(node))
    # reductions and products
    if target in ("aten.sum.default", "aten.sum.dim_IntList",
                  "aten.mean.default", "aten.mean.dim", "aten.prod.default",
                  "aten.prod.dim_int", "aten.amax.default",
                  "aten.amin.default", "aten.max.default",
                  "aten.min.default"):
        if kw.get("dtype") not in (None, torch.float32):
            lw.unsupported(node, f"to dtype {kw['dtype']}")
        x = _arr(args[0])
        dims = args[1] if len(args) > 1 else kw.get("dim")
        if isinstance(dims, int):
            dims = [dims]
        op = target.split(".")[1]
        kind, empty = {"sum": ("add", 0.0), "mean": ("add", 0.0),
                       "prod": ("mul", 1.0), "amax": ("maximum", None),
                       "amin": ("minimum", None), "max": ("maximum", None),
                       "min": ("minimum", None)}[op]
        if x.size == 0 and empty is None:
            lw.unsupported(node, "over no element")
        r = lw.reduce(kind, x, dims, empty)
        if op == "mean":
            r = lw.ew("div", [r, float(x.size // max(1, r.size))])
        return r.reshape(_shape(node))
    if target == "aten.dot.default":
        a, b = _arr(args[0]), _arr(args[1])
        return _obj(lw.fold("add", [lw.op("mul", [a[k], b[k]])
                                    for k in range(a.shape[0])]))
    if target in ("aten.mv.default", "aten.mm.default"):
        return lw.products(args[0], args[1])
    if target in ("aten.addmv.default", "aten.addmm.default"):
        if kw.get("beta", 1) != 1 or kw.get("alpha", 1) != 1:
            lw.unsupported(node, "with beta or alpha other than 1")
        return lw.ew("add", [lw.products(args[1], args[2]), args[0]])
    lw.unsupported(node)


def _lower_cast(lw, node, x):
    """``_to_copy`` within f32 and bool (the tracer lets no other dtype
    through): the identity where the dtype stays, ``x != 0`` to bool, 0 or
    1 from bool to f32."""
    dst = node.meta["val"].dtype
    if dst not in (torch.float32, torch.bool):
        lw.unsupported(node, f"to dtype {dst}")
    x = _arr(x)
    out = np.empty(x.shape, dtype=object)
    for idx in np.ndindex(x.shape):
        r = x[idx]
        if dst == torch.bool and not lw.is_bool(r):
            r = lw.op("ne", [r, Ref("k", 0.0)], boolean=True)
        elif dst == torch.float32 and lw.is_bool(r):
            r = lw.op("float", [r])
        out[idx] = r
    return out


# ------------------------------------------------------------------ emit

def _live(low: Lowered):
    """Indices of the temporaries the outputs need."""
    live, stack = set(), [r.val for r in low.out if r.kind == "t"]
    while stack:
        i = stack.pop()
        if i in live:
            continue
        live.add(i)
        stack += [a.val for a in low.instrs[i].args if a.kind == "t"]
    return sorted(live)


def _on_input_only(low: Lowered, live):
    """The live temporaries that read no state (hoisted into ``prep``)."""
    u_only = set()
    for i in live:
        if all(a.kind in ("u", "k") or (a.kind == "t" and a.val in u_only)
               for a in low.instrs[i].args):
            u_only.add(i)
    return u_only


def _lit(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    v = float(v)
    if v != v:
        return "NAN"
    if v in (float("inf"), float("-inf")):
        return ("-" if v < 0 else "") + "INFINITY"
    s = "%.17g" % v
    if not any(c in s for c in ".en"):
        s += ".0"
    return f"static_cast<float>({s})"


def _pow(a, e) -> str:
    e = float(e)
    special = {0.0: "1.0f", 1.0: a, 2.0: f"{a} * {a}",
               3.0: f"{a} * {a} * {a}", 0.5: f"sqrtf({a})",
               -0.5: f"1.0f / sqrtf({a})", -1.0: f"1.0f / {a}",
               -2.0: f"1.0f / ({a} * {a})"}
    return special.get(e, f"powf({a}, {_lit(e)})")


_C_UNARY = {"sqrt": "sqrtf", "exp": "expf", "expm1": "expm1f", "log": "logf",
            "log1p": "log1pf", "sin": "sinf", "cos": "cosf", "tan": "tanf",
            "asin": "asinf", "acos": "acosf", "atan": "atanf",
            "sinh": "sinhf", "cosh": "coshf", "tanh": "tanhf",
            "abs": "fabsf"}
_C_INFIX = {"add": "+", "sub": "-", "mul": "*", "div": "/", "gt": ">",
            "ge": ">=", "lt": "<", "le": "<=", "eq": "==", "ne": "!="}


def _c_expr(ins: Instr, a) -> str:
    """The C++ of one scalar operation on the operand strings ``a``."""
    k = ins.kind
    if k in _C_INFIX:
        return f"{a[0]} {_C_INFIX[k]} {a[1]}"
    if k in _C_UNARY:
        return f"{_C_UNARY[k]}({a[0]})"
    if k == "neg":
        return f"-({a[0]})"
    if k == "sign":
        return f"gpmpc_rk4::sign({a[0]})"
    if k == "rsqrt":
        return f"1.0f / sqrtf({a[0]})"
    if k == "reciprocal":
        return f"1.0f / {a[0]}"
    if k == "sigmoid":
        return f"1.0f / (1.0f + expf(-{a[0]}))"
    if k in ("maximum", "minimum"):
        return f"gpmpc_rk4::{k}({a[0]}, {a[1]})"
    if k == "atan2":
        return f"atan2f({a[0]}, {a[1]})"
    if k == "powf":
        return f"powf({a[0]}, {a[1]})"
    if k == "pow":
        return _pow(a[0], ins.params[0])
    if k == "pow_base":
        return f"powf({_lit(ins.params[0])}, {a[0]})"
    if k == "add_alpha":
        return f"fmaf({_lit(ins.params[0])}, {a[1]}, {a[0]})"
    if k == "clamp":
        lo, hi = (None if v is None else _lit(v) for v in ins.params)
        return f"gpmpc_rk4::clamp({a[0]}, {lo or '-INFINITY'}, " \
               f"{hi or 'INFINITY'})"
    if k == "where":
        return f"{a[0]} ? {a[1]} : {a[2]}"
    if k == "float":
        return f"{a[0]} ? 1.0f : 0.0f"
    if k == "logical_and":
        return f"({a[0]} != 0) && ({a[1]} != 0)"
    if k == "logical_or":
        return f"({a[0]} != 0) || ({a[1]} != 0)"
    if k == "logical_xor":
        return f"({a[0]} != 0) != ({a[1]} != 0)"
    if k == "logical_not":
        return f"{a[0]} == 0"
    raise AssertionError(f"no C++ for {k}")


@dataclass(frozen=True)
class Functor:
    """A traced ODE's functor: its struct name (``Traced_`` + the first 16
    hex digits of ``digest``, the SHA-256 of its text), its C++ source and
    its sizes."""
    name: str
    digest: str
    source: str
    nx: int
    nu: int
    nw: int
    n_prep: int
    n_eval: int


def emit(low: Lowered) -> Functor:
    """The C++ functor of a lowered ODE: ``prep(u, w)`` the live operations
    on the input alone (once a rollout), ``eval(x, w, f)`` the rest.  The
    text holds nothing of the ODE's identity, so the name, a hash of the
    text, changes with the program and its constants only."""
    live = _live(low)
    u_only = _on_input_only(low, live)
    # what eval reads of the input side: inputs and hoisted temporaries
    slots = {}
    for r in [a for i in live if i not in u_only
              for a in low.instrs[i].args] + list(low.out):
        if r.kind == "u" or (r.kind == "t" and r.val in u_only):
            slots.setdefault(r, len(slots))

    def name(r, side):
        if r.kind == "k":
            return _lit(r.val)
        if side == "eval" and r in slots:
            return f"w[{slots[r]}]"
        return f"{r.kind}[{r.val}]" if r.kind in ("x", "u") else f"t{r.val}"

    def body(idx, side):
        lines = []
        for i in idx:
            ins = low.instrs[i]
            ctype = "bool" if ins.boolean else "float"
            args = [name(a, side) for a in ins.args]
            lines.append(f"    const {ctype} t{i} = {_c_expr(ins, args)};")
        return lines

    prep_idx = [i for i in live if i in u_only]
    eval_idx = [i for i in live if i not in u_only]
    prep = body(prep_idx, "prep") + [
        f"    w[{j}] = {name(r, 'prep')};" for r, j in slots.items()]
    evl = body(eval_idx, "eval") + [
        f"    f[{i}] = {name(r, 'eval')};" for i, r in enumerate(low.out)]
    nw = max(1, len(slots))
    text = "\n".join([
        f"// A plant ODE traced by gpmpc_tpu_torch/ops/ode_trace.py: nx = "
        f"{low.nx}, nu = {low.nu};",
        f"// {len(prep_idx)} scalar operations on the input alone (prep, "
        f"once a rollout),",
        f"// {len(eval_idx)} an evaluation.",
        "struct @ {",
        f"  static constexpr int NX = {low.nx};",
        f"  static constexpr int NU = {low.nu};",
        f"  static constexpr int NW = {nw};",
        "  // the RK4 stages combined as the plain version combines them",
        "  static constexpr bool PLAIN_ORDER = true;",
        "",
        "  GPMPC_FN static void prep(const float* u, float* w) {",
        "    (void)u;", "    (void)w;", *prep, "  }",
        "",
        "  GPMPC_FN static void eval(const float* x, const float* w, "
        "float* f) {",
        "    (void)x;", "    (void)w;", *evl, "  }",
        "};", ""])
    digest = hashlib.sha256(text.encode()).hexdigest()
    name_ = f"Traced_{digest[:16]}"
    return Functor(name_, digest, text.replace("struct @", f"struct {name_}"),
                   low.nx, low.nu, nw, len(prep_idx), len(eval_idx))


def compile_ode(ode: Callable, nx: int, nu: int, device=None) -> Functor:
    """:func:`emit` of :func:`lower` of :func:`trace_ode`."""
    return emit(lower(trace_ode(ode, nx, nu, device)))


# ------------------------------------------------------------ CPU mirrors

_T_UNARY = {k: getattr(torch, k) for k in (
    "neg", "abs", "sign", "sqrt", "rsqrt", "reciprocal", "exp", "expm1",
    "log", "log1p", "sin", "cos", "tan", "asin", "acos", "atan", "sinh",
    "cosh", "tanh", "sigmoid")}
_T_BINARY = {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
             "div": torch.div, "maximum": torch.maximum,
             "minimum": torch.minimum, "atan2": torch.atan2,
             "powf": torch.pow, "gt": torch.gt, "ge": torch.ge,
             "lt": torch.lt, "le": torch.le, "eq": torch.eq, "ne": torch.ne,
             "logical_and": torch.logical_and,
             "logical_or": torch.logical_or,
             "logical_xor": torch.logical_xor}


def run_lowered(low: Lowered, x: torch.Tensor, u: torch.Tensor
                ) -> torch.Tensor:
    """The scalar program on one point (x ``(nx,)``, u ``(nu,)``), each
    operation PyTorch's own on 0-d tensors: the ODE's value, bit for bit
    where the scalarization is right (PyTorch's elementwise kernels give
    a 0-d tensor the value they give each element of a vector)."""
    def val(r):
        if r.kind == "x":
            return x[r.val]
        if r.kind == "u":
            return u[r.val]
        if r.kind == "t":
            return t[r.val]
        return torch.tensor(r.val, dtype=torch.bool if isinstance(
            r.val, bool) else torch.float32, device=x.device)

    t = []
    for ins in low.instrs:
        a = [val(r) for r in ins.args]
        k, p = ins.kind, ins.params
        if k in _T_UNARY:
            v = _T_UNARY[k](a[0])
        elif k in _T_BINARY:
            v = _T_BINARY[k](a[0], a[1])
        elif k == "add_alpha":
            v = torch.add(a[0], a[1], alpha=p[0])
        elif k == "clamp":
            v = torch.clamp(a[0], p[0], p[1])
        elif k == "pow":
            v = torch.pow(a[0], p[0])
        elif k == "pow_base":
            v = torch.pow(p[0], a[0])
        elif k == "where":
            v = torch.where(a[0], a[1], a[2])
        elif k == "float":
            v = a[0].to(torch.float32)
        elif k == "logical_not":
            v = torch.logical_not(a[0])
        else:
            raise AssertionError(f"no mirror for {k}")
        t.append(v)
    return torch.stack([val(r).to(torch.float32) for r in low.out])


def host_unit_source(functors) -> str:
    """One C++ unit for the host compiler (``g++ -I csrc``) that holds
    ``functors`` behind the RK4 chain of ``csrc/rk4_chain.h``, the chain
    the kernel runs: an ``extern "C"`` entry ``gpmpc_rk4_host_<name>(x, u,
    out, batch, n_sub, h)`` per functor over host arrays."""
    parts = ['#include "rk4_chain.h"', ""]
    seen = set()
    for f in functors:
        if f.name not in seen:
            seen.add(f.name)
            parts.append(f.source)
    parts.append("""template <class Ode>
static void host_chain(const float* x, const float* u, float* out,
                       int batch, int n_sub, double h) {
  const float hf = static_cast<float>(h),
              hh = static_cast<float>(0.5 * h),
              h6 = static_cast<float>(h / 6.0);
  for (int p = 0; p < batch; ++p) {
    float xv[Ode::NX], uv[Ode::NU], wv[Ode::NW];
    for (int i = 0; i < Ode::NX; ++i) xv[i] = x[p * Ode::NX + i];
    for (int i = 0; i < Ode::NU; ++i) uv[i] = u[p * Ode::NU + i];
    Ode::prep(uv, wv);
    gpmpc_rk4::rk4_chain<Ode, 0>(xv, wv, n_sub, hf, hh, h6);
    for (int i = 0; i < Ode::NX; ++i) out[p * Ode::NX + i] = xv[i];
  }
}
""")
    for name in sorted(seen):
        parts.append(
            f'extern "C" void gpmpc_rk4_host_{name}(const float* x, '
            f"const float* u, float* out, int batch, int n_sub, double h) "
            f"{{\n  host_chain<{name}>(x, u, out, batch, n_sub, h);\n}}\n")
    return "\n".join(parts)
