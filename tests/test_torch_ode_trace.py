"""K2 for any plant ODE: the tracer, its lowering and the generated
functor (``gpmpc_tpu_torch/ops/ode_trace.py``), held on the CPU.

* The lowered scalar program of each ODE, run with PyTorch's own ops on
  0-d tensors, is the ODE's value bit for bit.
* The generated functors, built in one ``g++`` compile behind the RK4
  chain the kernel runs (``csrc/rk4_chain.h``), agree with the plain
  version and with the JAX package's ``rk4_substeps_pallas`` in interpret
  mode on the JAX counterpart ODEs.
* What the lowering refuses raises ``ValueError`` naming it; the unit's
  hash follows the program, not the callable; the custom operator runs
  a traced functor's plain version on the CPU, also under ``vmap``.

The card's side is in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import ctypes
import functools
import importlib.util
import pathlib
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from gpmpc_tpu import systems as jsys
from gpmpc_tpu.ops.pallas_kernels import rk4_substeps_pallas
from gpmpc_tpu_torch.examples.pendulum import pendulum_ode
from gpmpc_tpu_torch.ops import cuda_kernels as ck
from gpmpc_tpu_torch.ops import ode_trace as ot
from gpmpc_tpu_torch.systems import (QUAD_PARAMS, car_ode, four_tank_ode,
                                     planar_quadrotor_ode)
from gpmpc_tpu_torch.utils.export import refuse_traced_k2

ROOT = pathlib.Path(__file__).resolve().parent.parent
HEAVY = dict(QUAD_PARAMS, m=1.3)
C3 = torch.tensor([1.0, 2.0, 3.0])
W3 = torch.tensor([[0.5, -0.2, 0.1], [0.3, 0.8, -0.4], [-0.1, 0.2, 0.9]])


def _jax_pendulum():
    """``examples/pendulum.py::pendulum_ode`` of the JAX package's
    examples (a script directory, not a package)."""
    spec = importlib.util.spec_from_file_location(
        "jax_example_pendulum", ROOT / "examples" / "pendulum.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.pendulum_ode


def closure_ode(x, u):
    """A closure over a tensor constant, with clamp, where and pow(., 2)."""
    y = torch.clamp(x * C3, min=0.1, max=5.0)
    return torch.where(x > 1.0, y ** 2, (1.0 - x) / 2.0 + u[0])


def inplace_ode(x, u):
    """A pendulum-like ODE written into its result in place."""
    dx = torch.zeros_like(x)
    dx[0] = x[1]
    dx[1] = -9.81 * torch.sin(x[0]) - 0.1 * x[1] + u[0]
    dx[2:] *= 0.0
    dx[2:] += -x[2:] * 2.0
    return dx


def wide_ode(x, u):
    """Most of the lowering's other ops on one state of 3 and one input."""
    r = 1.0 + x * x
    a = torch.exp(-0.1 * x) + torch.log(r) - torch.tanh(x) + torch.sinh(
        0.1 * x) - torch.expm1(-0.05 * r) + torch.log1p(0.5 * r)
    b = (torch.atan2(x, r) * torch.sign(x) + torch.rsqrt(r)
         + torch.asin(0.1 * torch.tanh(x)) - torch.cosh(0.1 * x))
    c = (torch.sigmoid(x) - torch.reciprocal(r) + x ** 3 - 2.0 ** (-r)
         + r ** 0.5 - r ** -0.5 + r ** -1 - r ** -2 + r ** 1.7 + r ** 0
         + r ** 1 + torch.pow(r, x * 0.1))
    m = torch.minimum(x, torch.full_like(x, 0.5)).clamp_min(-1.0) \
        + x.clamp_max(1.0) + torch.maximum(x, -x).abs()
    w = torch.where(x > 0.0, x, torch.zeros_like(x)) \
        + torch.where((x < u[0]) & (x > -2.0), 1.0, 0.0) \
        + x.bool() * 3.0 + (x * 0.0).bool().float() \
        + torch.where((x - x[0]).bool(), x, 2.0 * x) + (x > 0.3).float()
    s = x.unsqueeze(0).expand(2, 3).sum(0) / 2.0
    v = W3 @ x + (x @ W3) + (W3 @ W3 @ x.unsqueeze(1)).squeeze(1)
    p = torch.cat([x[1:], x[:1]]) * torch.stack(list(x.unbind(0))[::-1])
    tot = (x.sum() * 0.01 + torch.ones(3) * u[0] + torch.tensor(0.25)
           + torch.zeros(3) + x.view(3, 1).squeeze(1).reshape(-1) * 0.1
           + x.to(torch.float32).mean() + x.prod() * 0.01 + x.amax()
           + x.flip(0) * 0.1 - torch.dot(x, x) * 0.01)
    return (a + b + c + m + w + s + v + p + tot) * 0.01


def _inputs(name, batch, seed):
    """Seeded numpy points in each ODE's own domain, f32."""
    rng = np.random.default_rng(seed)
    if name == "four_tank":
        x = np.abs(rng.standard_normal((batch, 4))) * 4 + 0.5
        x[0, 3] = 0.0                      # a drained tank, on the clamp
        u = np.abs(rng.standard_normal((batch, 2))) * 3
    elif name == "car":
        x, u = (t.numpy() for t in ck.car_inputs(batch, seed))
    elif name == "quadrotor":
        x = rng.uniform([-2.0, 0.0, -0.4, -1.5, -1.5, -1.0],
                        [3.0, 3.0, 0.4, 1.5, 1.5, 1.0], (batch, 6))
        u = rng.uniform(2.0, 9.0, (batch, 2))
    elif name in ("pendulum", "inplace"):
        n = 2 if name == "pendulum" else 4
        x = rng.uniform([-np.pi, -3.0] + [-2.0] * (n - 2),
                        [np.pi, 3.0] + [2.0] * (n - 2), (batch, n))
        u = rng.uniform(-5.0, 5.0, (batch, 1))
    else:
        x = rng.uniform(-2.0, 2.5, (batch, 3))
        u = rng.uniform(-1.0, 1.0, (batch, 1))
    return (np.ascontiguousarray(x, np.float32),
            np.ascontiguousarray(u, np.float32))


#: name -> (ODE, nx, nu, substep h, n_sub): the four-tank main path's
#: plant as bench.py builds it (a lambda), the car wrapped, the heavy
#: quadrotor as examples/quadrotor.py builds it (a partial), the pendulum
#: walkthrough's ODE, two closures and an ODE that writes in place
ODES = {
    "four_tank": (lambda x, u: four_tank_ode(x, u), 4, 2, 0.3, 10),
    "car": (lambda x, u: car_ode(x, u), 4, 2, 0.01, 10),
    "quadrotor": (functools.partial(planar_quadrotor_ode, p=HEAVY), 6, 2,
                  0.05 / 4, 4),
    "pendulum": (pendulum_ode, 2, 1, 0.01, 10),
    "closure": (closure_ode, 3, 1, 0.05, 10),
    "inplace": (inplace_ode, 4, 1, 0.01, 10),
    "wide": (wide_ode, 3, 1, 0.05, 5),
}
BITWISE = ("four_tank", "car", "quadrotor", "pendulum", "closure",
           "inplace")


@pytest.mark.parametrize("name", BITWISE)
def test_lowered_program_is_the_ode_bitwise(name):
    ode, nx, nu, _, _ = ODES[name]
    low = ot.lower(ot.trace_ode(ode, nx, nu))
    x, u = _inputs(name, 64, 3)
    for i in range(x.shape[0]):
        xi, ui = torch.from_numpy(x[i]), torch.from_numpy(u[i])
        assert torch.equal(ot.run_lowered(low, xi, ui), ode(xi, ui)), i


def test_wide_ode_lowering_matches_the_ode():
    """Reductions and products sum in order (PyTorch's order may differ
    at rounding); every other op as PyTorch computes it."""
    ode, nx, nu, _, _ = ODES["wide"]
    low = ot.lower(ot.trace_ode(ode, nx, nu))
    x, u = _inputs("wide", 32, 4)
    for i in range(x.shape[0]):
        xi, ui = torch.from_numpy(x[i]), torch.from_numpy(u[i])
        torch.testing.assert_close(ot.run_lowered(low, xi, ui), ode(xi, ui),
                                   rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """Every generated functor in one ``g++`` compile behind the kernel's
    RK4 chain (the port's ``native`` build uses the same compiler)."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.fail("g++ not found: the host build of the functors needs it")
    functors = {k: ot.compile_ode(o, nx, nu)
                for k, (o, nx, nu, _, _) in ODES.items()}
    d = tmp_path_factory.mktemp("k2_host")
    (d / "unit.cpp").write_text(ot.host_unit_source(functors.values()))
    proc = subprocess.run(
        [cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off",
         "-Wall", "-Werror", "-Wno-unknown-pragmas", "-I", str(ck.CSRC),
         "-o", str(d / "libk2host.so"), str(d / "unit.cpp")],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(d / "libk2host.so"))
    return lib, functors


def _host_run(host_lib, name, x, u):
    lib, functors = host_lib
    _, _, _, h, n_sub = ODES[name]
    fn = getattr(lib, f"gpmpc_rk4_host_{functors[name].name}")
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_double]
    out = np.empty_like(x)
    fn(x.ctypes.data, u.ctypes.data, out.ctypes.data, x.shape[0], n_sub, h)
    return out


@pytest.mark.parametrize("name", list(ODES))
def test_host_built_functor_matches_plain_version(host_lib, name):
    ode, _, _, h, n_sub = ODES[name]
    x, u = _inputs(name, 256, 5)
    got = _host_run(host_lib, name, x, u)
    ref = ck.rk4_substeps_rollouts(ode, torch.from_numpy(x),
                                   torch.from_numpy(u), h, n_sub).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["four_tank", "quadrotor", "pendulum"])
def test_host_built_functor_matches_pallas_kernel(host_lib, name):
    """Against ``rk4_substeps_pallas(..., interpret=True)`` on the JAX
    package's counterpart ODE (vmapped over the points, as the JAX Model
    maps it), at the CPU mirror's tolerance."""
    jode = {"four_tank": lambda x, u: jsys.four_tank_ode(x, u),
            "quadrotor": lambda x, u: jsys.planar_quadrotor_ode(
                x, u, dict(jsys.QUAD_PARAMS, m=1.3)),
            "pendulum": _jax_pendulum()}[name]
    _, _, _, h, n_sub = ODES[name]
    x, u = _inputs(name, 16, 6)
    ref = np.asarray(jax.vmap(lambda a, b: rk4_substeps_pallas(
        jode, a, b, h, n_sub, interpret=True))(jnp.asarray(x),
                                              jnp.asarray(u)))
    assert ref.dtype == np.float32
    np.testing.assert_allclose(_host_run(host_lib, name, x, u), ref,
                               rtol=1e-6, atol=1e-7)


def test_functor_hoists_what_reads_the_input_alone():
    """The quadrotor's thrust terms go to prep (once a rollout) and its
    evaluation reads them from w, as the hand-written Car does."""
    ode, nx, nu, _, _ = ODES["quadrotor"]
    f = ot.compile_ode(ode, nx, nu)
    assert (f.nx, f.nu, f.nw, f.n_prep, f.n_eval) == (6, 2, 3, 5, 7)
    prep = f.source[f.source.index("prep("):f.source.index("eval(")]
    assert "u[0] + u[1]" in prep and "x[" not in prep
    assert "sinf(x[2])" in f.source and "cosf(x[2])" in f.source


def test_unsupported_op_raises_naming_it():
    def cumulative(x, u):
        return torch.cumsum(x, 0) + u[0]

    with pytest.raises(ValueError, match=r"aten\.cumsum.*K2 lowering") as e:
        ot.compile_ode(cumulative, 3, 1)
    assert "cumulative" in str(e.value)
    # bool + bool stays bool in PyTorch (a logical or): no f32 sum
    with pytest.raises(ValueError, match=r"aten\.add\.Tensor on bool"):
        ot.compile_ode(lambda x, u: ((x > 0) + (x > 1)).float(), 3, 1)


def test_data_dependent_branch_raises_naming_the_ode():
    def branchy(x, u):
        if x[0] > 0:
            return x * u[0]
        return -x

    with pytest.raises(ValueError, match="branchy.*branches"):
        ot.trace_ode(branchy, 3, 1)
    with pytest.raises(ValueError, match="branches"):
        ot.trace_ode(lambda x, u: x * float(x[0]), 3, 1)


def test_output_shape_and_dtype_are_checked():
    with pytest.raises(ValueError, match=r"returns \(2,\).*shape \(3,\)"):
        ot.trace_ode(lambda x, u: x[:2], 3, 1)
    with pytest.raises(ValueError, match="dtype torch.float64"):
        ot.trace_ode(lambda x, u: (x.double() * 2.0).float(), 3, 1)


def test_unit_hash_follows_the_program_not_the_callable():
    def make(c0):
        t = torch.tensor([c0, 2.0])
        return lambda x, u: x * t + u[0]

    a, b, c = make(1.0), make(1.0), make(1.5)
    fa, fb, fc = (ot.compile_ode(f, 2, 1) for f in (a, b, c))
    assert fa.digest == fb.digest != fc.digest
    assert fa.name == f"Traced_{fa.digest[:16]}"
    sa, sb, sc = (ck.register_ode(f, 2, 1) for f in (a, b, c))
    assert sa.ode_id == sb.ode_id != sc.ode_id
    assert min(sa.ode_id, sc.ode_id) >= len(ck.CUDA_ODES)
    assert ck.k2_library_path(fa) == ck.k2_library_path(fb) != \
        ck.k2_library_path(fc)
    # a tagged ODE keeps its hand-written functor
    assert ck.register_ode(four_tank_ode, 4, 2).functor is None
    assert ck.register_ode(car_ode, 4, 2).ode_id == ck.CUDA_ODES["car"][0]


def test_traced_unit_includes_the_kernel_for_its_functor_alone():
    f = ot.compile_ode(*ODES["pendulum"][:3])
    unit = ck.traced_unit_source(f)
    assert unit.index(f"struct {f.name}") < unit.index(
        f"#define GPMPC_RK4_TRACED {f.name}") < unit.index(
        '#include "rk4_substeps.cu"')
    src = (ck.CSRC / "rk4_substeps.cu").read_text()
    for entry in ("gpmpc_rk4_traced_f32", "gpmpc_rk4_traced_chain_cycles_f32"):
        assert f'extern "C" int {entry}(' in src
    assert "--fmad=false" in ck.K2_TRACED_FLAGS


def test_custom_operator_runs_a_traced_plain_version_on_cpu():
    """``gpmpc::rk4_substeps`` with a traced id: the registered callable's
    plain version on CPU tensors, over each rollout of a batch (the
    pendulum indexes x[0], so it is written for one point), also under
    ``vmap``; no launch."""
    spec = ck.register_ode(pendulum_ode, 2, 1)
    assert spec.functor is not None and spec.ode is pendulum_ode
    x, u = (torch.from_numpy(a) for a in _inputs("pendulum", 8, 7))
    before = ck.LAUNCHES["rk4_substeps"]
    one = torch.stack([ck.rk4_substeps_reference(pendulum_ode, x[i], u[i],
                                                 0.01, 10)
                       for i in range(8)])
    assert torch.equal(ck.rk4_substeps_op(x[2], u[2], spec.ode_id, 0.01, 10),
                       one[2])
    torch.testing.assert_close(
        ck.rk4_substeps_op(x, u, spec.ode_id, 0.01, 10), one, rtol=0,
        atol=0)
    got = torch.func.vmap(lambda a, b: ck.rk4_substeps_op(
        a, b, spec.ode_id, 0.01, 10))(x, u)
    torch.testing.assert_close(got, one, rtol=0, atol=0)
    assert ck.LAUNCHES["rk4_substeps"] == before


def test_export_refuses_a_graph_with_a_traced_k2():
    """A traced functor's ode_id means nothing in a loading process: the
    export check raises naming the ROADMAP item; a hand-written one's
    passes."""
    spec = ck.register_ode(pendulum_ode, 2, 1)
    x, u = torch.zeros(2), torch.zeros(1)
    g = make_fx(lambda a, b: ck.rk4_substeps_op(a, b, spec.ode_id, 0.01, 2),
                tracing_mode="real")(x, u)
    with pytest.raises(ValueError, match="ROADMAP §2 item 2"):
        refuse_traced_k2(g.graph)
    xt, ut = torch.zeros(4), torch.zeros(2)
    g0 = make_fx(lambda a, b: ck.rk4_substeps_op(a, b, 0, 0.3, 2),
                 tracing_mode="real")(xt, ut)
    refuse_traced_k2(g0.graph)
