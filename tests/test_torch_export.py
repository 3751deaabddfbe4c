"""The deployable solve step of the port (``gpmpc_tpu_torch/utils/
export.py``) in f64 on the CPU: the artifact against the live port step
(bitwise), against JAX's live ``MPC._solve_step`` on the same numpy inputs,
on inputs other than the traced ones, in a receding loop, through bytes, a
path and a fresh process, and with the AL-SQP's early exit on.

One artifact serves the file (a trace and an export take ~40 s): the
four-tank TA step at Nt=3 on 30 fixture points, al2 x mi2, with a coarse
inner tolerance (tol_stat 0.3) so that the traced inputs, a warm start
settled at the setpoint, leave each inner loop after one step under the
CPU's early exit, while the cold start from X0 needs two."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from benchmarks.bench_spec import X0, XSP
from gpmpc_tpu.solvers.al_sqp import SolverState as JSolverState
from gpmpc_tpu_torch import Model, MPC
from gpmpc_tpu_torch.solvers import al_sqp
from gpmpc_tpu_torch.systems import four_tank_ode
from gpmpc_tpu_torch.utils import export as ex

from test_torch_mpc import _jax_side, _port_side

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NT = 3
BUDGET = dict(solver_opts=dict(al_iters=2, max_iters=2, tol_stat=0.3))


def _iters(mpc, args):
    return int(mpc._solve_step(*args)[3].iters)


def _settled_args(mpc, steps=8):
    """The step's arguments after ``steps`` live RTI steps from X0 toward
    XSP: a warm start near the setpoint's steady state."""
    x, warm, u = torch.tensor(X0, dtype=torch.float64), None, None
    for _ in range(steps):
        u, warm, _, _ = mpc.solve_step(x, XSP, warm=warm, u_prev=u)
        x = mpc.model.integrate(x, u)
    args = ex._example_args(mpc, x, XSP)
    return (warm, x, args[2], u) + args[4:]


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    """The f64 artifact traced at the settled inputs, saved to a path, and
    the live MPC."""
    assert al_sqp.CPU_EARLY_EXIT
    mpc = _port_side(torch.float64, "TA", "gp", False, nt=NT, **BUDGET)
    traced = _settled_args(mpc)
    path = tmp_path_factory.mktemp("export") / "solve_step.pt2"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ex, "_example_args", lambda _: traced)
        blob = ex.export_solve_step(mpc, str(path))
    info = dict(ex.EXPORT_INFO)
    return dict(mpc=mpc, traced=traced, blob=blob, path=path, info=info,
                step=ex.load_solve_step(blob))


def _live(mpc, args):
    state, u0, _, info = mpc._solve_step(*args)
    return torch.clamp(u0, mpc.consts.ulb, mpc.consts.uub), state, info.obj


def _assert_bitwise(got, want):
    u0, warm, obj = got
    u0_l, warm_l, obj_l = want
    assert torch.equal(u0, u0_l)
    for a, b in zip(warm, warm_l):
        assert torch.equal(a, b)
    assert torch.equal(obj, obj_l)


def test_exported_step_matches_live_port_and_jax(art):
    """At the cold start from X0: the artifact equals the live port step
    bit for bit, and JAX's live step (x64) on the same numpy inputs within
    1e-8 (u0, warm.x; the multipliers, up to 55 here, within 1e-8 of their
    scale 1 + max|lam|) and rtol 1e-8 (obj)."""
    mpc, step = art["mpc"], art["step"]
    args = ex._example_args(mpc, X0, XSP)
    got = step(*args)
    _assert_bitwise(got, _live(mpc, args))
    assert art["info"]["ops"]["aten::add.Tensor"] > 0
    assert not any("gpmpc" in k for k in art["info"]["ops"])  # no K1 in f64

    jmpc = _jax_side(jnp.float64, "TA", "gp", False, nt=NT, **BUDGET)
    warm, x0, x_sp, u_prev, sigma0, con_par, _ = args
    jwarm = JSolverState(*(jnp.asarray(t.numpy()) for t in warm))
    jstate, ju0, _, jinfo = jax.jit(jmpc._solve_step)(
        jwarm, jnp.asarray(x0.numpy()), jnp.asarray(x_sp.numpy()),
        jnp.asarray(u_prev.numpy()), jnp.asarray(sigma0.numpy()),
        jnp.asarray(con_par.numpy()), jmpc.consts)
    ju0 = jnp.clip(ju0, jmpc.consts.ulb, jmpc.consts.uub)
    u0, w, obj = got
    np.testing.assert_allclose(u0.numpy(), np.asarray(ju0), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(w.x.numpy(), np.asarray(jstate.x), rtol=0,
                               atol=1e-8)
    lam = np.asarray(jstate.lam)
    np.testing.assert_allclose(w.lam.numpy(), lam, rtol=0,
                               atol=1e-8 * (1.0 + np.abs(lam).max()))
    np.testing.assert_allclose(float(obj), float(jinfo.obj), rtol=1e-8)


def test_artifact_runs_the_masked_budget_under_early_exit(art):
    """Traced where the CPU's early exit leaves each inner loop after one
    step, the artifact still runs the full masked budget: on the cold start
    (two steps an inner loop) it equals the live step bit for bit."""
    mpc = art["mpc"]
    cold = ex._example_args(mpc, X0, XSP)
    assert _iters(mpc, art["traced"]) == 2       # al2 x one inner step
    assert _iters(mpc, cold) == 4                # al2 x mi2
    _assert_bitwise(art["step"](*cold), _live(mpc, cold))
    _assert_bitwise(art["step"](*art["traced"]), _live(mpc, art["traced"]))


def test_exported_step_on_new_inputs(art):
    """Nothing is baked in by value: another x0, a tripled Q, a scaled
    posterior (x, alpha, inv_k) and shifted hypers give the live step's
    outputs bit for bit."""
    mpc, step = art["mpc"], art["step"]
    warm, x0, x_sp, u_prev, sigma0, con_par, consts = \
        ex._example_args(mpc, X0 + 0.5, XSP)
    post = consts.post
    hyp = post.hypers
    consts = consts._replace(
        q=3.0 * consts.q,
        post=post._replace(x=1.05 * post.x, alpha=0.9 * post.alpha,
                           inv_k=1.1 * post.inv_k,
                           hypers=hyp._replace(log_ell=hyp.log_ell + 0.1,
                                               log_sf2=hyp.log_sf2 - 0.2)))
    args = (warm, x0, x_sp, u_prev, sigma0, con_par, consts)
    got = step(*args)
    _assert_bitwise(got, _live(mpc, args))
    base = step(*ex._example_args(mpc, X0, XSP))
    assert not torch.equal(got[1].x, base[1].x)


def test_artifact_receding_loop_matches_live(art):
    """Three steps threading the artifact's warm start through the plant
    equal the live loop bit for bit."""
    mpc, step = art["mpc"], art["step"]
    args = ex._example_args(mpc, X0, XSP)
    warm, x, x_sp, u_prev, sigma0, con_par, consts = args
    w_a, x_a, u_a = warm, x, u_prev
    w_l, x_l, u_l = warm, x, u_prev
    for _ in range(3):
        u_a, w_a, _ = step(w_a, x_a, x_sp, u_a, sigma0, con_par, consts)
        u_l, w_l, _ = _live(mpc, (w_l, x_l, x_sp, u_l, sigma0, con_par,
                                  consts))
        x_a = mpc.model.integrate(x_a, u_a)
        x_l = mpc.model.integrate(x_l, u_l)
        assert torch.equal(u_a, u_l) and torch.equal(x_a, x_l)
        assert torch.equal(w_a.x, w_l.x)


def test_save_load_bytes_path_and_fresh_process(art, tmp_path):
    """The saved path holds the bytes; a fresh process that imports only
    the port's package loads the path and reproduces the bytes-loaded
    step's u0 bit for bit; a structure other than the exported one
    raises."""
    mpc = art["mpc"]
    assert art["path"].read_bytes() == art["blob"]
    args = ex._example_args(mpc, X0, XSP)
    u0 = art["step"](*args)[0]

    torch.save(args, tmp_path / "args.pt")
    code = (
        "import sys, torch\n"
        "from gpmpc_tpu_torch.utils.export import load_solve_step\n"
        "step = load_solve_step(sys.argv[1])\n"
        "args = torch.load(sys.argv[2], weights_only=False)\n"
        "torch.save(step(*args)[0], sys.argv[3])\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code, str(art["path"]),
                    str(tmp_path / "args.pt"), str(tmp_path / "u0.pt")],
                   check=True, env=env, cwd=tmp_path, timeout=300)
    assert torch.equal(torch.load(tmp_path / "u0.pt"), u0)

    with pytest.raises(ValueError, match="structure"):
        art["step"](args[0].x, *args[1:])
    with pytest.raises(ValueError, match="structure"):   # s was None
        art["step"](*args[:-1], args[-1]._replace(s=torch.eye(2)))


def test_export_refuses_a_host_read():
    """discrete_method='exact' with the adaptive integrator reads its stop
    test on the host inside the step: export raises before tracing."""
    m = Model(Nx=4, Nu=2, ode=four_tank_ode, dt=3.0, integrator="adaptive",
              device="cpu", dtype=torch.float64)
    mpc = MPC(horizon=2 * 3.0, model=m, discrete_method="exact",
              feedback=False, device="cpu")
    with pytest.raises(ValueError, match="adaptive"):
        ex.export_solve_step(mpc)
