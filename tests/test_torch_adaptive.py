"""Port parity for the adaptive plant and DAE systems: the DOPRI5
integrator (``Model(integrator='adaptive')``) over lanes with per-lane
masks, under ``jacfwd`` and in an ``exact``-mode controller, its failure
rule (NaN where the JAX package poisons), DAE elimination (``Model(alg=)``,
the network of ``examples/dae_network.py``), each against the JAX package
at f64 on the CPU within 1e-8 (a closed loop 1e-6); and the port's ctypes
binding of the host integrator ``csrc/integrator.cpp`` against the JAX
package's binding."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gpmpc_tpu import MPC as JMPC, Model as JModel
from gpmpc_tpu import native as jnative
from gpmpc_tpu.systems import four_tank_ode as jode
from gpmpc_tpu_torch import MPC, Model, native
from gpmpc_tpu_torch.systems import four_tank_ode

F64 = torch.float64
CPU = dict(device="cpu", dtype=F64)
TANK = dict(Nx=4, Nu=2, dt=3.0, R=np.diag([1e-3] * 4), clip_negative=True)


def _pend_j(x, u):
    return jnp.stack([x[1], -9.81 * jnp.sin(x[0]) - 0.2 * x[1] + u[0]])


def _pend_t(x, u):
    """The JAX tests' pendulum, written for one state (x[0], x[1])."""
    return torch.stack([x[1], -9.81 * torch.sin(x[0]) - 0.2 * x[1] + u[0]])


def _pend(**kw):
    kw = dict(Nx=2, Nu=1, dt=0.05, integrator="adaptive", **kw)
    return (JModel(ode=_pend_j, dtype=jnp.float64, **kw),
            Model(ode=_pend_t, **CPU, **kw))


def test_adaptive_lanes_and_jacobian_match_jax():
    """Eight lanes of the pendulum (an ODE written for one state) in one
    call against JAX's ``vmap``; one lane alone; the forward-mode Jacobian
    against JAX's ``jacfwd``: within 1e-8."""
    jm, tm = _pend(rtol=1e-8, atol=1e-10)
    rng = np.random.default_rng(0)
    x0s, us = rng.uniform(-0.5, 0.5, (8, 2)), rng.uniform(-1, 1, (8, 1))
    ref = np.asarray(jax.vmap(jm.integrate)(jnp.asarray(x0s),
                                            jnp.asarray(us)))
    got = tm.integrate(torch.tensor(x0s), torch.tensor(us))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-8)
    one = tm.integrate(torch.tensor(x0s[3]), torch.tensor(us[3]))
    np.testing.assert_allclose(one.numpy(), ref[3], rtol=0, atol=1e-12)
    jj = np.asarray(jax.jacfwd(lambda x: jm.integrate(
        x, jnp.asarray(us[0])))(jnp.asarray(x0s[0])))
    tj = torch.func.jacfwd(lambda x: tm.integrate(
        x, torch.tensor(us[0])))(torch.tensor(x0s[0]))
    np.testing.assert_allclose(tj.numpy(), jj, rtol=0, atol=1e-8)


def test_adaptive_four_tank_sim_matches_jax_and_the_host_integrator():
    """A 20-step ``sim`` of the four-tank plant with the adaptive
    integrator at its default tolerances against JAX's within 1e-8, and at
    rtol 1e-10 against the port's host integrator (``native.sim``, the
    same DOPRI5 pair in C++) within 1e-8; on the CPU the loop reads its
    stop flag after every step."""
    jm = JModel(ode=lambda x, u: jode(x, u), integrator="adaptive",
                dtype=jnp.float64, **TANK)
    tm = Model(ode=four_tank_ode, integrator="adaptive", **CPU, **TANK)
    rng = np.random.default_rng(1)
    useq = rng.uniform(0.0, 6.0, (20, 2))
    x0 = np.array([8.0, 9.0, 1.0, 1.0])
    ref = np.asarray(jm.sim(jnp.asarray(x0), jnp.asarray(useq)))
    got = tm.sim(x0, useq).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-8)
    assert tm.adaptive_host_reads > 20
    tight = Model(ode=four_tank_ode, integrator="adaptive", rtol=1e-10,
                  atol=1e-12, **CPU, **TANK)
    host = native.sim(x0, useq, 3.0, system="four_tank",
                      params=native.tank_params(), rtol=1e-10, atol=1e-12,
                      clip_negative=True)
    np.testing.assert_allclose(tight.sim(x0, useq).numpy(), host, rtol=0,
                               atol=1e-8)


def test_adaptive_controls_error_on_stiff_decay():
    """``tests/test_dynamics.py``: on a fast decay over a long interval the
    adaptive integrator hits the analytic solution (within 1e-8) where 10
    fixed RK4 substeps blow up, as in the JAX package."""
    kw = dict(Nx=1, Nu=1, ode=lambda x, u: -60.0 * x + u, dt=1.0, **CPU)
    x0, u = torch.tensor([1.0], dtype=F64), torch.zeros(1, dtype=F64)
    got = float(Model(integrator="adaptive", rtol=1e-8, atol=1e-12,
                      **kw).integrate(x0, u)[0])
    assert abs(got - np.exp(-60.0)) < 1e-8
    assert abs(float(Model(integrator_substeps=10, **kw).integrate(
        x0, u)[0]) - np.exp(-60.0)) > 1.0


def test_adaptive_poisons_where_jax_does():
    """The failure rule: a lane whose budget runs out mid-interval (here a
    stiff decay at ``max_adaptive_steps=50``) comes back NaN, in both
    packages; in a batch only that lane, the others at JAX's values
    (within 1e-8)."""
    kw = dict(Nx=1, Nu=1, dt=1.0, integrator="adaptive", rtol=1e-10,
              atol=1e-12, max_adaptive_steps=50)
    jm = JModel(ode=lambda x, u: -u * x, dtype=jnp.float64, **kw)
    tm = Model(ode=lambda x, u: -u * x, **CPU, **kw)
    x0s = np.ones((3, 1))
    us = np.array([[1.0], [1e9], [0.5]])
    ref = np.asarray(jax.vmap(jm.integrate)(jnp.asarray(x0s),
                                            jnp.asarray(us)))
    got = tm.integrate(torch.tensor(x0s), torch.tensor(us)).numpy()
    assert np.isnan(ref[1]).all() and np.isnan(got[1]).all()
    np.testing.assert_allclose(got[[0, 2]], ref[[0, 2]], rtol=0, atol=1e-8)
    np.testing.assert_allclose(got[0], np.exp(-1.0), rtol=1e-8)


def test_exact_controller_differentiates_the_adaptive_integrator():
    """``discrete_method='exact'`` embeds the adaptive integrator in the
    NLP: its Jacobians come from ``jacfwd`` through the masked loop, whose
    stop flag is read from the primal values beneath the transform.  One
    step of the four-tank loop (Nt = 2) within 1e-6 of JAX's."""
    kw = dict(integrator="adaptive", rtol=1e-8, atol=1e-10, **TANK)
    jm = JModel(ode=lambda x, u: jode(x, u), dtype=jnp.float64, **kw)
    tm = Model(ode=four_tank_ode, **CPU, **kw)
    mk = dict(horizon=6.0, gp=None, discrete_method="exact", gp_method="ME",
              Q=np.diag([10.0, 10.0, 0.1, 0.1]), R=0.01 * np.eye(2),
              ulb=[0.0, 0.0], uub=[8.0, 8.0], feedback=False,
              percentile=None, cov_updates=1,
              solver_opts=dict(al_iters=1, max_iters=2),
              init_solver_opts=dict(al_iters=1, max_iters=3))
    x0, x_sp = np.array([8.0, 9.0, 1.0, 1.0]), np.array([12.4, 12.7, 1.8, 1.4])
    jx, ju = JMPC(model=jm, **mk).solve(x0, 3.0, x_sp, noise=False)
    tx, tu = MPC(model=tm, device="cpu", **mk).solve(x0, 3.0, x_sp,
                                                     noise=False)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0, atol=1e-6)


# ------------------------------------------------------------------ DAE

A1, A2 = 2.0, 3.0
C1, C2, C3, C4 = 1.2, 1.0, 0.25, 0.6


def _dae(lib):
    """The junction network of ``examples/dae_network.py`` (Nx = 2, Nu =
    1, Nz = 1) in ``lib`` (jnp or torch)."""
    mx = jnp.maximum if lib is jnp else \
        (lambda v, c: torch.clamp(v, min=c))

    def sq(v):
        return lib.sqrt(mx(v, 1e-9))

    def ode(x, z, u):
        return lib.stack([(u[0] - C1 * sq(x[0] - z[0])) / A1,
                          (C2 * sq(z[0] - x[1]) - C4 * sq(x[1])) / A2])

    def alg(x, z, u):
        return lib.stack([C1 * sq(x[0] - z[0]) - C2 * sq(z[0] - x[1])
                          - C3 * sq(z[0])])

    return ode, alg


def _dae_pair(**kw):
    kw = dict(Nx=2, Nu=1, Nz=1, alg_newton_iters=12, dt=2.0,
              R=np.diag([1e-5, 1e-5]), clip_negative=True,
              integrator_substeps=20, **kw)
    jo, ja = _dae(jnp)
    to, ta = _dae(torch)
    return (JModel(ode=jo, alg=ja, z_guess=lambda x, u: 0.5 * (x[:1] + x[1:]),
                   dtype=jnp.float64, **kw),
            Model(ode=to, alg=ta, z_guess=lambda x, u: 0.5 * (x[:1] + x[1:]),
                  **CPU, **kw))


@pytest.mark.parametrize("integrator", ["rk4", "adaptive"])
def test_dae_network_matches_jax(integrator):
    """The DAE network: the Newton elimination of the junction head, the
    reduced ODE's one-step maps (RK4 and ``integrate``, two points in one
    call) and their linearizations within 1e-8 of JAX; the algebraic
    residual at Newton tolerance."""
    jm, tm = _dae_pair(integrator=integrator)
    rng = np.random.default_rng(2)
    xs = np.stack([rng.uniform(4.0, 8.0, 2), rng.uniform(0.5, 3.0, 2)], 1)
    us = rng.uniform(0.0, 4.0, (2, 1))
    for x, u in zip(xs, us):
        jx, ju = jnp.asarray(x), jnp.asarray(u)
        tx, tu = torch.tensor(x), torch.tensor(u)
        zt = tm.solve_alg(tx, tu)
        np.testing.assert_allclose(zt.numpy(), np.asarray(jm.solve_alg(jx, ju)),
                                   rtol=0, atol=1e-10)
        assert abs(float(tm.alg(tx, zt, tu)[0])) < 1e-10
        for a, b in zip(tm.discrete_linearize(tx, tu),
                        jm.discrete_linearize(jx, ju)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-8)
    ref = np.asarray(jax.vmap(jm.integrate)(jnp.asarray(xs), jnp.asarray(us)))
    got = tm.integrate(torch.tensor(xs), torch.tensor(us)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-8)
    np.testing.assert_allclose(tm.rk4(torch.tensor(xs), torch.tensor(us)),
                               np.asarray(jax.vmap(jm.rk4)(jnp.asarray(xs),
                                                           jnp.asarray(us))),
                               rtol=0, atol=1e-8)


def test_dae_analytic_and_its_linearization():
    """``tests/test_misc_parity.py``: x' = -z, 0 = z - x^2 (x' = -x^2):
    the RK4 and adaptive maps hit x0 / (1 + x0 t), the Newton solve z =
    x^2 exactly, and d(-x^2)/dx = -2x flows through it."""
    kw = dict(Nx=1, Nu=1, ode=lambda x, z, u: -z,
              alg=lambda x, z, u: z - x * x, Nz=1, dt=0.5, **CPU)
    x0, u = torch.tensor([2.0], dtype=F64), torch.zeros(1, dtype=F64)
    m = Model(integrator_substeps=50, **kw)
    assert abs(float(m.integrate(x0, u)[0]) - 1.0) < 1e-6
    assert abs(float(m.solve_alg(x0, u)[0]) - 4.0) < 1e-10
    assert abs(float(m.linearize(x0, u)[0][0, 0]) + 4.0) < 1e-8
    ma = Model(integrator="adaptive", rtol=1e-9, atol=1e-12, **kw)
    assert abs(float(ma.integrate(x0, u)[0]) - 1.0) < 1e-8


# ------------------------------------------------------- host integrator

def test_native_binding_matches_the_jax_binding():
    """The port's binding of ``csrc/integrator.cpp`` against the JAX
    package's on the four-tank and car systems and a Python callback
    (``integrate`` and ``sim``), within 1e-12 relative; the port's library
    lies in ``gpmpc_tpu_torch/build/``."""
    try:
        jnative._load()
    except Exception as e:  # pragma: no cover - no compiler in env
        pytest.skip(f"the JAX package's native integrator is unavailable: {e}")
    native.load()
    path = native.library_path()
    assert path.exists() and path.parent.name == "build"
    assert path.parent.parent.name == "gpmpc_tpu_torch"
    x0, u = np.array([8.0, 9.0, 1.0, 1.0]), np.array([3.0, 2.5])
    cases = [dict(system="four_tank", params=native.tank_params()),
             dict(system="car", params=native.car_params()),
             dict(ode=lambda x, uu: np.array(jode(jnp.asarray(x),
                                                  jnp.asarray(uu))))]
    jcases = [dict(system="four_tank", params=jnative.tank_params()),
              dict(system="car", params=jnative.car_params()),
              dict(ode=cases[2]["ode"])]
    for c, jc in zip(cases, jcases):
        got = native.integrate(x0, u, 0.5, **c)
        ref = jnative.integrate(x0, u, 0.5, **jc)
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0)
    useq = np.random.default_rng(3).uniform(-1.0, 1.0, (6, 2))
    got = native.sim(x0, useq, 0.1, system="car", params=native.car_params())
    ref = jnative.sim(x0, useq, 0.1, system="car",
                      params=jnative.car_params())
    assert got.shape == (7, 4)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(native.car_params(), jnative.car_params())


def test_native_build_raises_with_the_compilers_words(monkeypatch, tmp_path):
    """Without ``g++`` the first call raises and says so; a source the
    compiler refuses raises with its output."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.integrate([1.0], [0.0], 0.1, ode=lambda x, u: -x)
    monkeypatch.undo()
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "SRC", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.load()
    assert not list(tmp_path.glob("*.so"))
