"""The planar quadrotor of gpmpc_tpu_torch against gpmpc_tpu's on the same
numpy-seeded states and inputs (f64, CPU): the ODE, its Jacobians and the
discrete maps a Model builds from it, at the nominal and at a heavier
mass, within 1e-12."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gpmpc_tpu import Model as JModel
from gpmpc_tpu.systems import QUAD_PARAMS as JQUAD, \
    planar_quadrotor_ode as jquad
from gpmpc_tpu_torch import Model
from gpmpc_tpu_torch.systems import QUAD_PARAMS, planar_quadrotor_ode

HEAVY = dict(QUAD_PARAMS, m=1.3)


def _states(n, seed):
    """States in the quadrotor golden's training box, attitude out to
    +-1 rad, and thrusts in [0, 10]."""
    rng = np.random.default_rng(seed)
    x = rng.uniform([-2.0, 0.0, -1.0, -1.5, -1.5, -1.0],
                    [3.0, 3.0, 1.0, 1.5, 1.5, 1.0], (n, 6))
    return x, rng.uniform(0.0, 10.0, (n, 2))


def test_params_match_jax():
    assert QUAD_PARAMS == JQUAD


@pytest.mark.parametrize("params", [None, HEAVY], ids=["nominal", "heavy"])
def test_ode_matches_jax(params):
    """One point at a time and a batch of 64 (the port's ODE is
    elementwise over leading dims; JAX's is vmapped)."""
    x, u = _states(64, 1)
    ref = np.asarray(jax.vmap(lambda a, b: jquad(a, b, params))(
        jnp.asarray(x), jnp.asarray(u)))
    got = planar_quadrotor_ode(torch.tensor(x), torch.tensor(u), params)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12)
    one = planar_quadrotor_ode(torch.tensor(x[3]), torch.tensor(u[3]),
                               params)
    np.testing.assert_allclose(one.numpy(), ref[3], rtol=0, atol=1e-12)


@pytest.mark.parametrize("params", [None, HEAVY], ids=["nominal", "heavy"])
def test_ode_jacobians_match_jax(params):
    """d f / d x and d f / d u by torch.func.jacfwd against jax.jacfwd at
    eight points."""
    x, u = _states(8, 2)
    for xi, ui in zip(x, u):
        for arg in (0, 1):
            ref = jax.jacfwd(lambda a, b: jquad(a, b, params), argnums=arg)(
                jnp.asarray(xi), jnp.asarray(ui))
            got = torch.func.jacfwd(
                lambda a, b: planar_quadrotor_ode(a, b, params),
                argnums=arg)(torch.tensor(xi), torch.tensor(ui))
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                       atol=1e-12)


@pytest.mark.parametrize("params", [None, HEAVY], ids=["nominal", "heavy"])
def test_model_maps_match_jax(params):
    """The quadrotor golden's Model (dt = 0.05, 4 substeps): one RK4 step,
    the plant step and the discrete Jacobians."""
    kw = dict(Nx=6, Nu=2, dt=0.05, R=np.diag([1e-8] * 6),
              integrator_substeps=4)
    jm = JModel(ode=lambda a, b: jquad(a, b, params), dtype=jnp.float64,
                **kw)
    tm = Model(ode=lambda a, b: planar_quadrotor_ode(a, b, params),
               dtype=torch.float64, device="cpu", **kw)
    x, u = _states(4, 3)
    for xi, ui in zip(x, u):
        jx, ju = jnp.asarray(xi), jnp.asarray(ui)
        tx, tu = torch.tensor(xi), torch.tensor(ui)
        for got, ref in ((tm.rk4(tx, tu), jm.rk4(jx, ju)),
                         (tm.integrate(tx, tu), jm.integrate(jx, ju)),
                         *zip(tm.discrete_linearize(tx, tu),
                              jm.discrete_linearize(jx, ju))):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=0, atol=1e-12)


def test_fused_quadrotor_plant_is_refused_on_the_card():
    """A fused quadrotor plant that the lowering cannot take (a branch on
    the state) is refused on a CUDA device at construction, before any
    tensor is placed, so this runs without a card.  The quadrotor ODE as
    it is has no hand-written functor (no tag) and is traced into one of
    its own (ROADMAP §2 item 2); on the CPU the fused path is the plain
    loop."""
    from gpmpc_tpu_torch.ops import cuda_kernels as ck
    kw = dict(Nx=6, Nu=2, dt=0.05, fused_integrator=True)

    def grounded(x, u):
        if x[1] < 0.0:                      # on the ground: a branch
            return torch.zeros_like(x)
        return planar_quadrotor_ode(x, u)

    with pytest.raises(ValueError, match="grounded.*branches"):
        Model(ode=grounded, device="cuda", **kw)
    assert not hasattr(planar_quadrotor_ode, "cuda_ode")
    spec = ck.register_ode(planar_quadrotor_ode, 6, 2, "cuda")
    assert spec.functor is not None and spec.functor.nx == 6
    m = Model(ode=planar_quadrotor_ode, device="cpu", **kw)
    x = torch.tensor([0.0, 1.0, 0.1, 0.0, 0.0, 0.0])
    assert torch.all(torch.isfinite(m.integrate(x, torch.tensor([5.0, 5.0]))))
