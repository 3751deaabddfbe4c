"""Port parity: the plant model and the RK4 substep kernel's plain version of
gpmpc_tpu_torch against gpmpc_tpu, plus the fused-integrator guards."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gpmpc_tpu.models.dynamics import Model as JModel
from gpmpc_tpu.ops.pallas_kernels import rk4_substeps_pallas
from gpmpc_tpu.systems import four_tank_ode as jode
from gpmpc_tpu_torch import MPC, Model
from gpmpc_tpu_torch.ops.cuda_kernels import (LAUNCHES, rk4_substeps,
                                              rk4_substeps_reference)
from gpmpc_tpu_torch.systems import four_tank_ode

KW = dict(Nx=4, Nu=2, dt=3.0, integrator_substeps=10)
TKW = dict(KW, device="cpu")


def _states(n, seed):
    rng = np.random.default_rng(seed)
    x = np.abs(rng.standard_normal((n, 4))) * 4.0 + 0.5
    x[0, 3] = 0.0                  # a drained tank: the max(x, 1e-6) guard
    return x, np.abs(rng.standard_normal((n, 2))) * 3.0


def test_ode_and_maps_match_jax_f64():
    jm = JModel(ode=lambda x, u: jode(x, u), dtype=jnp.float64, **KW)
    tm = Model(ode=four_tank_ode, dtype=torch.float64, **TKW)
    xs, us = _states(6, 0)
    for x, u in zip(xs, us):
        jx, ju = jnp.asarray(x), jnp.asarray(u)
        tx, tu = torch.as_tensor(x), torch.as_tensor(u)
        np.testing.assert_allclose(four_tank_ode(tx, tu).numpy(),
                                   np.asarray(jode(jx, ju)), rtol=1e-12,
                                   atol=1e-14)
        np.testing.assert_allclose(tm.integrate(tx, tu).numpy(),
                                   np.asarray(jm.integrate(jx, ju)),
                                   rtol=1e-12)
        np.testing.assert_allclose(tm.rk4(tx, tu).numpy(),
                                   np.asarray(jm.rk4(jx, ju)), rtol=1e-12)
        for got, ref in zip(tm.linearize(tx, tu) + tm.discrete_linearize(tx, tu),
                            jm.linearize(jx, ju) + jm.discrete_linearize(jx, ju)):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=1e-10, atol=1e-12)


def test_ode_batched_over_leading_dims():
    xs, us = _states(5, 1)
    tx, tu = torch.as_tensor(xs), torch.as_tensor(us)
    batched = four_tank_ode(tx, tu)
    for i in range(5):
        assert torch.equal(batched[i], four_tank_ode(tx[i], tu[i]))


def test_rk4_reference_matches_pallas_interpret_f32():
    """The kernel's plain version against the TPU kernel (Pallas interpret),
    one rollout and a batch, at the tolerances of tests/test_pallas.py."""
    h, n_sub = 0.3, 10
    xs, us = _states(8, 2)
    xs, us = xs.astype(np.float32), us.astype(np.float32)
    ode = lambda x, u: jode(x, u)  # noqa: E731
    ref1 = rk4_substeps_pallas(ode, jnp.asarray(xs[1]), jnp.asarray(us[1]),
                               h, n_sub, interpret=True)
    got1 = rk4_substeps_reference(four_tank_ode, torch.as_tensor(xs[1]),
                                  torch.as_tensor(us[1]), h, n_sub)
    assert got1.dtype == torch.float32
    np.testing.assert_allclose(got1.numpy(), np.asarray(ref1), rtol=1e-6,
                               atol=1e-7)
    refb = jax.vmap(lambda x, u: rk4_substeps_pallas(
        ode, x, u, h, n_sub, interpret=True))(jnp.asarray(xs), jnp.asarray(us))
    gotb = rk4_substeps_reference(four_tank_ode, torch.as_tensor(xs),
                                  torch.as_tensor(us), h, n_sub)
    np.testing.assert_allclose(gotb.numpy(), np.asarray(refb), rtol=1e-6,
                               atol=1e-7)


def test_fused_integrator_on_cpu_is_the_plain_loop():
    """On the CPU, Model(fused_integrator=True) runs the kernel's plain
    version — the same substep loop as the default integrator — and
    launches nothing."""
    m0 = Model(ode=four_tank_ode, **TKW)
    m1 = Model(ode=four_tank_ode, fused_integrator=True, **TKW)
    x = torch.tensor([8.0, 10.0, 1.0, 1.5])
    u = torch.tensor([3.0, 3.0])
    before = dict(LAUNCHES)
    assert torch.equal(m1.integrate(x, u), m0.integrate(x, u))
    assert torch.equal(rk4_substeps(four_tank_ode, x, u, 0.3, 10),
                       rk4_substeps_reference(four_tank_ode, x, u, 0.3, 10))
    assert LAUNCHES == before


def test_fused_integrator_guards():
    with pytest.raises(ValueError, match="f32"):
        Model(ode=four_tank_ode, fused_integrator=True, dtype=torch.float64,
              **TKW)
    with pytest.raises(ValueError, match="DAE"):
        Model(ode=four_tank_ode, fused_integrator=True, alg=lambda *a: 0,
              **TKW)
    with pytest.raises(ValueError, match="adaptive"):
        Model(ode=four_tank_ode, fused_integrator=True, integrator="adaptive",
              **TKW)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(ode=four_tank_ode, integrator="adaptive", **TKW)
    with pytest.raises(ValueError, match="unknown integrator"):
        Model(ode=four_tank_ode, integrator="euler", **TKW)
    # exact-mode MPC embeds integrate in the NLP: refused with the kernel
    fused = Model(ode=four_tank_ode, fused_integrator=True, **TKW)
    with pytest.raises(ValueError, match="exact"):
        MPC(horizon=9.0, model=fused, discrete_method="exact", device="cpu")
