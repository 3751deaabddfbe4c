"""Plant models shipped with the framework.

Counterpart of ``gpmpc_tpu/systems.py``.  Only the four-tank process is
ported so far; the car and planar-quadrotor ODEs are ROADMAP slice B/F work.
"""

from __future__ import annotations

import torch

#: Quadruple-tank parameters (Johansson 2000 lab process): tank/outlet areas
#: in cm^2, gravity in cm/s^2, pump gains, three-way valve splits.
TANK_PARAMS = dict(
    A1=28.0, A2=32.0, A3=28.0, A4=32.0,
    a1=0.071, a2=0.057, a3=0.071, a4=0.057,
    g=981.0, k1=3.33, k2=3.35, gamma1=0.7, gamma2=0.6,
)


def four_tank_ode(x, u, p=None):
    """Quadruple-tank process: 4 levels, 2 pumps, nonlinear sqrt(h)
    outflow.  States h1..h4 [cm], inputs v1, v2 [V]; elementwise over
    leading batch dimensions of ``x`` (..., 4) and ``u`` (..., 2).

    The constant products are Python floats, folded in double before they
    meet the tensor, exactly like the JAX version; the CUDA functor
    ``FourTank`` in ``csrc/rk4_substeps.cu`` folds them the same way."""
    p = p or TANK_PARAMS
    # sqrt-safety; levels are physical (>= 0).  torch.maximum splits a
    # tie's derivative like jnp.maximum
    h = torch.maximum(x, torch.full_like(x, 1e-6))
    q = torch.sqrt(2.0 * p["g"] * h)
    h1 = (-p["a1"] / p["A1"] * q[..., 0] + p["a3"] / p["A1"] * q[..., 2]
          + p["gamma1"] * p["k1"] / p["A1"] * u[..., 0])
    h2 = (-p["a2"] / p["A2"] * q[..., 1] + p["a4"] / p["A2"] * q[..., 3]
          + p["gamma2"] * p["k2"] / p["A2"] * u[..., 1])
    h3 = (-p["a3"] / p["A3"] * q[..., 2]
          + (1.0 - p["gamma2"]) * p["k2"] / p["A3"] * u[..., 1])
    h4 = (-p["a4"] / p["A4"] * q[..., 3]
          + (1.0 - p["gamma1"]) * p["k1"] / p["A4"] * u[..., 0])
    return torch.stack([h1, h2, h3, h4], dim=-1)


#: The fused RK4 kernel compiles its ODE in; this id names the functor in
#: ``csrc/rk4_substeps.cu`` that computes this function with the default
#: ``TANK_PARAMS``.
four_tank_ode.cuda_ode = "four_tank"
