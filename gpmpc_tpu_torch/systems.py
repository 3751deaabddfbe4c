"""Plant models shipped with the framework.

Counterpart of ``gpmpc_tpu/systems.py``: the four-tank process, the
kinematic car with its ellipse obstacles, the car's bench constants
(training box, obstacles, start and goal), and the planar quadrotor.
"""

from __future__ import annotations

import numpy as np
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


#: The fused RK4 kernel (K2) takes this ODE, passed as it is, through the
#: hand-written functor this id names in ``csrc/rk4_substeps.cu`` (this
#: function with the default ``TANK_PARAMS``); a wrapped or reparameterized
#: four-tank ODE is traced into a functor of its own
#: (``ops/ode_trace.py``).
four_tank_ode.cuda_ode = "four_tank"


# --------------------------------------------------------------------- car

#: Kinematic bicycle parameters: front/rear axle distances [m].
CAR_PARAMS = dict(lf=1.2, lr=1.4)


def car_ode(x, u, p=None):
    """Kinematic bicycle car: states [px, py, psi (heading), v (speed)],
    inputs [a (acceleration), delta (steering angle)]; elementwise over
    leading batch dimensions of ``x`` (..., 4) and ``u`` (..., 2).

    lr / (lf + lr) is a Python float folded in double, as in the JAX
    version; the CUDA functor ``Car`` in ``csrc/rk4_substeps.cu`` folds it
    (and 1 / lr) the same way."""
    p = p or CAR_PARAMS
    v, psi = x[..., 3], x[..., 2]
    beta = torch.atan(p["lr"] / (p["lf"] + p["lr"]) * torch.tan(u[..., 1]))
    return torch.stack([
        v * torch.cos(psi + beta),
        v * torch.sin(psi + beta),
        v / p["lr"] * torch.sin(beta),
        u[..., 0],
    ], dim=-1)


#: the id of the hand-written functor in ``csrc/rk4_substeps.cu`` that
#: computes this function with the default ``CAR_PARAMS`` (a wrapped car
#: ODE is traced, as any other)
car_ode.cuda_ode = "car"


def ellipse_obstacle_constraints(n_obstacles: int, scale: float = 1.0):
    """An ``inequality_constraints`` callback for ``n_obstacles`` ellipse
    keep-out zones, parameterized per solve by ``par = [cx, cy, rx, ry] *
    n`` (through ``num_con_par``/``con_par_func``).  Returns the callback
    and its parameter count.

    Constraint per obstacle (g <= 0):
        1 - ((px-cx)/(rx+m))^2 - ((py-cy)/(ry+m))^2 <= 0
    with m = scale * sqrt(max eigenvalue of the positional covariance), an
    uncertainty margin from the propagated state covariance.  The callback
    ``(x, cov, u, par) -> (n_obstacles,)`` is elementwise over leading
    batch dimensions of ``x`` and ``cov``."""
    def cb(x, cov, u, par):
        px, py = x[..., 0], x[..., 1]
        c00, c01 = cov[..., 0, 0], cov[..., 0, 1]
        c10, c11 = cov[..., 1, 0], cov[..., 1, 1]
        # conservative radius inflation from covariance (largest axis)
        tr = c00 + c11
        det = c00 * c11 - c01 * c10
        lam_max = 0.5 * tr + torch.sqrt(torch.clamp(0.25 * tr * tr - det,
                                                    min=0.0))
        m = scale * torch.sqrt(torch.clamp(lam_max, min=0.0))
        g = []
        for i in range(n_obstacles):
            cx, cy, rx, ry = (par[4 * i], par[4 * i + 1],
                              par[4 * i + 2], par[4 * i + 3])
            g.append(1.0 - ((px - cx) / (rx + m)) ** 2
                     - ((py - cy) / (ry + m)) ** 2)
        return torch.stack(g, dim=-1)

    return cb, 4 * n_obstacles


#: The car bench's constants (bench config 4): the box its residual GP is
#: trained and validated in (states, inputs), its two ellipse obstacles
#: ``[cx, cy, rx, ry]``, start and goal.
CAR_X_LB = np.array([-1.0, -1.0, -0.6, 0.0])
CAR_X_UB = np.array([1.0, 1.0, 0.6, 8.0])
CAR_U_LB = np.array([-3.0, -0.5])
CAR_U_UB = np.array([3.0, 0.5])
CAR_OBSTACLES = np.array([[6.0, 0.3, 1.5, 1.0],
                          [12.0, -0.6, 1.5, 1.2]])
CAR_X0 = np.array([0.0, 0.0, 0.0, 2.0])
CAR_XSP = np.array([18.0, 0.0, 0.0, 2.0])


# --------------------------------------------------------- planar quadrotor

#: Planar quadrotor (PVTOL) parameters: mass [kg], arm length [m], inertia
#: [kg m^2], gravity [m/s^2].
QUAD_PARAMS = dict(m=1.0, l=0.25, J=0.02, g=9.81)


def planar_quadrotor_ode(x, u, p=None):
    """Planar quadrotor / PVTOL: states [px, pz, theta, vx, vz, omega],
    inputs [T1, T2] (rotor thrusts); elementwise over leading batch
    dimensions of ``x`` (..., 6) and ``u`` (..., 2).

        v̇x = -(T1+T2) sin(theta) / m
        v̇z =  (T1+T2) cos(theta) / m - g
        ω̇  =  l (T1 - T2) / J

    The products and quotients go in the JAX version's order.  It has no
    hand-written K2 functor (no ``cuda_ode`` tag): a fused quadrotor plant
    on the card traces it, with its parameters, into a functor of its own
    (``ops/ode_trace.py``; the thrust terms, which read the input alone,
    are formed once a rollout)."""
    p = p or QUAD_PARAMS
    theta, vx, vz, omega = x[..., 2], x[..., 3], x[..., 4], x[..., 5]
    thrust = u[..., 0] + u[..., 1]
    return torch.stack([
        vx,
        vz,
        omega,
        -thrust * torch.sin(theta) / p["m"],
        thrust * torch.cos(theta) / p["m"] - p["g"],
        p["l"] * (u[..., 0] - u[..., 1]) / p["J"],
    ], dim=-1)
