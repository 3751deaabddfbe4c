"""Planar-quadrotor hybrid GP-MPC under a mass mismatch.

Counterpart of ``examples/quadrotor.py``.  A PVTOL quadrotor whose true
mass is 30% above the nominal model's: the nominal-model controller
plans its hover thrust for the wrong gravity balance and droops below
the waypoint; the hybrid controller (``discrete_method='hybrid'``: the
nominal RK4 step plus a GP trained on observed one-step residuals)
learns the missing dynamics and closes the gap.

The plant here is not the controller's model, so the loop drives the
true plant from the host through ``mpc.solve_step``, the interface a real
vehicle would use.  Self-checks: the hybrid controller's settled altitude
error is under half the nominal one's and under 0.1 m, both loops stay
finite, and the thrusts respect the rotor limits.  Writes
``quadrotor.png``.

Usage: python3 -m gpmpc_tpu_torch.examples.quadrotor [--quick] [--cpu]
"""

import functools

import numpy as np
import torch
from torch.func import vmap

from gpmpc_tpu_torch import GP, MPC, Model
from gpmpc_tpu_torch.examples._common import (clock, device_dtype, draw,
                                              generator, run_cli)
from gpmpc_tpu_torch.systems import QUAD_PARAMS, planar_quadrotor_ode
from gpmpc_tpu_torch.utils.plotting import pyplot

DT = 0.05
X_LO = np.array([-2.0, 0.0, -0.4, -1.5, -1.5, -1.0])
X_HI = np.array([3.0, 3.0, 0.4, 1.5, 1.5, 1.0])
X0 = np.array([0.0, 1.0, 0.0, 0.0, 0.0, 0.0])      # hover at (0, 1)
X_SP = np.array([1.5, 2.0, 0.0, 0.0, 0.0, 0.0])    # waypoint (1.5, 2)
U_LB, U_UB = np.array([0.0, 0.0]), np.array([10.0, 10.0])


def build_models(device, dtype):
    """The nominal model and the true, 1.3 kg plant."""
    kw = dict(Nx=6, Nu=2, dt=DT, R=np.diag([1e-8] * 6),
              integrator_substeps=4, device=device, dtype=dtype)
    nominal = Model(ode=planar_quadrotor_ode, **kw)
    plant = Model(ode=functools.partial(planar_quadrotor_ode,
                                        p=dict(QUAD_PARAMS, m=1.3)), **kw)
    return nominal, plant


def training_data(nominal, plant, quick):
    """60 (quick) or 120 transitions over the hover/transit envelope (seed
    0): inputs Z = (x, u) and the observed true step minus the nominal RK4
    step."""
    g = generator(nominal.device, 0)
    kw = dict(dtype=nominal.dtype, device=nominal.device)
    n = 60 if quick else 120
    lo, hi = (torch.as_tensor(v, **kw) for v in (X_LO, X_HI))
    xs = lo + (hi - lo) * torch.rand((n, 6), generator=g, **kw)
    us = 2.0 + 7.0 * torch.rand((n, 2), generator=g, **kw)
    resid = vmap(plant.integrate)(xs, us) - vmap(nominal.rk4)(xs, us)
    return torch.cat([xs, us], dim=1), resid


def fit(Z, resid):
    return GP(Z, resid, mean_func="zero", gp_method="TA", multistart=2,
              max_iters=150, seed=1, device=Z.device, dtype=Z.dtype)


def build_mpc(nominal, gp, discrete_method):
    """The controller on the nominal model: ``'rk4'`` alone or ``'hybrid'``
    with the residual GP; horizon 15 steps, the default solver budget."""
    hybrid = discrete_method == "hybrid"
    return MPC(horizon=15 * DT, model=nominal, gp=gp if hybrid else None,
               gp_method="TA" if hybrid else "ME",
               discrete_method=discrete_method,
               Q=np.diag([10.0, 30.0, 2.0, 1.0, 1.0, 0.2]),
               R=0.02 * np.eye(2), ulb=U_LB, uub=U_UB,
               xlb=[-5.0, 0.2, -1.0, -5.0, -5.0, -6.0],
               xub=[5.0, 5.0, 1.0, 5.0, 5.0, 6.0], feedback=False,
               percentile=None, cov_updates=1, device=nominal.device)


def fly(mpc, plant, n_steps):
    """The closed loop on the true plant through ``solve_step``; returns
    the states (n_steps+1, 6), the inputs (n_steps, 2) and the wall
    seconds."""
    x = torch.as_tensor(X0, dtype=plant.dtype, device=plant.device)
    warm, u_prev = None, None
    traj, inputs = [x], []
    t0 = clock(plant.device)
    for _ in range(n_steps):
        u0, warm, _, _ = mpc.solve_step(x, X_SP, warm=warm, u_prev=u_prev)
        u_prev = u0
        x = plant.integrate(x, u0)
        traj.append(x)
        inputs.append(u0)
    wall = clock(plant.device) - t0
    return (torch.stack(traj).cpu().numpy(),
            torch.stack(inputs).cpu().numpy(), wall)


def plot_altitude(xs_nom, xs_hyb, filename="quadrotor.png"):
    """Altitude and x tracking of both controllers: the droop and its
    correction."""
    plt = pyplot()
    t = np.arange(xs_nom.shape[0]) * DT
    fig, axes = plt.subplots(2, 1, sharex=True, figsize=(8, 5))
    for ax, idx, name in ((axes[0], 1, "z [m]"), (axes[1], 0, "x [m]")):
        ax.plot(t, xs_nom[:, idx], c="tab:red", label="nominal model")
        ax.plot(t, xs_hyb[:, idx], c="tab:blue", label="hybrid GP")
        ax.axhline(X_SP[idx], ls=":", c="g", lw=0.9, label="waypoint")
        ax.set_ylabel(name)
        ax.legend(loc="lower right", fontsize=8)
    axes[-1].set_xlabel("time [s]")
    fig.suptitle("Planar quadrotor: hybrid GP corrects a 30% mass mismatch")
    fig.tight_layout()
    fig.savefig(filename, dpi=120)
    plt.close(fig)


def main(quick=False, device=None):
    device, dtype = device_dtype(device)
    nominal, plant = build_models(device, dtype)
    gp = fit(*training_data(nominal, plant, quick))
    n_steps = 30 if quick else 60
    xs_nom, us_nom, wall_n = fly(build_mpc(nominal, gp, "rk4"), plant,
                                 n_steps)
    xs_hyb, us_hyb, wall_h = fly(build_mpc(nominal, gp, "hybrid"), plant,
                                 n_steps)
    tail = slice(-max(n_steps // 3, 5), None)
    err_nom = float(np.abs(xs_nom[tail, 1] - X_SP[1]).mean())
    err_hyb = float(np.abs(xs_hyb[tail, 1] - X_SP[1]).mean())
    print(f"nominal model (mass -23% wrong): settled |z err|={err_nom:.3f} m"
          f"  wall={wall_n:.1f}s")
    print(f"hybrid GP residuals           : settled |z err|={err_hyb:.3f} m"
          f"  wall={wall_h:.1f}s")
    assert np.all(np.isfinite(xs_hyb)) and np.all(np.isfinite(xs_nom))
    assert us_hyb.min() >= -1e-6 and us_hyb.max() <= 10.0 + 1e-6
    assert err_hyb < 0.5 * err_nom, (err_hyb, err_nom)
    assert err_hyb < 0.1, err_hyb
    if draw(plot_altitude, xs_nom, xs_hyb):
        print("plot written: quadrotor.png")
    return dict(wall=wall_n + wall_h,
                ms_per_step=1e3 * wall_h / n_steps,
                nominal_ms_per_step=1e3 * wall_n / n_steps,
                err_nominal=err_nom, err_hybrid=err_hyb)


if __name__ == "__main__":
    run_cli(main, __doc__)
