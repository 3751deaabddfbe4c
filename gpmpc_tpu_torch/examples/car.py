"""Car GP-MPC with obstacle avoidance.

Counterpart of ``examples/car.py``.  A kinematic bicycle car with hybrid
dynamics (the known model's coarse RK4 step plus GP residuals), exact
moment matching (EM), chance constraints with feedback, a delta-u
penalty, and two ellipse keep-out zones given to the controller through
its inequality-constraint hook with per-solve parameters
(``num_con_par`` / ``con_par_func``).  Prints the final position, the
obstacle clearance (the smallest ellipse metric; > 1 is outside) and the
converged solves, and writes ``car_states.png`` and
``car_trajectory.png``.

Usage: python3 -m gpmpc_tpu_torch.examples.car [--quick] [--cpu]
"""

import time

import numpy as np
import torch
from torch.func import vmap

from gpmpc_tpu_torch import GP, MPC, Model
from gpmpc_tpu_torch.examples._common import (device_dtype, draw, generator,
                                              run_cli)
from gpmpc_tpu_torch.systems import car_ode, ellipse_obstacle_constraints
from gpmpc_tpu_torch.utils.plotting import pyplot

DT = 0.1
X_LB = np.array([-1.0, -1.0, -0.6, 0.0])
X_UB = np.array([1.0, 1.0, 0.6, 8.0])
U_LB = np.array([-3.0, -0.5])
U_UB = np.array([3.0, 0.5])
#: two static obstacle ellipses (cx, cy, rx, ry) between start and goal
OBSTACLES = np.array([[6.0, 0.3, 1.5, 1.0],
                      [12.0, -0.6, 1.5, 1.2]])
X0 = np.array([0.0, 0.0, 0.0, 2.0])
X_SP = np.array([18.0, 0.0, 0.0, 2.0])


def build_model(device, dtype):
    return Model(Nx=4, Nu=2, ode=car_ode, dt=DT,
                 R=np.diag([1e-5, 1e-5, 1e-6, 1e-5]), integrator_substeps=10,
                 device=device, dtype=dtype)


def training_data(model, quick):
    """40 (quick) or 80 uniform transitions in the training box (seed 4):
    inputs Z = (x, u) and the residuals between the true plant and one
    coarse RK4 step."""
    g = generator(model.device, 4)
    kw = dict(dtype=model.dtype, device=model.device)
    n = 40 if quick else 80
    xl, xu, ul, uu = (torch.as_tensor(v, **kw)
                      for v in (X_LB, X_UB, U_LB, U_UB))
    x_s = xl + (xu - xl) * torch.rand((n, 4), generator=g, **kw)
    u_s = ul + (uu - ul) * torch.rand((n, 2), generator=g, **kw)
    resid = vmap(model.integrate)(x_s, u_s) - vmap(model.rk4)(x_s, u_s)
    return torch.cat([x_s, u_s], dim=1), resid


def fit(Z, resid):
    return GP(Z, resid, mean_func="zero", gp_method="EM", multistart=2,
              max_iters=200, seed=3, device=Z.device, dtype=Z.dtype)


def build_mpc(model, gp, quick):
    """EM + hybrid, horizon 8 (quick) or 20 steps, 0.95 tightening with
    feedback, the obstacles as user constraints, cov_updates=2."""
    ineq_cb, n_par = ellipse_obstacle_constraints(OBSTACLES.shape[0],
                                                  scale=2.0)
    return MPC(horizon=(8 if quick else 20) * DT, model=model, gp=gp,
               gp_method="EM", discrete_method="hybrid",
               Q=np.diag([5.0, 20.0, 0.5, 1.0]), R=np.diag([0.1, 1.0]),
               S=np.diag([0.05, 0.5]), ulb=U_LB, uub=U_UB,
               xlb=[-5.0, -4.0, -2.0, 0.0], xub=[25.0, 4.0, 2.0, 10.0],
               percentile=0.95, feedback=True,
               # the feedback gain linearized at the cruise speed: at v = 0
               # the position modes are uncontrollable and the LQR Riccati
               # iteration cannot converge
               op_x=X0, inequality_constraints=ineq_cb, num_con_par=n_par,
               cov_updates=2, device=model.device)


def clearance(xs):
    """The smallest ellipse metric over the path (> 1: outside)."""
    return min(float((((xs[:, 0] - cx) / rx) ** 2
                      + ((xs[:, 1] - cy) / ry) ** 2).min())
               for cx, cy, rx, ry in OBSTACLES)


def drive(mpc, quick):
    """The closed loop from X0, 20 (quick) or 100 steps, process noise
    from seed 0; returns the path and its readings."""
    t0 = time.perf_counter()
    xs, us = mpc.solve(x0=X0, sim_time=(20 if quick else 100) * DT,
                       x_sp=X_SP, con_par_func=lambda k: OBSTACLES.ravel(),
                       generator=generator(mpc.device, 0))
    wall = time.perf_counter() - t0
    xs = xs.cpu().numpy()
    r = mpc.last_run
    return xs, dict(wall=wall, ms_per_step=1e3 * r["wall_time_per_step"],
                    final_pos=xs[-1, :2].tolist(), clearance=clearance(xs),
                    converged=int(r["converged"].sum()),
                    steps=int(us.shape[0]))


def plot_path(xs, filename="car_trajectory.png"):
    """The closed-loop path among the obstacles."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(9, 4))
    ax.plot(xs[:, 0], xs[:, 1], "-o", ms=2, label="closed-loop path")
    for cx, cy, rx, ry in OBSTACLES:
        ax.add_patch(plt.matplotlib.patches.Ellipse(
            (cx, cy), 2 * rx, 2 * ry, fill=True, alpha=0.3, color="r"))
    ax.plot(*X_SP[:2], "g*", ms=14, label="goal")
    ax.set_aspect("equal")
    ax.legend()
    fig.savefig(filename, dpi=120)
    plt.close(fig)


def main(quick=False, device=None):
    device, dtype = device_dtype(device)
    model = build_model(device, dtype)
    gp = fit(*training_data(model, quick))
    mpc = build_mpc(model, gp, quick)
    xs, r = drive(mpc, quick)
    print(f"car EM+hybrid: wall={r['wall']:.2f}s "
          f"({r['ms_per_step']:.1f} ms/step) final "
          f"pos=({xs[-1, 0]:.2f},{xs[-1, 1]:.2f}) min obstacle "
          f"metric={r['clearance']:.2f} (>1 means outside) "
          f"converged={r['converged']}/{r['steps']}")
    assert np.isfinite(xs).all(), "non-finite closed loop"
    if draw(mpc.plot, filename="car_states.png") and draw(plot_path, xs):
        print("plots written: car_states.png, car_trajectory.png")
    return r


if __name__ == "__main__":
    run_cli(main, __doc__)
