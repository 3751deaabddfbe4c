"""Adaptive GP-MPC under a coverage-starved prior.

Counterpart of ``examples/adaptive.py``.  ``MPC(online_capacity=N)``
conditions the controller's GP posterior on every observed transition of
its closed loop (bordered-inverse updates with a novelty gate,
``parallel.online_gp``).

The four-tank controller is trained on transitions from a low-level
corner of the state space only (h <= 5), while the setpoint lies far
outside it (h ~ 12.4).  The frozen-GP controller acts on extrapolation;
the adaptive one learns the territory as it crosses it.  The script runs
both and prints their realized closed-loop costs and terminal tracking
errors; self-checks: the adaptive GP grew, and its controller's cost is
below the frozen one's.  Writes ``adaptive_tracking.png``.

Usage: python3 -m gpmpc_tpu_torch.examples.adaptive [--quick] [--cpu]
"""

import time

import numpy as np

from gpmpc_tpu_torch import GP, MPC, Model
from gpmpc_tpu_torch.examples._common import (device_dtype, draw, generator,
                                              run_cli)
from gpmpc_tpu_torch.systems import four_tank_ode
from gpmpc_tpu_torch.utils.plotting import pyplot

DT = 3.0
N_PRIOR = 25
X0 = np.array([8.0, 9.0, 1.0, 1.0])
X_SP = np.array([12.4, 12.7, 1.8, 1.4])
Q_W = np.diag([10.0, 10.0, 0.1, 0.1])
R_W = 0.01 * np.eye(2)


def build_model(device, dtype):
    return Model(Nx=4, Nu=2, ode=four_tank_ode, dt=DT,
                 R=np.diag([1e-4] * 4), clip_negative=True,
                 integrator_substeps=10, device=device, dtype=dtype)


def fit(model):
    """The starved prior: 25 transitions from the low-level corner (seed
    3), 2 starts, 150 iterations."""
    X, Y = model.generate_training_data(
        N_PRIOR, uub=[2.5, 2.5], ulb=[0.0, 0.0], xub=[5.0, 5.0, 2.0, 2.0],
        xlb=[1.0, 1.0, 0.5, 0.5], generator=generator(model.device, 3))
    return GP(X, Y, multistart=2, max_iters=150, seed=1,
              device=model.device, dtype=model.dtype)


def run(model, gp, n_steps, online):
    """One noisy closed loop (seed 5) with the frozen GP or the online one
    (capacity 64); returns the states, the realized cost, the wall seconds
    and the controller."""
    mpc = MPC(horizon=5 * DT, model=model, gp=gp, gp_method="ME",
              discrete_method="gp", Q=Q_W, R=R_W, ulb=[0.0, 0.0],
              uub=[8.0, 8.0], feedback=False, percentile=None,
              cov_updates=1, online_capacity=64 if online else None,
              device=model.device)
    t0 = time.perf_counter()
    xs, us = mpc.solve(x0=X0, sim_time=n_steps * DT, x_sp=X_SP, noise=True,
                       generator=generator(model.device, 5))
    wall = time.perf_counter() - t0
    xs, us = xs.cpu().numpy(), us.cpu().numpy()
    ex = xs[:-1] - X_SP
    cost = float(np.einsum("ti,ij,tj->", ex, Q_W, ex)
                 + np.einsum("ti,ij,tj->", us, R_W, us))
    return xs, cost, wall, mpc


def plot_tracking(xs_frozen, xs_online, filename="adaptive_tracking.png"):
    """Tanks 1 and 2 under the frozen and the adaptive GP."""
    plt = pyplot()
    t = np.arange(xs_frozen.shape[0]) * DT
    fig, axes = plt.subplots(2, 1, sharex=True, figsize=(8, 5))
    for i, ax in enumerate(axes):
        ax.plot(t, xs_frozen[:, i], c="tab:red", label="frozen GP")
        ax.plot(t, xs_online[:, i], c="tab:blue", label="adaptive GP")
        ax.axhline(X_SP[i], ls=":", c="g", lw=0.9, label="setpoint")
        ax.set_ylabel(f"h{i + 1} [cm]")
        ax.legend(loc="lower right", fontsize=8)
    axes[-1].set_xlabel("time [s]")
    fig.suptitle("Adaptive GP-MPC under a coverage-starved prior")
    fig.tight_layout()
    fig.savefig(filename, dpi=120)
    plt.close(fig)


def main(quick=False, device=None):
    device, dtype = device_dtype(device)
    model = build_model(device, dtype)
    gp = fit(model)
    n_steps = 15 if quick else 40
    xs_frozen, cost_frozen, wall_f, _ = run(model, gp, n_steps, False)
    xs_online, cost_online, wall_o, mpc_o = run(model, gp, n_steps, True)
    tail = min(10, n_steps // 2)
    err_f = float(np.abs(xs_frozen[-tail:, :2] - X_SP[:2]).mean())
    err_o = float(np.abs(xs_online[-tail:, :2] - X_SP[:2]).mean())
    pts = mpc_o.last_run["gp_points"]
    print(f"frozen GP : closed-loop cost={cost_frozen:9.1f}  "
          f"tail |err|={err_f:.3f}  wall={wall_f:.1f}s")
    print(f"adaptive  : closed-loop cost={cost_online:9.1f}  "
          f"tail |err|={err_o:.3f}  wall={wall_o:.1f}s  "
          f"(GP grew {N_PRIOR} -> {pts} points online)")
    assert np.isfinite(xs_online).all()
    assert pts > N_PRIOR, "online conditioning accumulated no data"
    assert cost_online < cost_frozen, \
        "adaptive controller did not beat the frozen one"
    if draw(plot_tracking, xs_frozen, xs_online):
        print("plot written: adaptive_tracking.png")
    return dict(wall=wall_f + wall_o,
                ms_per_step=1e3 * mpc_o.last_run["wall_time_per_step"],
                frozen_ms_per_step=1e3 * wall_f / n_steps,
                cost_frozen=cost_frozen, cost_online=cost_online,
                gp_points=pts)


if __name__ == "__main__":
    run_cli(main, __doc__)
