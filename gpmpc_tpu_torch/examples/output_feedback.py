"""Output-feedback MPC: a moving-horizon estimator closes the loop.

Counterpart of ``examples/output_feedback.py``.  The four-tank plant
exposes only noisy measurements of the two lower tank levels; the upper
levels are never measured.  A moving-horizon estimator (``MHE``, on the
controller's AL-SQP/Riccati solver) reconstructs the full state each
step, and the MPC regulates from the estimate.

Self-checks at the end: the unmeasured upper-tank estimation error
settles well below the measurement noise scale, the closed-loop cost
under estimated-state feedback lands close to the (unrealizable)
true-state-feedback run's, and ``simulate_output_feedback``, the same
stack as one simulation call, settles too.  Writes
``output_feedback.png``.

Usage: python3 -m gpmpc_tpu_torch.examples.output_feedback [--quick] [--cpu]
"""

import numpy as np
import torch

from gpmpc_tpu_torch import MHE, MPC, Model, simulate_output_feedback
from gpmpc_tpu_torch.examples._common import (clock, device_dtype, draw,
                                              generator, run_cli)
from gpmpc_tpu_torch.systems import four_tank_ode
from gpmpc_tpu_torch.utils.plotting import pyplot

DT = 3.0
PROC_Q = np.diag([1e-4] * 4)
#: lower tanks only, with ~0.05 m level noise
C_MEAS = np.array([[1.0, 0.0, 0.0, 0.0],
                   [0.0, 1.0, 0.0, 0.0]])
R_MEAS = np.diag([2.5e-3, 2.5e-3])
X_SP = np.array([12.4, 12.7, 1.8, 1.4])
X0_TRUE = np.array([8.0, 9.0, 2.2, 1.7])
X0_PRIOR = np.array([8.0, 9.0, 1.0, 1.0])     # upper tanks unknown
Q_W = np.diag([20.0, 20.0, 0.1, 0.1])


def build(quick, device, dtype):
    """The plant model, the estimator (window 6 or 10, al2 x mi20) and the
    controller (horizon 5 or 15 steps, ME on the RK4 model, the default
    solver budget)."""
    model = Model(Nx=4, Nu=2, ode=four_tank_ode, dt=DT, R=PROC_Q,
                  clip_negative=True, integrator_substeps=10, device=device,
                  dtype=dtype)
    c = torch.as_tensor(C_MEAS, dtype=dtype, device=device)
    mhe = MHE(model, window=6 if quick else 10, Q_noise=PROC_Q,
              R_meas=R_MEAS, P_arrival=np.diag([0.5] * 4),
              h=lambda x: c @ x, xlb=[0.05] * 4, xub=[25.0] * 4,
              discrete_method="rk4",
              solver_opts=dict(al_iters=2, max_iters=20))
    mpc = MPC(horizon=(5 if quick else 15) * DT, model=model, gp=None,
              gp_method="ME", discrete_method="rk4", Q=Q_W,
              R=0.05 * np.eye(2), ulb=[0.0, 0.0], uub=[8.0, 8.0],
              xlb=[0.1, 0.1, 0.05, 0.05], xub=[16.0, 16.0, 8.0, 8.0],
              feedback=False, percentile=None, cov_updates=1, device=device)
    return model, mhe, mpc


def closed_loop(model, mhe, mpc, n_steps, rng, feed_estimate):
    """One closed loop from the host, the measurements and the process
    noise drawn from the numpy ``rng``; the MPC is fed the MHE estimate or
    (the unrealizable baseline) the true plant state.  Returns the cost,
    the per-step estimation errors (n_steps, 4), the final state and the
    wall seconds."""
    dev, dt = model.device, model.dtype
    x_true = X0_TRUE.copy()
    y0 = C_MEAS @ x_true + rng.multivariate_normal(np.zeros(2), R_MEAS)
    est = mhe.init_filter(X0_PRIOR, y0)
    x_hat = X0_PRIOR
    warm, u_prev = None, None
    cost, est_err = 0.0, []
    t0 = clock(dev)
    for _ in range(n_steps):
        x_feed = x_hat if feed_estimate else x_true
        u0, warm, _, _ = mpc.solve_step(x_feed, X_SP, warm=warm,
                                        u_prev=u_prev)
        u_prev = u0
        cost += float((x_true - X_SP) @ Q_W @ (x_true - X_SP))
        w = rng.multivariate_normal(np.zeros(4), PROC_Q)
        x_true = model.integrate(torch.as_tensor(x_true, dtype=dt,
                                                 device=dev), u0)
        x_true = np.maximum(x_true.cpu().numpy() + w, 1e-3)
        y = C_MEAS @ x_true + rng.multivariate_normal(np.zeros(2), R_MEAS)
        est, x_hat = mhe.step(est, torch.as_tensor(y, dtype=dt, device=dev),
                              u0)
        x_hat = x_hat.cpu().numpy()
        est_err.append(np.abs(x_hat - x_true))
    return cost, np.stack(est_err), x_true, clock(dev) - t0


def fused(mhe, mpc, n_steps):
    """``simulate_output_feedback`` over the same steps (noise from seed
    2), once to warm up and once timed; returns the result and its wall
    seconds."""
    def sim():
        return simulate_output_feedback(mpc, mhe, X0_TRUE, X0_PRIOR,
                                        n_steps * DT, X_SP,
                                        generator=generator(mpc.device, 2))

    sim()
    t0 = clock(mpc.device)
    res = sim()
    return res, clock(mpc.device) - t0


def plot_errors(est_err, filename="output_feedback.png"):
    """The estimation error per step, unmeasured and measured tanks."""
    plt = pyplot()
    fig, ax = plt.subplots(1, 1, figsize=(7, 3.2))
    steps = np.arange(est_err.shape[0])
    ax.plot(steps, est_err[:, 2], label="|err| h3 (unmeasured)")
    ax.plot(steps, est_err[:, 3], label="|err| h4 (unmeasured)")
    ax.plot(steps, est_err[:, 0], "--", alpha=0.6,
            label="|err| h1 (measured)")
    ax.set_xlabel("control step")
    ax.set_ylabel("estimation error [m]")
    ax.legend()
    ax.set_title("MHE estimation error in closed loop")
    fig.tight_layout()
    fig.savefig(filename, dpi=110)
    plt.close(fig)


def main(quick=False, device=None):
    device, dtype = device_dtype(device)
    model, mhe, mpc = build(quick, device, dtype)
    n_steps = 12 if quick else 30
    rng = np.random.default_rng(0)
    cost_est, est_err, x_final, wall = closed_loop(model, mhe, mpc, n_steps,
                                                   rng, feed_estimate=True)
    cost_true, _, _, _ = closed_loop(model, mhe, mpc, n_steps, rng,
                                     feed_estimate=False)
    tail = est_err[n_steps // 2:]
    print(f"output-feedback GP-MPC: wall={wall:.2f}s "
          f"({1e3 * wall / n_steps:.1f} ms/step)")
    print(f"  final levels {np.round(x_final, 2)} (setpoint "
          f"{np.round(X_SP, 2)})")
    print(f"  unmeasured upper-tank |err| (settled): "
          f"max={tail[:, 2:].max():.3f} mean={tail[:, 2:].mean():.3f}")
    print(f"  closed-loop cost: estimate-fed={cost_est:.1f}  "
          f"true-state-fed={cost_true:.1f}  "
          f"ratio={cost_est / cost_true:.3f}")
    assert np.all(np.isfinite(est_err))
    assert tail[:, 2:].max() < 0.5, "upper-tank estimates did not settle"
    assert cost_est < 1.5 * cost_true, "estimate feedback cost blew up"

    res, wall_fused = fused(mhe, mpc, n_steps)
    e_fused = np.abs(res.x_hat - res.x_true[:-1])[n_steps // 2:, 2:]
    print(f"simulate_output_feedback: {1e3 * wall_fused / n_steps:.1f} "
          f"ms/step warm (vs {1e3 * wall / n_steps:.1f} host-composed); "
          f"settled upper-tank |err| mean={e_fused.mean():.3f}")
    assert np.all(np.isfinite(res.x_true))
    assert e_fused.max() < 0.5
    if draw(plot_errors, est_err):
        print("plot written: output_feedback.png")
    return dict(wall=wall, ms_per_step=1e3 * wall / n_steps,
                fused_ms_per_step=1e3 * wall_fused / n_steps,
                settled_err_max=float(tail[:, 2:].max()),
                cost_ratio=cost_est / cost_true,
                fused_err_max=float(e_fused.max()))


if __name__ == "__main__":
    run_cli(main, __doc__)
