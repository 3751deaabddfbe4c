"""MPC on a semi-explicit index-1 DAE plant.

Counterpart of ``examples/dae_network.py``.  Two tanks coupled through a
junction node whose head z is not a state: the flow balance at the node
determines it algebraically,

    inflow from tank 1:   q1  = c1 sqrt(h1 - z)
    outflow to tank 2:    q12 = c2 sqrt(z - h2)
    leak to ambient:      qL  = c3 sqrt(z)
    node balance:         0   = q1 - q12 - qL          (solves for z)

    h1' = (u - q1) / A1,      h2' = (q12 - c4 sqrt(h2)) / A2

``Model(alg=...)`` eliminates z pointwise by Newton steps, and
derivatives pass through it, so the same reduced ODE serves the plant
integrator, the RK4 map in the MPC's NLP and its linearizations.  The
controller tracks a level on tank 2 through the junction, with input and
level boxes.  Self-checks: the loop reaches the setpoint and the
algebraic residual along the realized trajectory stays at Newton
tolerance.  Writes ``dae_network.png``.

Usage: python3 -m gpmpc_tpu_torch.examples.dae_network [--quick] [--cpu]
"""

import time

import numpy as np
import torch

from gpmpc_tpu_torch import MPC, Model
from gpmpc_tpu_torch.examples._common import device_dtype, draw, run_cli
from gpmpc_tpu_torch.utils.plotting import pyplot

A1, A2 = 2.0, 3.0
C1, C2, C3, C4 = 1.2, 1.0, 0.25, 0.6
DT = 2.0
X0 = np.array([6.0, 1.0])
X_SP = np.array([5.0, 2.5])        # track tank 2's level through the node


def _sq(x):
    """sqrt clamped at a small positive floor: flows vanish smoothly as
    heads equalize, and the Newton iteration and derivatives stay
    defined."""
    return torch.sqrt(torch.clamp(x, min=1e-9))


def dae_ode(x, z, u):
    h1, h2, zh = x[0], x[1], z[0]
    q1 = C1 * _sq(h1 - zh)
    q12 = C2 * _sq(zh - h2)
    return torch.stack([(u[0] - q1) / A1, (q12 - C4 * _sq(h2)) / A2])


def dae_alg(x, z, u):
    h1, h2, zh = x[0], x[1], z[0]
    return torch.stack([C1 * _sq(h1 - zh) - C2 * _sq(zh - h2)
                        - C3 * _sq(zh)])


def build_model(device, dtype):
    return Model(Nx=2, Nu=1, ode=dae_ode, alg=dae_alg, Nz=1,
                 z_guess=lambda x, u: 0.5 * (x[:1] + x[1:]),
                 alg_newton_iters=12, dt=DT, R=np.diag([1e-5, 1e-5]),
                 clip_negative=True, integrator_substeps=20, device=device,
                 dtype=dtype)


def build_mpc(model):
    """RK4 on the reduced ODE, horizon 6 steps, the default solver
    budget."""
    return MPC(horizon=6 * DT, model=model, gp=None, discrete_method="rk4",
               Q=np.diag([0.05, 10.0]), R=0.05 * np.eye(1), ulb=[0.0],
               uub=[4.0], xlb=[0.2, 0.2], xub=[12.0, 8.0], feedback=False,
               percentile=None, cov_updates=1, device=model.device)


def alg_residuals(model, xs, us):
    """The junction heads z and the node balance's |residual| at every
    realized (x, u) of the loop."""
    kw = dict(dtype=model.dtype, device=model.device)
    zs, res = [], []
    for k in range(len(us)):
        xk, uk = (torch.as_tensor(v, **kw) for v in (xs[k], us[k]))
        zk = model.solve_alg(xk, uk)
        zs.append(float(zk[0]))
        res.append(abs(float(dae_alg(xk, zk, uk)[0])))
    return np.array(zs), np.array(res)


def plot_network(xs, zs, filename="dae_network.png"):
    """The two levels and the algebraic junction head."""
    plt = pyplot()
    t = np.arange(xs.shape[0]) * DT
    fig, axes = plt.subplots(3, 1, sharex=True, figsize=(8, 6))
    axes[0].plot(t, xs[:, 0], label="h1")
    axes[0].set_ylabel("h1")
    axes[1].plot(t, xs[:, 1], label="h2")
    axes[1].axhline(X_SP[1], ls=":", c="g")
    axes[1].set_ylabel("h2 (controlled)")
    axes[2].plot(t[:-1], zs, c="tab:orange")
    axes[2].set_ylabel("junction head z (algebraic)")
    axes[2].set_xlabel("time [s]")
    fig.suptitle("MPC on an index-1 DAE plant (algebraic junction node)")
    fig.tight_layout()
    fig.savefig(filename, dpi=120)
    plt.close(fig)


def main(quick=False, device=None):
    device, dtype = device_dtype(device)
    model = build_model(device, dtype)
    mpc = build_mpc(model)
    n_steps = 12 if quick else 30
    t0 = time.perf_counter()
    xs, us = mpc.solve(x0=X0, sim_time=n_steps * DT, x_sp=X_SP, noise=False)
    wall = time.perf_counter() - t0
    xs, us = xs.cpu().numpy(), us.cpu().numpy()
    err = abs(float(xs[-1, 1]) - X_SP[1])
    zs, res = alg_residuals(model, xs, us)
    print(f"DAE network MPC: wall={wall:.1f}s  final h2={xs[-1, 1]:.3f} "
          f"(setpoint {X_SP[1]})  |err|={err:.4f}  "
          f"max alg residual={res.max():.2e}")
    assert np.all(np.isfinite(xs))
    assert err < 0.05, "did not reach the tank-2 setpoint"
    assert res.max() < 1e-6, "algebraic node balance violated"
    if draw(plot_network, xs, zs):
        print("plot written: dae_network.png")
    return dict(wall=wall, ms_per_step=1e3 * mpc.last_run[
        "wall_time_per_step"], final_err=err,
        max_alg_residual=float(res.max()))


if __name__ == "__main__":
    run_cli(main, __doc__)
