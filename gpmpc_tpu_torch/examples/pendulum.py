"""Torque-limited pendulum swing-up with the saturating cost.

Counterpart of ``examples/pendulum.py``.  A pendulum with gravity torque
m g l = 9.81 N m and an actuator limited to |u| <= 5 N m cannot be lifted
quasi-statically: the controller must pump energy and swing through.  The
expected saturating cost E[1 - exp(-1/2 ||x - x_sp||^2_W)] (PILCO's cost)
saturates to ~1 far from the target, so the optimizer heads for the basin
instead of fighting a distant quadratic.

The dynamics are learned: a GP on the one-step residual between a coarse
RK4 map and the true plant (``discrete_method='hybrid'``), trained from
random transitions; no pendulum parameter reaches the controller.  The
script checks itself (the inputs within their limit, the pendulum upright
at the end) and writes ``pendulum_states.png``.

Usage: python3 -m gpmpc_tpu_torch.examples.pendulum [--quick] [--cpu]
"""

import time

import numpy as np
import torch
from torch.func import vmap

from gpmpc_tpu_torch import GP, MPC, Model
from gpmpc_tpu_torch.examples._common import (device_dtype, draw, generator,
                                              run_cli)

DT = 0.1
U_MAX = 5.0
X_LB = np.array([-2.0 * np.pi, -9.0])
X_UB = np.array([2.0 * np.pi, 9.0])
X0 = np.array([0.0, 0.0])               # hanging at rest
X_SP = np.array([np.pi, 0.0])           # upright


def pendulum_ode(x, u, m=1.0, l=1.0, b=0.10, g=9.81):
    """theta'' = (u - b w - m g l sin(theta)) / (m l^2); theta = 0 hanging,
    theta = pi upright."""
    th, w = x[0], x[1]
    return torch.stack([w, (u[0] - b * w - m * g * l * torch.sin(th))
                        / (m * l * l)])


def build_model(device, dtype):
    return Model(Nx=2, Nu=1, ode=pendulum_ode, dt=DT,
                 R=np.diag([1e-6, 1e-5]), integrator_substeps=10,
                 device=device, dtype=dtype)


def training_data(model, quick):
    """60 (quick) or 120 uniform transitions over the swing envelope (seed
    7): inputs Z = (x, u) and the residuals integrate - rk4."""
    g = generator(model.device, 7)
    kw = dict(dtype=model.dtype, device=model.device)
    n = 60 if quick else 120
    lo, hi = (torch.as_tensor(v, **kw) for v in (X_LB, X_UB))
    x_s = lo + (hi - lo) * torch.rand((n, 2), generator=g, **kw)
    u_s = U_MAX * (2.0 * torch.rand((n, 1), generator=g, **kw) - 1.0)
    resid = vmap(model.integrate)(x_s, u_s) - vmap(model.rk4)(x_s, u_s)
    return torch.cat([x_s, u_s], dim=1), resid


def fit(Z, resid):
    return GP(Z, resid, mean_func="zero", gp_method="TA", multistart=2,
              max_iters=150, seed=5, device=Z.device, dtype=Z.dtype)


def build_mpc(model, gp, quick):
    """The sat-cost hybrid controller: horizon 20 (quick) or 25 steps, no
    tightening, al2 x mi8."""
    return MPC(horizon=(20 if quick else 25) * DT, model=model, gp=gp,
               gp_method="TA", discrete_method="hybrid", costFunc="sat",
               # sat-cost width: ~1 rad / ~2 rad/s basin
               Q=np.diag([1.0, 0.25]), P=np.diag([2.0, 0.5]),
               R=1e-3 * np.eye(1), ulb=[-U_MAX], uub=[U_MAX],
               percentile=None, feedback=False,
               solver_opts=dict(al_iters=2, max_iters=8), cov_updates=1,
               device=model.device)


def swing_up(mpc, quick):
    """The closed loop from hanging at rest, 45 (quick) or 60 steps,
    without noise; returns its readings."""
    t0 = time.perf_counter()
    xs, us = mpc.solve(x0=X0, sim_time=(45 if quick else 60) * DT,
                       x_sp=X_SP, noise=False)
    wall = time.perf_counter() - t0
    xs, us = xs.cpu().numpy(), us.cpu().numpy()
    final_err = abs(((xs[-1, 0] - np.pi) + np.pi) % (2 * np.pi) - np.pi)
    return dict(wall=wall,
                ms_per_step=1e3 * mpc.last_run["wall_time_per_step"],
                final_theta=float(xs[-1, 0]), final_err=float(final_err),
                max_abs_u=float(np.abs(us).max()))


def main(quick=False, device=None):
    device, dtype = device_dtype(device)
    model = build_model(device, dtype)
    gp = fit(*training_data(model, quick))
    mpc = build_mpc(model, gp, quick)
    r = swing_up(mpc, quick)
    print(f"pendulum sat-cost swing-up: wall={r['wall']:.2f}s "
          f"({r['ms_per_step']:.1f} ms/step) final "
          f"theta={r['final_theta']:.3f} (target pi={np.pi:.3f}) "
          f"|angle err|={r['final_err']:.3f} rad  "
          f"max|u|={r['max_abs_u']:.2f} (limit {U_MAX})")
    assert r["max_abs_u"] <= U_MAX + 1e-6
    # upright (quick mode is still settling at the end of its shorter
    # run, hence the looser bound)
    assert r["final_err"] < (0.35 if quick else 0.1), \
        f"swing-up failed: |angle err|={r['final_err']:.3f} rad"
    if draw(mpc.plot, filename="pendulum_states.png"):
        print("plot written: pendulum_states.png")
    return dict(r, n_evals=gp.n_evals)


if __name__ == "__main__":
    run_cli(main, __doc__)
