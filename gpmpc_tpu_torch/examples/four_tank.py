"""Four-tank GP-MPC walkthrough: the library's flagship example.

Counterpart of ``examples/four_tank.py``.  The API sequence

    Model -> generate_training_data -> GP -> MPC -> solve -> plot

with mean-equivalent propagation (ME) and box constraints, then the
chance-constrained schemes with feedback: first-order Taylor (TA), the
unscented transform (UT), exact moment matching (EM) and tensor
Gauss-Hermite quadrature (GH).  Each closed loop prints its steps, wall
time, closed-loop cost, converged solves and largest defect, and writes
``four_tank_{me,ta,ut,em,gh}.png``.

Usage: python3 -m gpmpc_tpu_torch.examples.four_tank [--quick] [--cpu]
"""

import time

import numpy as np

from gpmpc_tpu_torch import GP, MPC, Model
from gpmpc_tpu_torch.examples._common import (device_dtype, draw, generator,
                                              run_cli)
from gpmpc_tpu_torch.systems import four_tank_ode

DT = 3.0
BOUNDS = dict(uub=[6.0, 6.0], ulb=[0.0, 0.0], xub=[20.0, 20.0, 6.0, 6.0],
              xlb=[1.0, 1.0, 0.5, 0.5])
X0 = np.array([8.0, 10.0, 1.0, 1.5])
X_SP = np.array([14.0, 14.0, 1.8, 1.4])
Q = np.diag([20.0, 20.0, 0.1, 0.1])
#: (gp_method, percentile) of each closed loop, in the JAX example's order:
#: UT sits between TA and EM in accuracy and cost; GH is the kernel-generic
#: full-covariance scheme (EM's exact SE answer as its order grows)
METHODS = (("ME", None), ("TA", 0.95), ("UT", 0.95), ("EM", 0.95),
           ("GH", 0.95))


def build_model(device, dtype):
    return Model(Nx=4, Nu=2, ode=four_tank_ode, dt=DT,
                 R=np.diag([1e-3] * 4), clip_negative=True,
                 integrator_substeps=10, device=device, dtype=dtype)


def training_data(model, quick):
    """The noisy training set (40 or 100 transitions; seed 2) and 100
    noise-free held-out points (seed 9)."""
    X, Y = model.generate_training_data(
        40 if quick else 100, **BOUNDS, generator=generator(model.device, 2))
    Xt, Yt = model.generate_training_data(
        100, **BOUNDS, noise=False, generator=generator(model.device, 9))
    return X, Y, Xt, Yt


def fit(X, Y, device, dtype):
    """The example's GP: zero mean, 2 starts, 200 L-BFGS iterations."""
    return GP(X, Y, mean_func="zero", gp_method="TA", multistart=2,
              max_iters=200, seed=1, device=device, dtype=dtype)


def build_mpc(model, gp, gp_method, percentile, quick):
    """One controller: horizon 5 (quick) or 20 steps, feedback whenever the
    constraints are tightened, the default solver budget."""
    return MPC(horizon=(5 if quick else 20) * DT, model=model, gp=gp,
               Q=Q, R=0.05 * np.eye(2), ulb=[0.0, 0.0], uub=[8.0, 8.0],
               xlb=[0.5, 0.5, 0.1, 0.1], xub=[16.0, 16.0, 8.0, 8.0],
               discrete_method="gp", gp_method=gp_method,
               percentile=percentile, feedback=percentile is not None,
               device=model.device)


def closed_loop(mpc, quick, noise=True):
    """One closed loop of 10 (quick) or 30 steps from X0 (process noise
    from seed 0 unless ``noise`` is off); returns its readings."""
    t0 = time.perf_counter()
    xs, us = mpc.solve(x0=X0, sim_time=(10 if quick else 30) * DT,
                       x_sp=X_SP, noise=noise,
                       generator=generator(mpc.device, 0))
    wall = time.perf_counter() - t0
    r = mpc.last_run
    xs = xs.cpu().numpy()
    return dict(steps=int(us.shape[0]), wall=wall,
                ms_per_step=1e3 * r["wall_time_per_step"],
                cost=float(np.sum((xs[:-1] - X_SP) ** 2 @ Q)),
                converged=int(r["converged"].sum()),
                max_defect=float(r["defect"].max()),
                finite=bool(np.isfinite(xs).all()))


def report(gp_method, c):
    print(f"[{gp_method:>2}] steps={c['steps']} wall={c['wall']:.2f}s "
          f"({c['ms_per_step']:.1f} ms/step) closed-loop "
          f"cost={c['cost']:.1f} converged={c['converged']}/{c['steps']} "
          f"max defect={c['max_defect']:.2e}")


def main(quick=False, device=None):
    device, dtype = device_dtype(device)
    model = build_model(device, dtype)
    X, Y, Xt, Yt = training_data(model, quick)
    t0 = time.perf_counter()
    gp = fit(X, Y, device, dtype)
    print(f"GP training ({X.shape[0]} pts, 4 dims, 2 starts): "
          f"{time.perf_counter() - t0:.2f}s")
    gp.print_hyper_parameters()
    print("validation (held-out):")
    readings = dict(smse=gp.validate(Xt, Yt)[0].tolist(), n_evals=gp.n_evals)
    drawn = True
    for gp_method, percentile in METHODS:
        mpc = build_mpc(model, gp, gp_method, percentile, quick)
        c = closed_loop(mpc, quick)
        report(gp_method, c)
        readings[gp_method] = c
        assert c["finite"], f"[{gp_method}] non-finite closed loop"
        drawn = draw(mpc.plot, filename=f"four_tank_{gp_method.lower()}.png")
    if drawn:
        print("plots written: four_tank_{me,ta,ut,em,gh}.png")
    return readings


if __name__ == "__main__":
    run_cli(main, __doc__)
