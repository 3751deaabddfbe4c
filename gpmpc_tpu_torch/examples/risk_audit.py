"""Empirical chance-constraint audit.

Counterpart of ``examples/risk_audit.py``.  Chance-constrained MPC
tightens the state bounds by Phi^{-1}(percentile) sqrt(diag Sigma); this
walkthrough checks what that buys on the realized closed loop.
``MPC.solve_mc`` runs a Monte-Carlo ensemble of noisy closed loops as one
batch of lanes, and ``utils.calibration.chance_calibration`` compares the
realized violation frequency of the original bounds against the design
risk alpha = 1 - percentile.

The tank-1 upper bound sits within one noise sigma of the setpoint.  The
untightened controller drives straight to the setpoint and rides the
bound, crossing it on a large fraction of steps; the percentile = 0.95
controller backs off by the propagated-uncertainty margin and keeps the
realized risk near the design's 5%.  Self-checks: the tightened ensemble
audits as calibrated, the untightened one rides into violation.  Writes
``risk_audit.png``.

Usage: python3 -m gpmpc_tpu_torch.examples.risk_audit [--quick] [--cpu]
"""

import numpy as np

from gpmpc_tpu_torch import MPC, Model
from gpmpc_tpu_torch.examples._common import (clock, device_dtype, draw,
                                              generator, run_cli)
from gpmpc_tpu_torch.systems import four_tank_ode
from gpmpc_tpu_torch.utils.calibration import (chance_calibration,
                                               violation_rates)
from gpmpc_tpu_torch.utils.plotting import pyplot

DT = 3.0
X0 = np.array([8.0, 9.0, 1.0, 1.0])
X_SP = np.array([12.4, 12.7, 1.8, 1.4])
#: the tank-1 bound, less than one noise sigma above the setpoint (the
#: plant noise std on each tank is sqrt(1e-3) ~ 0.032)
H1_UB = float(X_SP[0]) + 0.02


def build_model(device, dtype):
    return Model(Nx=4, Nu=2, ode=four_tank_ode, dt=DT,
                 R=np.diag([1e-3] * 4), clip_negative=True,
                 integrator_substeps=10, device=device, dtype=dtype)


def build_mpc(model, percentile):
    """ME on the RK4 model, horizon 5 steps, the default solver budget;
    tightened at ``percentile`` or untightened (None)."""
    return MPC(horizon=5 * DT, model=model, gp=None, discrete_method="rk4",
               gp_method="ME", Q=np.diag([10.0, 10.0, 0.1, 0.1]),
               R=0.01 * np.eye(2), ulb=[0.0, 0.0], uub=[8.0, 8.0],
               xlb=[0.5, 0.5, 0.1, 0.1], xub=[H1_UB, 25.0, 8.0, 8.0],
               feedback=False, cov_updates=1, percentile=percentile,
               device=model.device)


def audit(model, n_mc, n_steps):
    """The tightened controller's calibration report and ensemble, and
    the untightened ensemble with its violation rates (both on the noise
    of seed 5); returns ``(report, xs_tight, xs_plain, rate_plain,
    worst_plain, wall)``."""
    t0 = clock(model.device)
    tight = build_mpc(model, 0.95)
    report = chance_calibration(tight, X0, n_steps * DT, X_SP, n_mc=n_mc,
                                generator=generator(model.device, 5))
    xs_tight = tight.last_mc["x_sim"]
    plain = build_mpc(model, None)
    xs_plain, _ = plain.solve_mc(X0, n_steps * DT, X_SP, n_mc,
                                 generator=generator(model.device, 5))
    xs_plain = xs_plain.cpu().numpy()
    rate, worst, _ = violation_rates(xs_plain, plain.xlb.cpu().numpy(),
                                     plain.xub.cpu().numpy())
    return report, xs_tight, xs_plain, rate, worst, clock(model.device) - t0


def plot_bands(xs_tight, xs_plain, filename="risk_audit.png"):
    """Tank 1's 5-95% band and median of each ensemble by the bound."""
    plt = pyplot()
    t = np.arange(xs_tight.shape[1]) * DT
    fig, ax = plt.subplots(figsize=(8, 4))
    for xs, color, name in ((xs_plain, "tab:red", "untightened"),
                            (xs_tight, "tab:blue", "tightened (p=0.95)")):
        lo, med, hi = np.percentile(xs[:, :, 0], [5, 50, 95], axis=0)
        ax.fill_between(t, lo, hi, color=color, alpha=0.18, lw=0)
        ax.plot(t, med, c=color, lw=2, label=f"{name} median (5-95% band)")
    ax.axhline(H1_UB, ls="--", c="k", lw=1.2, label="state bound")
    ax.axhline(X_SP[0], ls=":", c="g", lw=0.9, label="setpoint")
    ax.set_xlabel("time [s]")
    ax.set_ylabel("h1 [cm]")
    # the story is the last 0.2 cm below the bound (the rise is cut off)
    ax.set_ylim(X_SP[0] - 0.2, H1_UB + 0.08)
    ax.legend(loc="lower right", fontsize=8)
    fig.suptitle("Chance-constraint audit: realized tank-1 ensembles")
    fig.tight_layout()
    fig.savefig(filename, dpi=120)
    plt.close(fig)


def main(quick=False, device=None):
    device, dtype = device_dtype(device)
    model = build_model(device, dtype)
    n_mc = 24 if quick else 64
    n_steps = 12 if quick else 20
    report, xs_tight, xs_plain, rate_p, worst_p, wall = audit(model, n_mc,
                                                              n_steps)
    alpha, bound = report["alpha"], report["bound"]
    print(f"ensemble: {n_mc} noisy closed loops x {n_steps} steps "
          f"(one batch of lanes each), wall={wall:.1f}s")
    print(f"design risk alpha = {alpha:.3f}  (percentile=0.95); audit "
          f"bound = alpha + 3 SE = {bound:.3f}")
    print(f"tightened   : h1 violation rate={report['rate'][0]:.4f}  "
          f"worst step={report['worst_step_rate'][0]:.3f}  "
          f"calibrated={report['calibrated']}")
    print(f"untightened : h1 violation rate={rate_p[0]:.4f}  "
          f"worst step={worst_p[0]:.3f}")
    assert report["calibrated"], "tightened controller failed its audit"
    assert worst_p[0] > 3 * alpha, "untightened controller should ride the " \
        "bound into violation in this scenario"
    if draw(plot_bands, xs_tight, xs_plain):
        print("plot written: risk_audit.png")
    return dict(wall=wall, ms_per_step=1e3 * wall / (2 * n_steps),
                rate_tight=float(report["rate"][0]),
                calibrated=report["calibrated"],
                rate_plain=float(rate_p[0]), worst_plain=float(worst_p[0]))


if __name__ == "__main__":
    run_cli(main, __doc__)
