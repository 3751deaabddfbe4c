"""Empirical chance-constraint calibration audit.

The port's own copy of ``gpmpc_tpu/utils/calibration.py`` (numpy only; the
JAX package's module cannot be imported without JAX).  Same ``_OFF``
sentinel, the same pooled rate and the same slack rule.

The controller tightens state boxes by ``Phi^{-1}(percentile) *
sqrt(diag Sigma_t)``: a design claim that the realized closed loop
violates each original bound with probability at most ``alpha = 1 -
percentile`` per state per step (up to the Gaussian approximation of the
propagated law and GP model error).  :meth:`MPC.solve_mc` runs the
Monte-Carlo ensemble that audits it.

``chance_calibration`` runs ``n_mc`` noisy closed loops and reports, per
state dimension:

* ``rate``: violation frequency pooled over all lanes and noise-reached
  steps (the deterministic initial state is excluded).  If the per-step
  claim holds at every step, the pooled frequency is <= alpha too, so
  ``rate <= alpha + slack`` is a NECESSARY condition; the ``calibrated``
  flag gates on it.  The slack is ``slack_se`` binomial standard errors of
  ``alpha`` at **n_mc** effective samples: lanes are independent, but
  violations within a lane are strongly autocorrelated (bound-riding
  persists across steps), so counting every (lane, step) sample would
  overstate the precision and flake the gate.
* ``worst_step_rate``: the largest per-step frequency across the horizon,
  the sharper diagnostic, reported for inspection and not gated.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# |bound| at or above this is treated as "no constraint".  Conservative
# against both box sentinels in this package (mpc/controller._BIG = 1e10,
# mpc/mhe._BIG = 1e9); a genuine physical bound this large would be
# misclassified as inactive, but at that magnitude the box cannot bind any
# realizable trajectory anyway.
_OFF = 1e9


def violation_rates(xs, xlb, xub):
    """Per-dimension empirical violation statistics of the box
    ``[xlb, xub]`` over trajectories ``xs (n_mc, T+1, Nx)``.

    The initial state ``xs[:, 0]`` is excluded — it is the deterministic
    start, not a noise-reached state, so it carries no information about
    realized risk.

    Returns ``(rate, worst_step_rate, active)``: pooled frequency (Nx,),
    worst per-step frequency (Nx,), and the mask of dimensions that have a
    finite bound on at least one side.
    """
    xs = np.asarray(xs)[:, 1:]
    xlb = np.asarray(xlb, dtype=xs.dtype)
    xub = np.asarray(xub, dtype=xs.dtype)
    viol = (xs < xlb) | (xs > xub)            # broadcasts over (n_mc, T, Nx)
    active = (xlb > -_OFF) | (xub < _OFF)
    rate = viol.mean(axis=(0, 1))
    worst_step_rate = viol.mean(axis=0).max(axis=0)
    return rate, worst_step_rate, active


def chance_calibration(mpc, x0, sim_time, x_sp, n_mc: int = 128,
                       generator=None, noise_ws=None, con_par_func=None,
                       slack_se: float = 3.0,
                       alpha: Optional[float] = None) -> dict:
    """Audit ``mpc``'s chance-constraint calibration on its own closed loop.

    Runs :meth:`MPC.solve_mc` (``n_mc`` process-noise realizations, the
    normals drawn from ``generator``, or ``noise_ws`` (n_mc, n_steps, Nx)
    when given) and checks every bounded state dimension's POOLED
    violation frequency against ``alpha + slack_se * SE`` where
    ``SE = sqrt(alpha (1-alpha) / n_mc)`` — n_mc independent lanes are the
    effective sample size; see the module docstring for why per-step
    samples are not counted.

    ``alpha`` defaults to ``1 - mpc.percentile``; pass it explicitly to
    audit an untightened controller (``percentile=None``) against a target.
    Returns a dict with per-dimension rates, the bound used, and the
    overall ``calibrated`` flag (dimensions without finite bounds are
    ignored).
    """
    if alpha is None:
        if mpc.percentile is None:
            raise ValueError("controller has no percentile (tightening "
                             "off); pass alpha= to audit against a target")
        alpha = 1.0 - float(mpc.percentile)
    xs, _ = mpc.solve_mc(x0, sim_time, x_sp, n_mc, generator=generator,
                         noise_ws=noise_ws, con_par_func=con_par_func)
    rate, worst, active = violation_rates(
        xs.detach().cpu().numpy(), mpc.xlb.cpu().numpy(),
        mpc.xub.cpu().numpy())
    se = float(np.sqrt(alpha * (1.0 - alpha) / n_mc))
    bound = alpha + slack_se * se
    calibrated = bool(np.all(rate[active] <= bound)) if active.any() \
        else True
    return {
        "alpha": float(alpha),
        "bound": float(bound),
        "n_mc": int(n_mc),
        "rate": rate,
        "worst_step_rate": worst,
        "active": active,
        "calibrated": calibrated,
    }
