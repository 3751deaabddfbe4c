"""Output-feedback GP-MPC: estimator + controller + plant in one loop.

Counterpart of ``gpmpc_tpu/mpc/output_feedback.py``.  Per control period:
measure ``y = h(x) + v``, slide the MHE window and solve the estimation
NLP (:class:`gpmpc_tpu_torch.mpc.mhe.MHE`), solve the MPC NLP from the
estimate, apply the saturated input to the plant with process noise
``w``.  The JAX package runs the whole simulation as one ``lax.scan``;
here it is a Python loop over steps that calls ``mhe._step`` and
``mpc._solve_step`` and reads nothing on the host until it ends (the
solve flags stay tensors), so on the card the host only enqueues.

For a real plant, where the measurement arrives from hardware, compose
``mhe.step`` and ``mpc.solve_step`` per step instead;
:func:`simulate_output_feedback` is the simulation counterpart, for when
the plant is the model itself.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class OutputFeedbackResult(NamedTuple):
    """Realized closed loop under estimated-state feedback (numpy)."""

    x_true: np.ndarray            # (M+1, Nx) plant states
    x_hat: np.ndarray             # (M, Nx) MHE estimates the MPC acted on
    u: np.ndarray                 # (M, Nu) applied inputs
    y: np.ndarray                 # (M, Nm) measurements
    mpc_converged: np.ndarray     # (M,) controller solve status
    mhe_converged: np.ndarray     # (M,) estimator solve status


def simulate_output_feedback(mpc, mhe, x0, x_bar, sim_time, x_sp,
                             generator: Optional[torch.Generator] = None,
                             noise: bool = True,
                             con_par_func=None,
                             noise_w=None, noise_v=None
                             ) -> OutputFeedbackResult:
    """Simulate the output-feedback stack: ``x0`` is the TRUE initial plant
    state, ``x_bar`` the estimator's prior on it.

    ``noise_w (M, Nx)`` / ``noise_v (M, Nm)`` override the process /
    measurement noise draws (so one draw can feed both packages); by
    default they are drawn from ``generator`` (default: one on the
    controller's device seeded with 0), ``w`` through the Cholesky factor
    of ``mpc.model.R`` and then ``v`` through that of the estimator's
    ``R_meas``, and zeroed when ``noise=False``.  The adaptive controller
    (``MPC(online_capacity=...)``) is not supported: its conditioning
    consumes the TRUE transition, which output feedback does not see."""
    if mpc.online_capacity is not None:
        raise ValueError("simulate_output_feedback does not support "
                         "MPC(online_capacity=...) — online conditioning "
                         "needs true-state observations")
    if mpc.dtype != mhe.dtype:
        raise ValueError(f"mpc dtype {mpc.dtype} != mhe dtype {mhe.dtype}")
    if mhe.Nu != mpc.Nu or mhe.Nx != mpc.Nx:
        raise ValueError("mpc and mhe disagree on state/input dimensions")
    if mhe.device != mpc.device:
        raise ValueError(f"the mhe lives on {mhe.device}, the mpc on "
                         f"{mpc.device}")

    n_steps = int(round(sim_time / mpc.dt))
    kw = dict(dtype=mpc.dtype, device=mpc.device)
    x0 = mpc._tensor(x0)
    x_bar = mpc._tensor(x_bar)
    ref_windows = mpc._prep_ref_windows(x_sp, n_steps)
    con_pars = mpc._prep_con_pars(con_par_func, n_steps)

    if generator is None:
        generator = torch.Generator(device=mpc.device).manual_seed(0)
    if noise_w is None:
        noise_w = (torch.randn((n_steps, mpc.Nx), generator=generator, **kw)
                   @ mpc._noise_chol().T) if noise else \
            torch.zeros((n_steps, mpc.Nx), **kw)
    else:
        noise_w = mpc._tensor(noise_w)
    if noise_v is None:
        chol_v = torch.linalg.cholesky(
            mhe._r_mat + 1e-32 * torch.eye(mhe.Nm, **kw))
        noise_v = (torch.randn((n_steps, mhe.Nm), generator=generator, **kw)
                   @ chol_v.T) if noise else \
            torch.zeros((n_steps, mhe.Nm), **kw)
    else:
        noise_v = mpc._tensor(noise_v)

    # the estimator starts at the prior with the first measurement (the
    # loop re-feeds y_0 with u_prev = 0: MHE.run's fill-in semantics)
    est = mhe.init_filter(x_bar, mhe.h(x0) + noise_v[0])
    u_prev = torch.zeros(mpc.Nu, **kw)
    warm = mpc._init_warm(mpc._augment_x0(x_bar, u_prev), ref_windows[0])
    sigma0 = torch.zeros((mpc.Nx, mpc.Nx), **kw)

    # cold-start preconditioning, as in MPC.solve: one full-budget solve so
    # the in-loop (possibly RTI-grade) budget only tracks
    if mpc.init_sqp_cfg != mpc.sqp_cfg:
        con_par0 = (con_pars[0] if con_pars.shape[0] else
                    torch.zeros(mpc.num_con_par, **kw))
        warm = mpc._solve_step(warm, est.x_bar, ref_windows[0], u_prev,
                               sigma0, con_par0, mpc.consts,
                               cfg=mpc.init_sqp_cfg)[0]

    x = x0
    outs = []
    for k in range(n_steps):
        y = mhe.h(x) + noise_v[k]
        est, (x_hat, mhe_res) = mhe._step(est, y, u_prev)
        warm, u_cmd, _, info = mpc._solve_step(
            warm, x_hat, ref_windows[k], u_prev, sigma0, con_pars[k],
            mpc.consts)
        u_cmd = mpc._saturate(u_cmd, u_prev, mpc.consts)
        x_next = mpc.model.integrate(x, u_cmd) + noise_w[k]
        if mpc.model.clip_negative:
            x_next = torch.clamp(x_next, min=0.0)
        outs.append((x, x_hat, u_cmd, y, info.converged, mhe_res.converged))
        x, u_prev = x_next, u_cmd
    xs, x_hats, us, ys, mpc_conv, mhe_conv = (torch.stack(v)
                                              for v in zip(*outs))
    xs = torch.cat([xs, x[None]], dim=0)
    return OutputFeedbackResult(*(v.cpu().numpy() for v in (
        xs, x_hats, us, ys, mpc_conv, mhe_conv)))
