"""Typed configuration dataclasses.

The counterpart of ``gpmpc_tpu/utils/config.py``: the same fields and
defaults, so a configuration means the same thing in both packages.  They
are plain frozen dataclasses of hashables and import no framework.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class GPConfig:
    """GP configuration: mean function, kernel family and the numerical
    guards of the posterior (jitter, noise floor).  The training fields
    (multistart, optimizer budget, priors) are kept so configurations move
    between the packages unchanged; this package does not train yet."""

    mean_func: str = "zero"  # zero | const | linear | poly
    kernel: str = "se"
    multistart: int = 2
    max_iters: int = 250
    grad_tol: float = 1e-7
    jitter: float = 1e-8            # Cholesky jitter, scaled by sf2
    min_noise: float = 1e-6         # floor on noise variance (scaled by var(y))
    normalize: bool = True          # z-score inputs/outputs
    predict_includes_noise: bool = False  # add sn2 to predictive variance
    sf2_prior: float = 0.5
    ell_prior: float = 0.5


@dataclasses.dataclass(frozen=True)
class SQPConfig:
    """Augmented-Lagrangian SQP solver configuration (see
    :mod:`gpmpc_tpu_torch.solvers.al_sqp`)."""

    max_iters: int = 30             # inner GN/SQP iterations per AL round
    al_iters: int = 6               # outer multiplier/penalty updates
    penalty_init: float = 10.0
    penalty_mult: float = 10.0
    penalty_max: float = 1e8
    reg_init: float = 1e-6          # Levenberg regularization on Riccati
    reg_mult: float = 10.0
    reg_max: float = 1e8
    tol_stat: float = 1e-8          # inner stop: step norm <= tol_stat*scale
    tol_con: float = 1e-7           # converged: defect & viol <= tol_con*scale
    tol_kkt: float = 1e-5           # converged: relative KKT dual infeas.
    ls_steps: int = 8               # backtracking line-search trials
    ls_beta: float = 0.5
    ls_c1: float = 1e-4
    merit_viol: float = 0.0         # L1 exact-penalty weight on inequality
    #                                 violations in the line-search merit
    parallel_kkt: bool = False      # associative-scan Riccati
    fused_kkt: bool = False         # single-launch Riccati sweep kernel
    #                                 (CUDA on a CUDA tensor, its plain torch
    #                                 version on a CPU tensor); f32 only


#: Named solver budgets, accepted anywhere a ``solver_opts`` dict is.
SOLVER_PRESETS = {
    "rti": dict(al_iters=2, max_iters=12, penalty_init=100.0,
                penalty_mult=30.0, merit_viol=10.0, fused_kkt=True),
    "robust": dict(al_iters=3, max_iters=15, fused_kkt=True),
    "converged": {},
}


def resolve_solver_opts(solver_opts, dtype=None) -> dict:
    """Resolve ``solver_opts`` (None | dict | preset name) to a kwargs dict
    for :class:`SQPConfig`.  Unknown preset names fail loudly.

    With ``dtype`` float64 a preset drops ``fused_kkt`` (the fused sweep
    runs f32); an explicit ``fused_kkt=True`` in a user dict still errors
    on f64 downstream."""
    if solver_opts is None:
        return {}
    if isinstance(solver_opts, str):
        if solver_opts not in SOLVER_PRESETS:
            raise ValueError(
                f"unknown solver preset {solver_opts!r}; available: "
                f"{sorted(SOLVER_PRESETS)}")
        opts = dict(SOLVER_PRESETS[solver_opts])
        import torch
        if dtype is not None and dtype == torch.float64:
            opts.pop("fused_kkt", None)
        return opts
    return dict(solver_opts)


@dataclasses.dataclass(frozen=True)
class MPCOptions:
    """Static MPC options (the non-array part of ``MPC.__init__``)."""

    gp_method: str = "TA"           # ME | TA
    discrete_method: str = "gp"     # gp | rk4 | exact
    cost_func: str = "quad"         # quad | sat
    feedback: bool = True
    percentile: Optional[float] = 0.95
    terminal_constraint: Optional[float] = None
    cov_updates: int = 2            # zero-order covariance refresh passes/solve
    num_con_par: int = 0
    solver: SQPConfig = SQPConfig()
