"""Riccati sweep over the block-banded KKT system of a trajectory QP.

Counterpart of ``gpmpc_tpu/solvers/riccati.py``.  Solves

    min  sum_t 0.5 dx'Q_t dx + dx'M_t du + 0.5 du'R_t du + q_t'dx + r_t'du
         + 0.5 dx_N'Q_N dx_N + q_N'dx_N
    s.t. dx_{t+1} = A_t dx_t + B_t du_t + c_t,   dx_0 given,

by the backward Riccati factorization and a forward rollout.  ``solve``
runs the plain PyTorch sweep; ``solve_fused`` the single-launch sweep
kernel (K1) through its wrapper, which takes the plain version on a CPU
tensor.  The associative-scan ``solve_parallel`` is ROADMAP slice F item 4.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gpmpc_tpu_torch.ops import cuda_kernels


class StageQP(NamedTuple):
    """Stacked stage data; leading axis = time (Nt for stage terms)."""

    a: torch.Tensor      # (Nt, Nx, Nx) dynamics dx jacobian
    b: torch.Tensor      # (Nt, Nx, Nu) dynamics du jacobian
    c: torch.Tensor      # (Nt, Nx)    defects f(x_t,u_t) - x_{t+1}
    q_xx: torch.Tensor   # (Nt, Nx, Nx)
    q_uu: torch.Tensor   # (Nt, Nu, Nu)
    q_xu: torch.Tensor   # (Nt, Nx, Nu)
    q_x: torch.Tensor    # (Nt, Nx)
    q_u: torch.Tensor    # (Nt, Nu)
    qf_xx: torch.Tensor  # (Nx, Nx) terminal
    qf_x: torch.Tensor   # (Nx,)


class RiccatiSolution(NamedTuple):
    dx: torch.Tensor       # (Nt+1, Nx)
    du: torch.Tensor       # (Nt, Nu)
    gain_k: torch.Tensor   # (Nt, Nu, Nx) feedback gains K_t
    ff_k: torch.Tensor     # (Nt, Nu)     feedforward k_t
    ok: torch.Tensor       # scalar bool: factorization stayed finite
    exp_dec: torch.Tensor  # predicted objective decrease


def _solution(dx, du, gains, ffs, dec) -> RiccatiSolution:
    finite = (torch.all(torch.isfinite(dx)) & torch.all(torch.isfinite(du))
              & torch.all(torch.isfinite(gains)))
    return RiccatiSolution(dx=dx, du=du, gain_k=gains, ff_k=ffs, ok=finite,
                           exp_dec=dec)


def solve(qp: StageQP, dx0: torch.Tensor, reg) -> RiccatiSolution:
    """Backward Riccati factorization + forward rollout in plain PyTorch.

    ``reg`` is a Levenberg term added to Q_uu to keep the sweep positive
    definite far from the solution; a non-PD pivot gives NaN and
    ``ok=False``."""
    return _solution(*cuda_kernels.riccati_sweep_reference(*qp, dx0, reg))


def solve_fused(qp: StageQP, dx0: torch.Tensor, reg) -> RiccatiSolution:
    """The single-launch sweep kernel (K1): same math and interface as
    :func:`solve`, f32 only.  ``reg`` may be a tensor on the QP's device
    (no host sync) or a Python float."""
    if qp.b.dtype == torch.float64:
        raise ValueError(
            "solve_fused runs the KKT sweep in f32 — it would silently "
            "degrade a float64 problem; use riccati.solve for x64 parity work")
    reg = torch.as_tensor(reg, dtype=qp.b.dtype, device=qp.b.device)
    return _solution(*cuda_kernels.riccati_sweep(
        *(t.contiguous() for t in qp), dx0.contiguous(), reg))


def select_backend(nt: int, dtype, fused: bool = False,
                   parallel: bool = False):
    """Pick the KKT solve for a horizon-``nt`` QP.

    * ``fused=True`` takes the sweep kernel at every horizon: it loops over
      stages at run time, so the JAX package's ``fused_max_nt`` cap (set by
      its Python-unrolled Pallas kernel) does not carry over.  f64 + fused
      raises.
    * ``parallel=True`` (associative scan) is not ported yet.
    * Neither: the sequential sweep.  The JAX package picks its associative
      scan for f32 at ``nt >= 20`` here; until that is ported the port
      stays sequential (same solution up to f32 rounding).
    """
    if fused:
        if dtype == torch.float64:
            raise ValueError(
                "fused_kkt runs the KKT sweep in f32 — it would silently "
                "degrade a float64 problem; use the default Riccati path "
                "for x64 parity")
        return solve_fused
    if parallel:
        raise NotImplementedError(
            "parallel_kkt (associative-scan Riccati) is not ported yet "
            "(ROADMAP slice F item 4)")
    return solve


def lqr_gain(a: torch.Tensor, b: torch.Tensor, q: torch.Tensor,
             r: torch.Tensor, max_iters: int = 1000, tol: float = 1e-9,
             return_converged: bool = False):
    """Infinite-horizon discrete LQR gain via Riccati iteration with a
    relative ``||P_{k+1} - P_k||_inf`` stopping test and an iteration cap.
    Returns K with u = -K x; with ``return_converged=True`` also whether the
    tolerance was met.  Runs once per controller, so its stopping test
    reads the device each iteration."""
    # dtype-aware tolerance floor: 1e-9 relative is below f32 resolution
    tol = max(tol, 50.0 * float(torch.finfo(q.dtype).eps))
    p = q
    done = False
    for _ in range(max_iters):
        bp = b.T @ p
        k = torch.linalg.solve(r + bp @ b, bp @ a)
        p_n = q + a.T @ p @ (a - b @ k)
        p_n = 0.5 * (p_n + p_n.T)
        delta = torch.max(torch.abs(p_n - p)) / (1.0 + torch.max(torch.abs(p_n)))
        p = p_n
        if bool(delta <= tol):
            done = True
            break
    bp = b.T @ p
    k = torch.linalg.solve(r + bp @ b, bp @ a)
    if return_converged:
        return k, done
    return k
