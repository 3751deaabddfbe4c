"""Riccati sweep over the block-banded KKT system of a trajectory QP.

Counterpart of ``gpmpc_tpu/solvers/riccati.py``.  Solves

    min  sum_t 0.5 dx'Q_t dx + dx'M_t du + 0.5 du'R_t du + q_t'dx + r_t'du
         + 0.5 dx_N'Q_N dx_N + q_N'dx_N
    s.t. dx_{t+1} = A_t dx_t + B_t du_t + c_t,   dx_0 given,

by the backward Riccati factorization and a forward rollout.  ``solve``
runs the plain PyTorch sweep; ``solve_parallel`` the same solve as
associative scans of O(log Nt) depth; ``solve_fused`` the single-launch
sweep kernel (K1) through its wrapper, which takes the plain version on a
CPU tensor.  ``select_backend`` picks among them as the JAX package does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gpmpc_tpu_torch.ops import cuda_kernels
from gpmpc_tpu_torch.ops.chol import chol_small, ge_solve_small, \
    tri_solve_small


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


def _mv(m, v):
    return torch.einsum("...ij,...j->...i", m, v)


def associative_scan(fn, elems, reverse: bool = False):
    """Inclusive scan of the associative ``fn`` over the leading axis of the
    tensors in the tuple ``elems``, by the odd/even recursion of
    ``jax.lax.associative_scan`` (so both packages combine the same pairs
    in the same order)."""
    if reverse:
        elems = tuple(torch.flip(e, [0]) for e in elems)

    def scan(es):
        n = es[0].shape[0]
        if n < 2:
            return es
        odd = scan(fn(tuple(e[0:-1:2] for e in es),
                      tuple(e[1::2] for e in es)))
        if n % 2 == 0:
            even = fn(tuple(e[:-1] for e in odd), tuple(e[2::2] for e in es))
        else:
            even = fn(odd, tuple(e[2::2] for e in es))
        even = tuple(torch.cat([e[:1], r]) for e, r in zip(es, even))
        out = []
        for ev, od in zip(even, odd):
            full = ev.new_empty((ev.shape[0] + od.shape[0],) + ev.shape[1:])
            full[0::2], full[1::2] = ev, od
            out.append(full)
        return tuple(out)

    out = scan(tuple(elems))
    return tuple(torch.flip(e, [0]) for e in out) if reverse else out


def solve_parallel(qp: StageQP, dx0: torch.Tensor, reg) -> RiccatiSolution:
    """Parallel-in-time Riccati: the backward pass as an associative suffix
    scan over conditional value functions e = (A, b, C, eta, J) (Särkkä and
    García-Fernández's LQT combination rule) and the forward rollout as a
    prefix scan over affine maps; depth 2 ceil(log2 Nt) instead of 2 Nt at
    about twice the flops.  Same interface and solution as :func:`solve`
    (regularization enters through q_uu + reg)."""
    nt, nx, nu = qp.b.shape
    kw = dict(dtype=qp.b.dtype, device=qp.b.device)
    eye_x = torch.eye(nx, **kw)
    eye_u = torch.eye(nu, **kw)
    reg = torch.as_tensor(reg, **kw)

    # per-stage elements: u eliminated analytically
    lr = chol_small(qp.q_uu + reg * eye_u, clamp=False)

    def rsolve(rhs):
        return tri_solve_small(lr, tri_solve_small(lr, rhs), trans=True)

    bri, mri, rri = rsolve(qp.b.mT), rsolve(qp.q_xu.mT), rsolve(qp.q_u)
    elems = (
        torch.cat([qp.a - qp.b @ mri, torch.zeros((1, nx, nx), **kw)]),
        torch.cat([qp.c - _mv(qp.b, rri), torch.zeros((1, nx), **kw)]),
        torch.cat([qp.b @ bri, torch.zeros((1, nx, nx), **kw)]),
        torch.cat([-qp.q_x + _mv(qp.q_xu, rri), -qp.qf_x[None]]),
        torch.cat([qp.q_xx - qp.q_xu @ mri, qp.qf_xx[None]]),
    )

    def combine(e1, e2):
        """e1 earlier, e2 the later aggregate."""
        a1, b1, c1, n1, j1 = e1
        a2, b2, c2, n2, j2 = e2
        sol = ge_solve_small(eye_x + c1 @ j2,
                             torch.cat([a1, (b1 + _mv(c1, n2))[..., None],
                                        c1], dim=-1))
        la, lb, lc = sol[..., :nx], sol[..., nx], sol[..., nx + 1:]
        sol2 = ge_solve_small(eye_x + j2 @ c1,
                              torch.cat([(n2 - _mv(j2, b1))[..., None],
                                         j2 @ a1], dim=-1))
        return (a2 @ la, _mv(a2, lb) + b2, a2 @ lc @ a2.mT + c2,
                _mv(a1.mT, sol2[..., 0]) + n1, a1.mT @ sol2[..., 1:] + j1)

    # with reverse=True the operator receives (later aggregate, earlier)
    scanned = associative_scan(lambda x, y: combine(y, x), elems,
                               reverse=True)
    s_next, l_next = scanned[4][1:], -scanned[3][1:]

    # per-stage gains from V_{k+1}, all stages at once
    h_uu = qp.q_uu + reg * eye_u + qp.b.mT @ s_next @ qp.b
    lh = chol_small(h_uu, clamp=False)

    def pd_solve(rhs):
        return tri_solve_small(lh, tri_solve_small(lh, rhs), trans=True)

    h_xu = qp.q_xu + qp.a.mT @ s_next @ qp.b
    h_u = qp.q_u + _mv(qp.b.mT, _mv(s_next, qp.c) + l_next)
    gains = -pd_solve(h_xu.mT)
    ffs = -pd_solve(h_u)
    decs = -torch.sum(ffs * h_u, dim=-1) - 0.5 * torch.sum(
        ffs * _mv(h_uu, ffs), dim=-1)

    # forward rollout as an affine prefix scan: (Mq Mp, Mq vp + vq)
    mm, vv = associative_scan(
        lambda p, q: (q[0] @ p[0], _mv(q[0], p[1]) + q[1]),
        (qp.a + qp.b @ gains, _mv(qp.b, ffs) + qp.c))
    dx = torch.cat([dx0[None], _mv(mm, dx0) + vv])
    du = ffs + _mv(gains, dx[:-1])
    return _solution(dx, du, gains, ffs, torch.sum(decs))


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


#: without ``fused``, f32 problems of at least this many stages take the
#: associative scan (the JAX package's ``KKTPolicy.parallel_min_nt``); its
#: ``fused_max_nt`` cap is not carried over: the sweep kernel (K1) loops over
#: stages at run time
PARALLEL_MIN_NT = 20


def select_backend(nt: int, dtype, fused: bool = False,
                   parallel: bool = False):
    """Pick the KKT solve for a horizon-``nt`` QP, as the JAX package does
    except for its ``fused_max_nt`` cap.

    * ``fused=True`` takes the sweep kernel at every horizon.  f64 + fused
      raises.
    * ``parallel=True`` takes the associative scan.
    * Neither: sequential below :data:`PARALLEL_MIN_NT` stages, the
      associative scan for f32 at or above it; f64 always sequential (the
      x64 parity path keeps one reduction order).
    """
    is_f64 = dtype == torch.float64
    if fused:
        if is_f64:
            raise ValueError(
                "fused_kkt runs the KKT sweep in f32 — it would silently "
                "degrade a float64 problem; use the default Riccati path "
                "for x64 parity")
        return solve_fused
    if parallel:
        return solve_parallel
    if not is_f64 and nt >= PARALLEL_MIN_NT:
        return solve_parallel
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
