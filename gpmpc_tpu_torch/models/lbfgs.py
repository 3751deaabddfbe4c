"""Batched L-BFGS with a zoom line search (strong Wolfe conditions).

The counterpart of ``optax.lbfgs()`` with its defaults, as
``gpmpc_tpu/models/gp_core.py::_run_lbfgs`` drives it: memory 10, the
initial inverse-Hessian scale from the last secant pair (the first step
scaled to a unit ball), and ``scale_by_zoom_linesearch(max_linesearch_steps
=20, initial_guess_strategy='one')`` with its default tolerances (Nocedal
and Wright, Algorithms 3.5 and 3.6, plus Hager and Zhang's approximate
decrease test).  The JAX package maps one problem at a time through
``lax.while_loop``s; here P independent problems run as one batch: every
objective evaluation evaluates all of them at once (on the card one Gram
and one Cholesky launch for the whole GP training grid), and a problem
that has stopped is frozen by a mask, so each problem takes the iterates
it would take alone.  The loops end on a test read on the host: one read
per objective evaluation, allowed because training is not the control
step.
"""

from __future__ import annotations

import torch

MEMORY = 10
LS_STEPS = 20
SLOPE_RTOL = 1e-4        # sufficient decrease (Armijo)
CURV_RTOL = 0.9          # small curvature (second Wolfe)
APPROX_DEC_RTOL = 1e-6   # switch to the approximate decrease test
STEPSIZE_PRECISION = 1e-5
INCREASE = 2.0


def _w(cond, a, b):
    """``torch.where`` with a per-problem condition (P,) over values with a
    leading problem dim."""
    return torch.where(cond.reshape(cond.shape + (1,) * (a.ndim - 1)), a, b)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def value_and_grad(fun, theta):
    """``fun(theta)`` (P,) and its gradient (P, T): the problems are
    independent, so the gradient of the sum is each one's own."""
    th = theta.detach().requires_grad_(True)
    with torch.enable_grad():
        v = fun(th)
        (g,) = torch.autograd.grad(v.sum(), th)
    return v.detach(), g


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa) with slope fpa, (b, fb)
    and (c, fc); NaN where there is none."""
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    v1, v2 = fb - fa - fpa * db, fc - fa - fpa * dc
    aa = (dc ** 2 * v1 + -(db ** 2) * v2) / denom
    bb = (-(dc ** 3) * v1 + db ** 3 * v2) / denom
    radical = bb * bb - 3.0 * aa * fpa
    return a + (-bb + torch.sqrt(radical)) / (3.0 * aa)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa) with slope fpa and
    (b, fb)."""
    db = b - a
    bb = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * bb)


def _errors(step, value, slope, value0, slope0):
    """Sufficient-decrease and curvature errors (0 where met, inf for
    NaN)."""
    dec = value - value0 - SLOPE_RTOL * step * slope0
    approx = torch.maximum(slope - (2 * SLOPE_RTOL - 1.0) * slope0,
                           value - value0 - APPROX_DEC_RTOL * value0.abs())
    dec = torch.clamp(torch.minimum(approx, dec), min=0.0)
    dec = torch.where(torch.isnan(dec), torch.inf, dec)
    curv = torch.clamp(slope.abs() - CURV_RTOL * slope0.abs(), min=0.0)
    curv = torch.where(torch.isnan(curv), torch.inf, curv)
    return dec, curv


def zoom_linesearch(fun, theta, upd, value, grad, searching):
    """Step lengths along ``upd`` for the problems where ``searching``:
    returns ``(stepsize, value, grad, n_evals)`` at the chosen steps."""
    zeros = torch.zeros_like(value)
    slope = _dot(upd, grad)
    value0, slope0 = value, slope
    st = dict(step=zeros, value=value, grad=grad, slope=slope,
              dec=torch.full_like(value, torch.inf),
              found=torch.zeros_like(searching), done=torch.zeros_like(
                  searching), failed=torch.zeros_like(searching),
              low=zeros, v_low=value, s_low=slope, high=zeros, v_high=value,
              s_high=slope, cref=zeros, v_cref=value,
              safe=zeros, v_safe=value, g_safe=grad)
    live = searching.clone()
    count = 0
    while bool(live.any()):                 # host read: any still searching
        # next trial step: interval search (Alg. 3.5) or zoom (Alg. 3.6)
        grow = torch.full_like(value, 1.0) if count == 0 else \
            INCREASE * st["step"]
        low, high = st["low"], st["high"]
        delta = (high - low).abs()
        left, right = torch.minimum(high, low), torch.maximum(high, low)
        m_cubic = _cubicmin(low, st["v_low"], st["s_low"], high,
                            st["v_high"], st["cref"], st["v_cref"])
        use_cubic = (m_cubic > left + 0.2 * delta) & \
            (m_cubic < right - 0.2 * delta)
        m_quad = _quadmin(low, st["v_low"], st["s_low"], high, st["v_high"])
        use_quad = ~use_cubic & (m_quad > left + 0.1 * delta) & \
            (m_quad < right - 0.1 * delta)
        middle = torch.where(use_cubic, m_cubic, st["cref"])
        middle = torch.where(use_quad, m_quad, middle)
        middle = torch.where(~use_cubic & ~use_quad, (low + high) / 2.0,
                             middle)
        found = st["found"]
        step = torch.where(live, torch.where(found, middle, grow), zeros)
        v, g = value_and_grad(fun, theta + step[:, None] * upd)
        s = _dot(g, upd)
        dec, curv = _errors(step, v, s, value0, slope0)
        err = torch.maximum(dec, curv)
        done = err <= 0.0
        last = count + 1 >= LS_STEPS

        # interval search
        hi_new = (dec > 0.0) | ((v >= st["value"]) & (count > 0))
        lo_new = (s >= 0.0) & ~hi_new
        srch = dict(
            low=torch.where(lo_new, step, st["step"]),
            v_low=torch.where(lo_new, v, st["value"]),
            s_low=torch.where(lo_new, s, st["slope"]),
            high=torch.where(lo_new, st["step"], step),
            v_high=torch.where(lo_new, st["value"], v),
            s_high=torch.where(lo_new, st["slope"], s))
        srch.update(cref=srch["low"], v_cref=srch["v_low"],
                    found=hi_new | lo_new | done)
        safe_s = dec <= 0.0
        srch.update(safe=torch.where(safe_s, step, st["safe"]),
                    v_safe=torch.where(safe_s, v, st["v_safe"]),
                    g_safe=_w(safe_s, g, st["g_safe"]),
                    failed=last & ~done)

        # zoom
        hi_mid = (dec > 0.0) | (v >= st["v_low"])
        hi_low = (s * (high - low) >= 0.0) & ~hi_mid
        lo_mid = ~hi_mid
        zm = dict(
            high=torch.where(hi_low, low, torch.where(hi_mid, step, high)),
            v_high=torch.where(hi_low, st["v_low"],
                               torch.where(hi_mid, v, st["v_high"])),
            s_high=torch.where(hi_low, st["s_low"],
                               torch.where(hi_mid, s, st["s_high"])),
            low=torch.where(lo_mid, step, low),
            v_low=torch.where(lo_mid, v, st["v_low"]),
            s_low=torch.where(lo_mid, s, st["s_low"]),
            cref=torch.where(hi_mid | hi_low, high, low),
            v_cref=torch.where(hi_mid | hi_low, st["v_high"], st["v_low"]),
            found=found)
        safe_z = (dec <= 0.0) & (v < st["v_safe"])
        zm.update(safe=torch.where(safe_z, step, st["safe"]),
                  v_safe=torch.where(safe_z, v, st["v_safe"]),
                  g_safe=_w(safe_z, g, st["g_safe"]))
        zm["failed"] = (last | ((delta <= STEPSIZE_PRECISION)
                                & (zm["safe"] > 0.0))) & ~done

        new = {k: _w(found, zm[k], srch[k]) for k in zm}
        new.update(step=step, value=v, grad=g, slope=s, dec=dec, done=done)
        # a failed search falls back on the safest step that decreased
        use_safe = new["failed"] & ((new["safe"] > 0.0) | torch.isinf(dec))
        new.update(step=torch.where(use_safe, new["safe"], step),
                   value=torch.where(use_safe, new["v_safe"], v),
                   grad=_w(use_safe, new["g_safe"], g))
        st = {k: _w(live, new[k], st[k]) for k in st}
        count += 1
        live = live & ~(st["done"] | st["failed"])
    return st["step"], st["value"], st["grad"], count


def minimize(fun, theta0, max_iters: int, tol: float):
    """Minimize each row of ``fun`` (P,) over its own row of theta (P, T)
    from ``theta0``.  Each problem iterates while ``count < max_iters`` and
    ``||grad|| >= tol`` (and at least once), as the JAX ``while_loop``.
    Returns ``(theta, fun(theta), n_evals)``: ``n_evals`` counts the
    batched objective evaluations, the final one included."""
    p, t = theta0.shape
    kw = dict(dtype=theta0.dtype, device=theta0.device)
    ar = torch.arange(p, device=theta0.device)
    theta = theta0.detach().clone()
    count = torch.zeros(p, dtype=torch.long, device=theta0.device)
    value = torch.full((p,), torch.inf, **kw)
    grad = torch.zeros((p, t), **kw)
    prev_theta, prev_grad = torch.zeros_like(theta), torch.zeros_like(theta)
    mem_dw = torch.zeros((p, MEMORY, t), **kw)
    mem_du = torch.zeros((p, MEMORY, t), **kw)
    mem_rho = torch.zeros((p, MEMORY), **kw)
    active = torch.ones(p, dtype=torch.bool, device=theta0.device)
    n_evals = 0
    while True:
        active = active & ((count == 0) | ((count < max_iters)
                                           & (grad.norm(dim=-1) >= tol)))
        if not bool(active.any()):          # host read: the stop test
            break
        stale = active & ~torch.isfinite(value)
        if bool(stale.any()):
            v, g = value_and_grad(fun, theta)
            n_evals += 1
            value, grad = torch.where(stale, v, value), _w(stale, g, grad)

        # the L-BFGS memory takes the last secant pair
        first = count == 0
        dw = _w(first, torch.zeros_like(theta), theta - prev_theta)
        du = _w(first, torch.zeros_like(theta), grad - prev_grad)
        curv = _dot(du, dw)
        rho = torch.where(first | (curv == 0.0), 0.0, 1.0 / curv)
        slot = (count - 1) % MEMORY
        new_dw, new_du, new_rho = mem_dw.clone(), mem_du.clone(), \
            mem_rho.clone()
        new_dw[ar, slot], new_du[ar, slot], new_rho[ar, slot] = dw, du, rho
        mem_dw = _w(active, new_dw, mem_dw)
        mem_du = _w(active, new_du, mem_du)
        mem_rho = _w(active, new_rho, mem_rho)
        den = _dot(du, du)
        scale = torch.where(den > 0.0, curv / den, 1.0)
        scale = torch.where(first, torch.clamp(1.0 / grad.norm(dim=-1),
                                               max=1.0), scale)

        # two-loop recursion, newest pair first
        order = (count[:, None] % MEMORY
                 + torch.arange(MEMORY, device=theta.device)) % MEMORY
        vec, alphas = grad, [None] * MEMORY
        for j in range(MEMORY - 1, -1, -1):
            i = order[:, j]
            alphas[j] = mem_rho[ar, i] * _dot(mem_dw[ar, i], vec)
            vec = vec - alphas[j][:, None] * mem_du[ar, i]
        vec = scale[:, None] * vec
        for j in range(MEMORY):
            i = order[:, j]
            beta = mem_rho[ar, i] * _dot(mem_du[ar, i], vec)
            vec = vec + (alphas[j] - beta)[:, None] * mem_dw[ar, i]
        upd = -vec

        step, v, g, evals = zoom_linesearch(fun, theta, upd, value, grad,
                                            active)
        n_evals += evals
        prev_theta = _w(active, theta, prev_theta)
        prev_grad = _w(active, grad, prev_grad)
        theta = _w(active, theta + step[:, None] * upd, theta)
        value, grad = torch.where(active, v, value), _w(active, g, grad)
        count = count + active.long()
    with torch.no_grad():
        final = fun(theta)
    return theta, final, n_evals + 1
