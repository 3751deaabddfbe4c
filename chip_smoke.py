"""Smoke test of the PyTorch/CUDA port (gpmpc_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (each ends in torch.cuda.synchronize(); any failure raises and the
script exits non-zero before its last line):
  1. the card: nvidia-smi name and power limit, torch's device name;
  2. build the CUDA kernels from gpmpc_tpu_torch/csrc/ (nvcc, sm_90a);
  3. K1 (Riccati sweep) against its plain PyTorch version on the card, at
     the three shapes of the JAX package's kernel test, plus the NaN case;
  4. K2 (RK4 substeps) against its plain version, one rollout and eight;
  5. the main path at full width: the pinned four-tank GP (N=100, D=6,
     Ny=4), TA propagation with chance tightening, Nt=20, the RTI budget,
     the fused plant integrator, f32 on the card, a 30-step closed loop
     from X0 to XSP; launch counts exact, values finite, the tracked
     tanks at their setpoint; each control step of the loop against the
     same step on the CPU (replay_against_cpu); realized cost against the
     converged (al4 x mi20) budget;
  6. per-step time, a torch.profiler trace of three control steps (device
     kernels and device time per step, the device's busy share) and
     kernel-vs-plain times, with the card's name and power limit.
The last three lines are the card's name and power limit (nvidia-smi), a
JSON object with the kernels' rows, and {"ok": true, "device": {...}}.

``python3 chip_smoke.py --panel [--steps 140]`` instead measures the
quality gate: the realized-cost ratio RTI / converged over each initial
state of ``benchmarks.bench_spec.X0_PANEL`` (one process per state, all on
the one card), and its median, which must be <= 1.01.
The script imports no JAX.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
N_STEPS = 30
RTI = dict(al_iters=2, max_iters=2, ls_steps=8, penalty_init=1e3,
           fused_kkt=True)
CONVERGED = dict(al_iters=4, max_iters=20, fused_kkt=True)


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps, warmup=3):
    """Mean ms per call of ``fn`` on the card: CUDA events around ``reps``
    calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_kernels(ck, four_tank_ode, dev):
    """K1 and K2 against their plain versions on the card (tolerances in
    ``cuda_kernels.check_*``); returns their max abs errors at the main
    path's shapes."""
    k1_err = None
    for nt, nx, nu, seed in [(20, 4, 2, 0), (13, 5, 3, 1), (8, 2, 1, 2)]:
        err = ck.check_riccati_sweep(
            ck.stage_qp_inputs(nt, nx, nu, seed, device=dev),
            torch.tensor(1e-6, device=dev))
        log(f"[K1] (Nt,nx,nu)=({nt},{nx},{nu}) max|err| {err:.3e}")
        k1_err = err if k1_err is None else k1_err
    # indefinite H_uu, no regularization: NaN, so ok=False upstream
    args = ck.stage_qp_inputs(8, 2, 1, 2, device=dev)
    args[4] = -args[4]
    got = ck.riccati_sweep(*args, torch.zeros((), device=dev))
    torch.cuda.synchronize()
    if bool(torch.all(torch.isfinite(got[2]))):
        raise AssertionError("K1 gave finite gains for an indefinite H_uu")
    log("[K1] indefinite H_uu -> NaN gains: ok")
    rng = np.random.default_rng(0)
    k2_err = None
    for lead in [(), (8,)]:
        x = torch.tensor(np.abs(rng.standard_normal(lead + (4,))) * 4 + 0.5,
                         dtype=torch.float32, device=dev)
        u = torch.tensor(np.abs(rng.standard_normal(lead + (2,))) * 3,
                         dtype=torch.float32, device=dev)
        err = ck.check_rk4_substeps(four_tank_ode, x, u, 0.3, 10)
        log(f"[K2] batch={lead or 1} max|err| {err:.3e} (rtol 1e-5, atol "
            f"1e-6: nvcc contracts to FMA)")
        k2_err = err if k2_err is None else k2_err
    torch.cuda.synchronize()
    return k1_err, k2_err


def build_slice(dev, solver_opts):
    from benchmarks.bench_spec import (DT, MODEL_R, NT, Q_W, R_W, ULB, UUB,
                                       XLB, XSP, XUB)
    from gpmpc_tpu_torch import MPC, Model
    from gpmpc_tpu_torch.models.convert import gp_from_fixture
    from gpmpc_tpu_torch.systems import four_tank_ode

    model = Model(Nx=4, Nu=2, ode=four_tank_ode, dt=DT, R=MODEL_R,
                  clip_negative=True, integrator_substeps=10,
                  fused_integrator=True, device=dev, dtype=torch.float32)
    gp = gp_from_fixture(device=dev, dtype=torch.float32, gp_method="TA",
                         optimizer_opts=dict(jitter=1e-5, min_noise=1e-4))
    return MPC(horizon=NT * DT, model=model, gp=gp, gp_method="TA",
               discrete_method="gp", Q=Q_W, R=R_W, ulb=ULB, uub=UUB,
               xlb=XLB, xub=XUB, percentile=0.95, feedback=True,
               cov_updates=1, op_x=XSP, op_u=np.array([3.0, 3.0]),
               solver_opts=solver_opts)


def to_cpu(v):
    """Tensors, and (named) tuples of them, moved to the CPU."""
    if v is None:
        return None
    if torch.is_tensor(v):
        return v.cpu()
    return type(v)(*(to_cpu(x) for x in v))


#: the first control steps from X0 drive both pumps at their upper bound
#: (the saturated transient); the rest track the setpoint
TRANSIENT_STEPS = 4


def replay_against_cpu(dev):
    """Per-step check of the card against the CPU on the main path (chance
    tightening on): replay a 30-step closed loop on the card through
    ``solve_step`` and, at every step, solve the same step on the CPU from
    the card's state, warm start and last input, with the card's GP
    posterior and feedback gain.  The next states must agree within rtol
    1e-3 once the loop tracks the setpoint, and 1e-2 in the saturated
    transient.

    Why per step and why two bounds: the RTI line search takes the first of
    eight step lengths whose merit passes the Armijo test, and near a
    solution the merits it compares differ at f32 rounding, so any change of
    summation order changes some of its choices.  On a CPU alone, summing
    the same posterior in another order (a permutation of the training
    points) changed a line-search choice in 26 of 30 steps and moved the
    next state by at most 2.5e-3 relative in the transient and 1.4e-4 after
    it; the same two loops run free drift up to 5.7e-3 apart.  A wrong
    step lands far outside the bounds: with the explicit-inverse f32
    variance the replay measured 4.0e-2 (H100 80GB HBM3 at 700 W)."""
    from benchmarks.bench_spec import X0, XSP
    from gpmpc_tpu_torch.solvers.al_sqp import SolverState

    mpc = build_slice(dev, RTI)
    cpu = build_slice(torch.device("cpu"), RTI)
    own = cpu.consts.post
    card = to_cpu(mpc.consts.post)
    rel = max(float((own.alpha - card.alpha).abs().max()
                    / card.alpha.abs().max()),
              float((own.chol - card.chol).abs().max()
                    / card.chol.abs().max()))
    log(f"[slice] f32 GP posterior, card vs CPU: max relative difference "
        f"{rel:.3e} in alpha / chol (information)")
    cpu.consts = to_cpu(mpc.consts)
    t0 = time.perf_counter()
    x = torch.as_tensor(X0, dtype=torch.float32, device=dev)
    _, warm, _, _ = mpc.solve_step(x, XSP)          # cold-start preparation
    u_prev = torch.zeros(2, device=dev)
    worst = [(0.0, 0), (0.0, 0)]                    # transient, tracking
    worst_u = 0.0
    for k in range(N_STEPS):
        u, warm_n, _, _ = mpc.solve_step(x, XSP, warm=warm, u_prev=u_prev)
        x_n = mpc.model.integrate(x, u).clamp(min=0.0)
        u_c, _, _, _ = cpu.solve_step(
            x.cpu(), XSP, warm=SolverState(*(t.cpu() for t in warm)),
            u_prev=u_prev.cpu())
        x_c = cpu.model.integrate(x.cpu(), u_c).clamp(min=0.0)
        if not bool(torch.all(torch.isfinite(x_n))):
            raise AssertionError("non-finite state in the replay on the card")
        rel = float(((x_n.cpu() - x_c).abs() / x_c.abs()).max())
        phase = int(k >= TRANSIENT_STEPS)
        worst[phase] = max(worst[phase], (rel, k))
        worst_u = max(worst_u, float((u.cpu() - u_c).abs().max()))
        x, warm, u_prev = x_n, warm_n, u
    torch.cuda.synchronize()
    log(f"[slice] per-step replay with tightening, card vs CPU "
        f"({time.perf_counter() - t0:.1f} s): max relative next-state "
        f"difference {worst[0][0]:.3e} at step {worst[0][1]} in the "
        f"transient (rtol 1e-2), {worst[1][0]:.3e} at step {worst[1][1]} "
        f"after it (rtol 1e-3); max |u| difference {worst_u:.3e}")
    if worst[0][0] > 1e-2 or worst[1][0] > 1e-3:
        raise AssertionError("CUDA and CPU control steps disagree")
    return worst


def profile_steps(step, n=3):
    """torch.profiler over ``n`` calls of ``step``: device kernels and
    device ms per call, and the share of the wall time the device is
    busy."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ev = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in ev)
    kernels = sum(e.count for e in ev if e.self_device_time_total > 0
                  and e.device_type.name == "CUDA")
    if dev_us <= 0:
        raise AssertionError("the profiler saw no device time")
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:6]
    return dict(kernels_per_step=kernels / n, device_ms_per_step=dev_us / n
                / 1e3, wall_ms_per_step=wall / n * 1e3,
                busy_share=dev_us / 1e6 / wall,
                top=[(e.key[:60], e.count, e.self_device_time_total / n)
                     for e in top])


def panel_one(i, n_steps):
    """Realized cost of the RTI and the converged budget from X0_PANEL[i];
    prints one JSON line."""
    from benchmarks.bench_spec import DT, X0_PANEL, XSP, closed_loop_cost
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    costs = []
    for budget in (RTI, CONVERGED):
        xs, us = build_slice(dev, budget).solve(X0_PANEL[i], n_steps * DT,
                                                XSP, noise=False)
        xs, us = xs.cpu().numpy(), us.cpu().numpy()
        if not (np.all(np.isfinite(xs)) and np.all(np.isfinite(us))):
            raise AssertionError(f"non-finite closed loop from X0_PANEL[{i}]")
        costs.append(closed_loop_cost(xs, us, XSP))
    print(json.dumps({"i": i, "rti": costs[0], "converged": costs[1],
                      "ratio": costs[0] / costs[1],
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 0


def panel(n_steps):
    """The cost-ratio gate over X0_PANEL: one process per initial state, all
    on the one card (the loop is bound by the host, so they overlap)."""
    from benchmarks.bench_spec import X0_PANEL
    card = card_line()
    log(f"[panel] {card}; {len(X0_PANEL)} initial states, {n_steps} steps, "
        f"RTI {RTI} vs converged {CONVERGED}")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--panel-one", str(i), "--steps",
                               str(n_steps)], stdout=subprocess.PIPE,
                              text=True, env=env, cwd=HERE)
             for i in range(len(X0_PANEL))]
    rows = []
    for p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            for q in procs:
                q.kill()
                q.wait()
            raise AssertionError(f"panel worker failed ({p.returncode})")
        rows.append(json.loads(out.strip().splitlines()[-1]))
    for r in rows:
        log(f"[panel] x0[{r['i']}]: RTI {r['rti']:.4f}, converged "
            f"{r['converged']:.4f}, ratio {r['ratio']:.5f} "
            f"({r['seconds']:.1f} s)")
    med = float(np.median([r["ratio"] for r in rows]))
    log(f"[panel] median ratio {med:.5f} (gate <= 1.01) on {card}")
    print(json.dumps({"cost_ratio_median": med,
                      "cost_ratio_per_x0": [r["ratio"] for r in rows],
                      "card": card}), flush=True)
    return 0 if med <= 1.01 else 1


def main(argv):
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this smoke "
              "test runs only on an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    n_steps = int(argv[argv.index("--steps") + 1]) if "--steps" in argv \
        else 140
    if "--panel-one" in argv:
        return panel_one(int(argv[argv.index("--panel-one") + 1]), n_steps)
    if "--panel" in argv:
        return panel(n_steps)
    from benchmarks.bench_spec import DT, X0, XSP, closed_loop_cost
    from gpmpc_tpu_torch.ops import cuda_kernels as ck
    from gpmpc_tpu_torch.systems import four_tank_ode

    # 1. the card
    card = card_line()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    log(f"[card] nvidia-smi: {card}")
    log(f"[card] torch: {kind}, count={torch.cuda.device_count()}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    ck.build_library()
    torch.cuda.synchronize()
    log(f"[build] {time.perf_counter() - t0:.2f} s -> {ck.BUILD_INFO['path']}")
    for line in ck.BUILD_INFO["log"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    # 3-4. kernels against their plain versions
    k1_err, k2_err = check_kernels(ck, four_tank_ode, dev)

    # 5. the main path
    mpc = build_slice(dev, RTI)
    ck.reset_launches()
    t0 = time.perf_counter()
    xs, us = mpc.solve(X0, N_STEPS * DT, XSP, noise=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    log(f"[slice] {N_STEPS}-step closed loop on {kind}: {wall:.3f} s "
        f"(cold start included); launches {launches}")
    expect = {"riccati_sweep": N_STEPS * RTI["al_iters"] * RTI["max_iters"],
              "rk4_substeps": N_STEPS}
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")
    xs_np, us_np = xs.cpu().numpy(), us.cpu().numpy()
    if xs_np.shape != (N_STEPS + 1, 4) or us_np.shape != (N_STEPS, 2):
        raise AssertionError(f"shapes {xs_np.shape}, {us_np.shape}")
    if not (np.all(np.isfinite(xs_np)) and np.all(np.isfinite(us_np))):
        raise AssertionError("non-finite closed-loop trajectory")
    run = mpc.last_run
    log(f"[slice] final state {xs_np[-1].tolist()}, setpoint {XSP.tolist()}; "
        f"converged {int(run['converged'].sum())}/{N_STEPS}")
    # the two tracked (lower) tanks start 6 and 4 below their setpoint
    miss = float(np.abs(xs_np[-1, :2] - XSP[:2]).max())
    if miss > 0.5:
        raise AssertionError(f"the closed loop ends {miss:.3f} from the "
                             f"setpoint of the tracked tanks")

    replay_against_cpu(dev)

    cost_rti = closed_loop_cost(xs_np, us_np, XSP)
    t0 = time.perf_counter()
    xs_c, us_c = build_slice(dev, CONVERGED).solve(X0, N_STEPS * DT, XSP,
                                                   noise=False)
    cost_conv = closed_loop_cost(xs_c.cpu().numpy(), us_c.cpu().numpy(), XSP)
    log(f"[slice] realized cost over {N_STEPS} steps at X0: RTI "
        f"{cost_rti:.4f}, converged al4xmi20 {cost_conv:.4f}, ratio "
        f"{cost_rti / cost_conv:.5f} (information; converged run "
        f"{time.perf_counter() - t0:.1f} s)")

    # 6. timings on the card
    x = torch.as_tensor(xs_np[-1], device=dev)
    u0, warm, _, _ = mpc.solve_step(x, XSP, warm=None)
    state = {"x": x, "u0": u0, "warm": warm}

    def rti_step():
        u, w, _, _ = mpc.solve_step(state["x"], XSP, warm=state["warm"],
                                    u_prev=state["u0"])
        state.update(u0=u, warm=w, x=mpc.model.integrate(state["x"], u))

    step_ms = cuda_time_ms(rti_step, reps=10)
    log(f"[time] RTI control step (solve_step + plant step), CUDA events "
        f"after warm-up: {step_ms:.3f} ms/step on {card}")
    prof = profile_steps(rti_step)
    log(f"[profile] per RTI control step: {prof['kernels_per_step']:.0f} "
        f"device kernels, {prof['device_ms_per_step']:.3f} ms device time, "
        f"{prof['wall_ms_per_step']:.3f} ms wall under the profiler; device "
        f"busy {100 * prof['busy_share']:.2f}% on {card}")
    for name, count, us in prof["top"]:
        log(f"[profile]   {name:60s} {count:6d} launches/3 steps "
            f"{us:9.1f} us/step")

    q1 = ck.stage_qp_inputs(20, 4, 2, 0, device=dev)
    reg = torch.tensor(1e-6, device=dev)
    k1_ms = cuda_time_ms(lambda: ck.riccati_sweep(*q1, reg), reps=200)
    k1_plain = cuda_time_ms(lambda: ck.riccati_sweep_reference(*q1, reg),
                            reps=20)
    x1 = torch.tensor([8.0, 10.0, 1.0, 1.5], device=dev)
    u1 = torch.tensor([3.0, 3.0], device=dev)
    k2_ms = cuda_time_ms(
        lambda: ck.rk4_substeps(four_tank_ode, x1, u1, DT / 10, 10), reps=200)
    k2_plain = cuda_time_ms(
        lambda: ck.rk4_substeps_reference(four_tank_ode, x1, u1, DT / 10, 10),
        reps=20)
    log(f"[time] K1 riccati_sweep (Nt=20, nx=4, nu=2): kernel {k1_ms:.4f} ms,"
        f" plain torch on the card {k1_plain:.4f} ms on {card}")
    log(f"[time] K2 rk4_substeps (nx=4, nu=2, n_sub=10): kernel "
        f"{k2_ms:.4f} ms, plain torch on the card {k2_plain:.4f} ms on {card}")

    rows = [
        {"name": "riccati_sweep", "route": "cuda",
         "source": "gpmpc_tpu_torch/csrc/riccati_sweep.cu",
         "replaces": "gpmpc_tpu/ops/pallas_kernels.py:394",
         "launches": launches["riccati_sweep"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "rk4_substeps", "route": "cuda",
         "source": "gpmpc_tpu_torch/csrc/rk4_substeps.cu",
         "replaces": "gpmpc_tpu/ops/pallas_kernels.py:233",
         "launches": launches["rk4_substeps"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain},
    ]
    print(card_line(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
