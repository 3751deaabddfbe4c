"""Smoke test of the PyTorch/CUDA port (gpmpc_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (each ends in torch.cuda.synchronize(); any failure raises and the
script exits non-zero before its last line):
  1. the card: nvidia-smi name and power limit, torch's device name;
  2. build the CUDA kernels from gpmpc_tpu_torch/csrc/ (nvcc, sm_90a);
  3. K1 (Riccati sweep) against its plain PyTorch version on the card, at
     the three shapes of the JAX package's kernel test, at Nt=300 (across
     the kernel's shared-memory chunks) and at B=1024 (Nt=20, and the
     batched study's Nt=8), at the car's
     (nx, nu) = (6, 2) with Nt=20 at B=1 and 64 and Nt=300, plus an
     indefinite and a zero H_uu pivot at the default shapes and at (6, 2)
     (non-finite gains);
  4. K2 (RK4 substeps) against its plain version: one rollout, eight (one
     of them also at n_sub=7, the run-time loop, with a drained tank on
     the 1e-6 clamp) and 1024; the Car functor at 1, 200 and 1024, with
     steering at +-0.5 rad and headings past +-pi;
  5. the main path at full width: the pinned four-tank GP (N=100, D=6,
     Ny=4), TA propagation with chance tightening, Nt=20, the RTI budget,
     the fused plant integrator, f32 on the card, a 30-step closed loop
     from X0 to XSP; launch counts exact, values finite, the tracked
     tanks at their setpoint; each control step of the loop against the
     same step on the CPU (replay_against_cpu); realized cost over the
     first ANCHOR_STEPS = 3 steps against the converged (al4 x mi20)
     budget's (cut from 30 steps to make room for the car);
  6. per-step time, a torch.profiler trace of three control steps (device
     kernels and device time per step, the device's busy share);
  7. K4 (SE-ARD Gram), K5 (Cholesky) and K3 (batched GP predict) against
     their plain versions on the card at the JAX package's kernel-test
     shapes, K4 also at N = 101, 1000 and 2048 and at D = 257 and 300
     (past one feature chunk; exactly symmetric, its diagonal bitwise),
     K5 also at N = 330 to 2048 and 4097 (both of its paths), plus K5's
     NaN on a matrix that is not positive definite, on each path; K3 also
     at (Ny, B, N, D) = (4, 1000, 1000, 6), a ragged (3, 37, 101, 6), and
     at D = 65 and 300; all three also at the car GP's shapes (K4 (4, 80,
     6), K5 (4, 80), K3 (4, 200, 80, 6));
  8. the training path at full width: GP(tank_X, tank_Y) trained on the
     card with the fixture's recipe (multistart=1, max_iters=100) and the
     example's (multistart=2, max_iters=200, seed=1), launch counts exact
     (one K4 and one K5 per objective evaluation, one K4 and three K5 per
     posterior), each fit's NLL per dim re-evaluated in f64 on the CPU
     within 0.1 of the fixture hypers' NLL;
  9. validation: 100 noise-free held-out points from the fused plant
     (generate_training_data, one K2 launch), validate of the card-trained
     and the fixture GP (one K3 launch each), the trained GP's SMSE within
     1.5x the fixture GP's on every dim;
 10. the card-trained GP in the 30-step RTI loop from X0: finite, at the
     setpoint, realized cost within 10% of phase 5's;
 11. kernel, device (torch.profiler), plain-version and library-call
     times of all five kernels at their paths' shapes beside each one's
     bound, K5 also at N = 500 to 2048, with the card's name and power
     limit; K1 also at B = 64 and 1024 and at Nt = 300, its device time
     over 20 and over 200 calls; K4 at (P, N) = (8, 100), (4, 500),
     (4, 1000) and (1, 2048) beside a fill_ of the same output (the
     practical write floor); K3 at (Ny, B, N, D) = (4, 100, 100, 6),
     (4, 1000, 500, 6) and (4, 1000, 1000, 6) beside a fill_ of the same
     k*; K2 at B = 1, 64 and 1024, and the SM cycles
     of its dependent chain (one thread between two clock64() reads);
     each beside the launch floor (a one-element add_) and nvidia-smi's
     SM clock and power draw over its window; the car's instantiations, K1
     at (6, 2) (Nt=20, B=1) and K2 Car at B = 1 and 200, and K3, K4, K5 at
     the car GP's shapes.  A profiler window that shows no device event is
     run once more, and the line says so;
 12. the car (bench config 4, bench.py:266-330) at full width: the pinned
     car fixture GP (N=80, D=6, Ny=4), EM propagation, the hybrid
     discretization, the delta-u penalty, two ellipse obstacles as user
     constraints with per-solve parameters, Nt=20, the RTI preset, f32; a
     40-step closed loop from x0 through MPC.solve: launch counts exact,
     values finite, px past the second obstacle, the clearance (min
     ellipse metric, floor 0.9; bench.py's 0.995 reported), ten steps
     replayed on the CPU (the first four and the three nearest each
     obstacle), ms per control step by CUDA events, a torch.profiler
     trace of three steps (device activity only);
 13. the car's validation: 200 held-out points in its training box,
     targets integrate - rk4 through the fused plant (one K2 Car launch),
     the fixture GP's validate (one K3 launch), SMSE within 1.5x of the
     port's f64 validation on the CPU; K2 Car and K3 (k*, mean, and the
     variance formed from k*) against their plain versions on the
     validation's own inputs;
 14. the batched closed-loop study (bench config 5, bench.py:400-454) at
     full width: the pinned fixture GP, capacity 128, saturate, Nt=8,
     al1 x mi3 x ls4, f32, B=1024 rollouts from (8, 9, 1, 1) + 0.5 U(0, 1)
     to (12.4, 12.7, 1.8, 1.4) with process noise; (a) as the JAX
     package runs it (unfused plant, sequential KKT, no kernel):
     study_rollout_solves_per_s as bench.py defines it (B over the wall
     slope between a 12- and a 4-step run) and ms per control step by
     CUDA events, finite values, every posterior conditioned on the card
     on a novel transition and held against the CPU, a per-step CPU
     replay of four rollouts, a profile of three steps; (b) the same with
     fused_kkt and the fused plant: K1 exactly 3 launches per control
     step and K2 1, each for all 1024 rollouts, its mean cost within
     STUDY_COST_RTOL of (a)'s; (c) save_study, load_study (bitwise) and a
     resumed run on the card.
Phases 12-14 run before phase 11, whose JSON rows carry their launch
counts (K1 at (1024, 8, 4, 2) and K2 at B=1024 get rows of their own).
The last three lines are the card's name and power limit (nvidia-smi), a
JSON object with the kernels' rows, and {"ok": true, "device": {...}}.

``python3 chip_smoke.py --panel [--steps 140]`` instead measures the
quality gate: the realized-cost ratio RTI / converged over each initial
state of ``benchmarks.bench_spec.X0_PANEL`` (one process per state, all on
the one card), and its median, which must be <= 1.01.
``python3 chip_smoke.py --large-fit`` times the fixture's fit recipe at
N = 500 and 1000 training points through K5 and through cuSOLVER, and
validates each K5 fit on 1000 noise-free held-out points (one K2 launch
for the data, one K3 launch per validate; SMSE per dim, the validate wall
time and K3's device time at that shape);
``python3 chip_smoke.py --k5-paths`` measures K5's two paths against
each other (the crossover ``gp_cuda`` sets);
``python3 chip_smoke.py --compare {k1,k2,k3,k4} OTHER_SRC`` builds OTHER_SRC
(another version of that kernel's source with the same C interface, e.g.
the parent commit's, written out with ``git show``) into its own library,
checks it against the plain version, and times it in turns with the
repository's kernel (other, repo, repo, other) at phase 11's shapes; for
k2 it also writes both builds' SASS (cuobjdump) under the build
directory, counts the K2 kernels' instructions by opcode and reads the
repository K2's chain in SM cycles;
``python3 chip_smoke.py --k1 [OTHER_SRC]`` runs phase 3's K1 and K2 checks
and phase 11's K1 lines alone, and with OTHER_SRC is ``--compare k1``;
``python3 chip_smoke.py --study`` runs phases 1-2 and 14 and the study's
kernel rows alone;
``python3 chip_smoke.py --build-times`` times the kernels' build, one
``nvcc`` over all sources against one per source at once.
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
#: steps of phase 5's converged (al4 x mi20) anchor, compared with the
#: first ANCHOR_STEPS of the RTI loop: cut from N_STEPS to make room for
#: the car's phases within the smoke's time
ANCHOR_STEPS = 3
RTI = dict(al_iters=2, max_iters=2, ls_steps=8, penalty_init=1e3,
           fused_kkt=True)
CONVERGED = dict(al_iters=4, max_iters=20, fused_kkt=True)
#: the f32-safe GP recipe of benchmarks/make_bench_fixture.py
GP_OPTS = dict(jitter=1e-5, min_noise=1e-4)
#: one H100 SXM: HBM bytes/s and f32 (non-tensor-core) FLOP/s, published
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
#: the car bench (bench config 4): control period, the closed loop's steps
#: (both obstacles are behind the car by step ~30), the steps replayed on
#: the CPU besides the first ones, and the clearance floor of this smoke
#: (below the JAX package's own f64 reading, 0.946, far above a loop that
#: drives through an obstacle, ~0.1-0.5); bench.py's gate is 0.995
CAR_DT = 0.1
CAR_STEPS = 40
CAR_NEAREST = 3
CAR_CLEARANCE_FLOOR = 0.9
CAR_BENCH_GATE = 0.995
#: bound of the car replay's next-state difference, card vs CPU, per step
#: (max |diff| / (1 + |x|)): the replayed steps read 7.0e-9 to 7.3e-6 on
#: an H100 80GB HBM3 at 700 W, the same in three runs; a solve whose
#: acceleration is off by 0.1 moves the next state by ~3e-3
CAR_REPLAY_TOL = 1e-4
#: max abs errors of the car instantiations against their plain versions
#: at the car paths' shapes: K1 at (6, 2), Nt=20, B=1 (the loop), the K2
#: Car functor at B=200 (the validation)
CAR_ERRS = {}


#: the smoke's start, for the elapsed seconds at the head of each log line
T0 = time.perf_counter()


def log(msg):
    print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


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


#: said beside a device time whose first profiler window showed no device
#: event, so that the window was run again
REPEATED = " (profiler window repeated: the first showed no device event)"


def device_launches_us(fn, reps, warmup=3):
    """Durations in µs of the device kernels that ``reps`` calls of ``fn``
    launch after ``warmup`` calls, from torch.profiler's kernel events, and
    REPEATED or "": a window that shows no device event is run once more."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(2):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type.name == "CUDA"]
        if us:
            break
    return us, REPEATED if attempt else ""


def device_time_ms(fn, reps=200, warmup=3):
    """Device time per call of ``fn``, device kernels per call over
    ``reps`` calls and the window's note (REPEATED or ""); None for the
    time when two windows showed no device event."""
    us, note = device_launches_us(fn, reps, warmup)
    if not us:
        return None, 0, note
    return sum(us) / reps / 1e3, len(us) / reps, note


def launch_ms(fn, reps):
    """Mean and median device ms of the one kernel that ``fn`` launches,
    over ``reps`` calls, and the window's note (REPEATED or ""); None for
    the times when two windows showed no device event."""
    us, note = device_launches_us(fn, reps)
    if not us:
        return None, None, note
    return float(np.mean(us)) / 1e3, float(np.median(us)) / 1e3, note


class SmiSampler:
    """nvidia-smi's SM clock (MHz) and power draw (W), sampled every 50 ms
    by a child process while the ``with`` block runs."""

    def __enter__(self):
        self.rows = []
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "50"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        for line in out.splitlines():
            try:
                self.rows.append([float(v) for v in line.split(",")])
            except ValueError:
                pass
        return False

    def summary(self):
        if not self.rows:
            return "no nvidia-smi samples"
        a = np.array(self.rows)
        return (f"SM clock {a[:, 0].min():.0f} / {np.median(a[:, 0]):.0f} / "
                f"{a[:, 0].max():.0f} MHz, power draw {a[:, 1].min():.1f} / "
                f"{np.median(a[:, 1]):.1f} / {a[:, 1].max():.1f} W (min / "
                f"median / max of {len(a)} samples)")


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


def log_ptxas(ck):
    """The build's ptxas lines: each kernel's entry name, registers, and
    spills."""
    for line in ck.BUILD_INFO["log"].splitlines():
        if ("registers" in line or "spill" in line
                or "Compiling entry function" in line):
            log(f"[build] {line.strip()}")


def check_kernels(ck, four_tank_ode, dev):
    """K1 and K2 against their plain versions on the card (tolerances in
    ``cuda_kernels.check_*``); returns their max abs errors at the main
    path's shapes."""
    k1_err = None
    # the JAX package's kernel-test shapes, a horizon that crosses K1's
    # shared-memory chunks nine times, and the batched study's width
    for nt, nx, nu, seed, batch in [(20, 4, 2, 0, None), (13, 5, 3, 1, None),
                                    (8, 2, 1, 2, None), (300, 4, 2, 3, None),
                                    (20, 4, 2, 4, 1024), (8, 4, 2, 5, 1024)]:
        err = ck.check_riccati_sweep(
            ck.stage_qp_inputs(nt, nx, nu, seed, batch, device=dev),
            torch.full(() if batch is None else (batch,), 1e-6, device=dev))
        log(f"[K1] B={batch or 1}, (Nt,nx,nu)=({nt},{nx},{nu}) max|err| "
            f"{err:.3e}")
        k1_err = err if k1_err is None else k1_err
    # the car's (6, 2) (4 states + the previous input): its path's Nt=20 at
    # one problem and a batch, and a horizon across the chunks
    for nt, batch in [(20, None), (20, 64), (300, None)]:
        err = ck.check_riccati_sweep(
            ck.stage_qp_inputs(nt, 6, 2, nt + 6, batch, device=dev),
            torch.full(() if batch is None else (batch,), 1e-6, device=dev))
        log(f"[K1] B={batch or 1}, (Nt,nx,nu)=({nt},6,2) max|err| {err:.3e}")
        if (nt, batch) == (20, None):
            CAR_ERRS["riccati_sweep"] = err
    # bad pivots without regularization: non-finite gains, so ok=False
    # upstream
    for kind in ("indefinite", "zero"):
        for shape in (None, (20, 6, 2)):
            ck.check_riccati_sweep_bad_pivot(kind, device=dev, shape=shape)
            torch.cuda.synchronize()
            log(f"[K1] {kind} H_uu pivot at (Nt,nx,nu)="
                f"{shape or ('default',)} -> non-finite gains: ok")
    k2_err = None
    # the main path's rollout, a batch (also through the run-time loop, a
    # drained tank on the clamp), the batched study's width
    for batch, n_sub in [(None, 10), (8, 10), (8, 7), (1024, 10)]:
        x, u = ck.rk4_inputs(batch, batch or 1, dev)
        err = ck.check_rk4_substeps(four_tank_ode, x, u, 0.3, n_sub)
        log(f"[K2] batch={batch or 1}, n_sub={n_sub} max|err| {err:.3e} "
            f"(rtol 1e-5, atol 1e-6: rsqrt form, FMA contraction)")
        k2_err = err if k2_err is None else k2_err
    # the Car functor: one rollout, the car validation's 200, the batched
    # width; steering at +-0.5 rad and headings past +-pi in the batches
    from gpmpc_tpu_torch.systems import car_ode
    for batch in (None, 200, 1024):
        x, u = ck.car_inputs(batch, batch or 1, dev)
        err = ck.check_rk4_substeps(car_ode, x, u, CAR_DT / 10, 10)
        log(f"[K2 car] batch={batch or 1}, n_sub=10 max|err| {err:.3e} "
            f"(rtol 1e-5, atol 1e-6)")
        if batch == 200:
            CAR_ERRS["rk4_substeps"] = err
    torch.cuda.synchronize()
    return k1_err, k2_err



def build_plant(dev):
    from benchmarks.bench_spec import DT, MODEL_R
    from gpmpc_tpu_torch import Model
    from gpmpc_tpu_torch.systems import four_tank_ode

    return Model(Nx=4, Nu=2, ode=four_tank_ode, dt=DT, R=MODEL_R,
                 clip_negative=True, integrator_substeps=10,
                 fused_integrator=True, device=dev, dtype=torch.float32)


def build_slice(dev, solver_opts, gp=None):
    """The main path's controller, with the pinned fixture GP unless ``gp``
    is given."""
    from benchmarks.bench_spec import NT, Q_W, R_W, ULB, UUB, XLB, XSP, XUB
    from gpmpc_tpu_torch import MPC
    from gpmpc_tpu_torch.models.convert import gp_from_fixture

    model = build_plant(dev)
    if gp is None:
        gp = gp_from_fixture(device=dev, dtype=torch.float32, gp_method="TA",
                             optimizer_opts=GP_OPTS)
    return MPC(horizon=NT * model.dt, model=model, gp=gp, gp_method="TA",
               discrete_method="gp", Q=Q_W, R=R_W, ulb=ULB, uub=UUB,
               xlb=XLB, xub=XUB, percentile=0.95, feedback=True,
               cov_updates=1, op_x=XSP, op_u=np.array([3.0, 3.0]),
               solver_opts=solver_opts, device=dev)


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
    tightening on): replay the N_STEPS-step closed loop on the card
    through ``solve_step`` and, at every step, solve the same step on
    the CPU from the card's state, warm start and last input, with the
    card's GP posterior and feedback gain.  The next states must agree
    within rtol 1e-3 once the loop tracks the setpoint, and 1e-2 in the
    saturated transient.

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


def profile_steps(step, n=3, cpu_ops=True):
    """torch.profiler over ``n`` calls of ``step``: device kernels and
    device ms per call (the device rows alone: a CPU op's row repeats the
    time of the kernels it launched), the share of the wall time the
    device is busy, and the top rows by device time (with ``cpu_ops`` the
    aten ops beside the kernels; without, the kernels alone, which keeps
    the trace small enough to read back quickly for a long step)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu_ops
                                      else [])
    for attempt in range(2):        # a window with no device event: again
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
            for _ in range(n):
                step()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ev = prof.key_averages()
        device = [e for e in ev if e.device_type.name == "CUDA"]
        dev_us = sum(e.self_device_time_total for e in device)
        if dev_us > 0:
            break
    all_us = sum(e.self_device_time_total for e in ev)
    kernels = sum(e.count for e in device if e.self_device_time_total > 0)
    if dev_us <= 0:
        raise AssertionError("the profiler saw no device time")
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:6]
    return dict(kernels_per_step=kernels / n, device_ms_per_step=dev_us / n
                / 1e3, all_rows_ms_per_step=all_us / n / 1e3,
                wall_ms_per_step=wall / n * 1e3,
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


def large_fit(ns=(500, 1000)):
    """The fixture's recipe at larger training sets, where K5 takes its
    blocked path: for each N, four-tank training data from the fused plant
    (TRAIN_* bounds, noise, generator seed 2), then ``GP(X, Y)`` on the
    card twice, once through K5 and once with K5's plain version (cuSOLVER
    through ``cholesky_ex``) in its place, plus both factors' times at P=4
    (one evaluation's Cholesky) and K5's device kernels per call.  Prints
    wall seconds, batched evaluations and ms per evaluation of each fit,
    and validates the fit through K5 (:func:`validate_large`)."""
    from benchmarks.bench_spec import TRAIN_ULB, TRAIN_UUB, TRAIN_XLB, \
        TRAIN_XUB
    from gpmpc_tpu_torch import GP
    from gpmpc_tpu_torch.ops import cuda_kernels as ck
    from gpmpc_tpu_torch.ops import gp_cuda as gc

    card = card_line()
    dev = torch.device("cuda")
    k5 = gc.cholesky
    for n in ns:
        x, y = build_plant(dev).generate_training_data(
            n, uub=TRAIN_UUB, ulb=TRAIN_ULB, xub=TRAIN_XUB, xlb=TRAIN_XLB,
            generator=torch.Generator(device=dev).manual_seed(2))
        a = gc.spd_inputs(n, 4, n, device=dev)
        dev_ms, kern, note = device_time_ms(lambda: k5(a))
        lib = cuda_time_ms(lambda: torch.linalg.cholesky_ex(a), 5)
        log(f"[large] N={n}, P=4: K5 ({k5_path(gc, n)}) "
            f"{cuda_time_ms(lambda: k5(a), 5):.3f} ms, device "
            f"{fmt_ms(dev_ms)}{note} in {kern:.0f} device kernels per K5 "
            f"call; "
            f"cholesky_ex {lib:.3f} ms on {card}")
        for route in ("K5", "cholesky_ex"):
            gc.cholesky = k5 if route == "K5" else gc.cholesky_reference
            try:
                ck.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                gp = GP(x, y, mean_func="zero", gp_method="TA", multistart=1,
                        max_iters=100, optimizer_opts=GP_OPTS, device=dev,
                        dtype=torch.float32)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                gc.cholesky = k5
            log(f"[large] N={n} fit through {route}: {wall:.3f} s wall, "
                f"{gp.n_evals} batched evaluations, "
                f"{1e3 * wall / gp.n_evals:.3f} ms per evaluation; K4 "
                f"launches {ck.LAUNCHES['se_ard_gram']}, K5 launches "
                f"{ck.LAUNCHES['cholesky']} on {card}")
            if route == "K5":
                validate_large(ck, gc, dev, gp, n, card)
    return 0


def validate_large(ck, gc, dev, gp, n, card, b=1000):
    """--large-fit's validation of the GP fitted at ``n`` points: ``b``
    noise-free held-out points from the fused plant (TRAIN_* bounds,
    generator seed 9; one K2 launch), ``gp.validate`` (one K3 launch at
    (Ny, B, N, D) = (4, b, n, 6)); finite SMSE per dim, the validate wall
    time and K3's device time at that shape on the GP's own posterior."""
    from benchmarks.bench_spec import TRAIN_ULB, TRAIN_UUB, TRAIN_XLB, \
        TRAIN_XUB

    ck.reset_launches()
    xt, yt = build_plant(dev).generate_training_data(
        b, uub=TRAIN_UUB, ulb=TRAIN_ULB, xub=TRAIN_XUB, xlb=TRAIN_XLB,
        noise=False, generator=torch.Generator(device=dev).manual_seed(9))
    torch.cuda.synchronize()
    data = dict(ck.LAUNCHES)
    ck.reset_launches()
    t0 = time.perf_counter()
    smse, mnlp, _ = gp.validate(xt, yt, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    post, norm = gp.post, gp.norm
    args = [t.contiguous() for t in (
        (xt - norm.z_mean) / norm.z_std, post.x,
        torch.exp(post.hypers.log_ell), torch.exp(post.hypers.log_sf2),
        post.alpha)]
    dev_ms = launch_ms(lambda: gc.gp_predict_batch(*args), 200)
    log(f"[large] N={n} validation on {b} held-out points: SMSE per dim "
        f"{smse.tolist()}, MNLP {mnlp.tolist()}; validate {1e3 * wall:.3f} "
        f"ms wall; K3 at (Ny,B,N,D)=(4,{b},{n},6) device per launch "
        f"mean/median {fmt_pair(dev_ms)}; launches: held-out data {data}, "
        f"validate {launches} on {card}")
    none = dict.fromkeys(ck.LAUNCHES, 0)
    if data != dict(none, rk4_substeps=1) or \
            launches != dict(none, gp_predict_batch=1):
        raise AssertionError(f"launch counts {data}, {launches}")
    if not (np.all(np.isfinite(smse)) and np.all(np.isfinite(mnlp))):
        raise AssertionError(f"non-finite validation at N={n}")


#: (N, P) at which --k5-paths compares K5's paths
K5_PATH_SHAPES = ((100, 4), (100, 8), (128, 4), (128, 8), (160, 4), (160, 8),
                  (200, 4), (200, 8), (256, 4), (256, 8), (330, 4), (330, 8),
                  (500, 4), (500, 8), (1000, 4), (1024, 1), (2048, 1))


def k5_paths():
    """Device time per call (torch.profiler) of K5's one-block path (where
    the matrix fits in shared memory) and of its blocked path, beside
    cholesky_ex's, at K5_PATH_SHAPES: the measurements that set
    gp_cuda.CHOL_ONE_BLOCK_MAX_N."""
    from gpmpc_tpu_torch.ops import gp_cuda as gc

    card = card_line()
    dev = torch.device("cuda")
    keep = gc.CHOL_ONE_BLOCK_MAX_N
    try:
        for n, p in K5_PATH_SHAPES:
            a = gc.spd_inputs(n, p, n, device=dev)
            routes = [("one-block", n)] if n <= 330 else []
            routes += [("blocked", 0)]
            cells = []
            for name, max_n in routes:
                gc.CHOL_ONE_BLOCK_MAX_N = max_n
                gc.check_cholesky(a)
                ms, _, note = device_time_ms(lambda: gc.cholesky(a))
                cells.append(f"{name} {fmt_ms(ms)}{note}")
            lib, _, note = device_time_ms(
                lambda: torch.linalg.cholesky_ex(a))
            log(f"[k5] P={p} N={n} device time per call: {', '.join(cells)}, "
                f"cholesky_ex {fmt_ms(lib)}{note} on {card}")
    finally:
        gc.CHOL_ONE_BLOCK_MAX_N = keep
    return 0


def build_times():
    """Seconds to build the kernels' library in an empty directory, two
    ways in the order serial, parallel, parallel, serial: one ``nvcc`` over
    every source, and ``build_library``'s one ``nvcc`` per source at once
    plus a link."""
    import shutil
    from gpmpc_tpu_torch.ops import cuda_kernels as ck

    sources = [str(s) for s in sorted(ck.CSRC.glob("*.cu"))]
    home, root = ck.BUILD_DIR, ck.BUILD_DIR / "build_times"
    try:
        for way in ("serial", "parallel", "parallel", "serial"):
            shutil.rmtree(root, ignore_errors=True)
            root.mkdir(parents=True)
            t0 = time.perf_counter()
            if way == "serial":
                subprocess.run([ck._nvcc(), *ck.NVCC_FLAGS, "-shared", "-o",
                                str(root / "lib.so"), *sources], check=True,
                               capture_output=True)
            else:
                ck._lib, ck.BUILD_DIR = None, root
                ck.build_library()
            log(f"[build] {way}: {time.perf_counter() - t0:.2f} s for "
                f"{len(sources)} sources")
    finally:
        ck._lib, ck.BUILD_DIR = None, home
        shutil.rmtree(root, ignore_errors=True)
    return 0


def check_gp_kernels(gc, dev):
    """K4, K5 and K3 against their plain versions on the card at the JAX
    package's kernel-test shapes (tolerances in ``gp_cuda.check_*``), and
    K5's NaN for a matrix that is not positive definite; returns the max
    abs errors at the training and validation paths' shapes."""
    errs = {}
    # the JAX package's shapes, the car posterior's, the large-fit and
    # one-matrix shapes, and D past one feature chunk (ell scaled by
    # sqrt(D): K not 0)
    for p, n, d in [(8, 40, 6), (8, 100, 6), (8, 200, 12), (8, 130, 3),
                    (4, 80, 6), (1, 101, 6), (4, 1000, 6), (1, 2048, 6),
                    (2, 100, 257), (1, 300, 300)]:
        err = gc.check_se_ard_gram(*gc.gram_inputs(
            n, d, p, n + d, device=dev,
            ell_scale=np.sqrt(d) if d > gc.GRAM_DCHUNK else 1.0), 1e-6)
        log(f"[K4] (P,N,D)=({p},{n},{d}) max|err| {err:.3e} (rtol, atol "
            f"2e-5; exactly symmetric, diagonal bitwise)")
        if (p, n, d) == (8, 100, 6):
            errs["se_ard_gram"] = err
    for n, p in [(16, 8), (80, 4), (100, 8), (128, 8), (200, 8), (330, 4),
                 (331, 4), (500, 4), (1000, 4), (1024, 1), (2048, 1),
                 (4097, 1)]:
        err = gc.check_cholesky(gc.spd_inputs(n, p, n, device=dev))
        log(f"[K5] (P,N)=({p},{n}) {k5_path(gc, n)} path: max|err| against "
            f"the plain version in f64 {err:.3e} (atol 2e-4 max|L|)")
        if n == 100:
            errs["cholesky"] = err
    a = gc.spd_inputs(100, 2, 1, device=dev)
    a[1, 40, 40] = -1e4
    gc.check_cholesky_not_pd(a[1:])
    log(f"[K5] {k5_path(gc, 100)} path, not positive definite -> NaN lower "
        f"triangle: ok")
    # the blocked path: a bad pivot in the last panel of the middle matrix
    a = gc.spd_inputs(1000, 3, 3, device=dev)
    a[1, 999, 999] = -1e4
    l = gc.cholesky(a)
    gc.check_cholesky_not_pd(a[1:2])
    for m in (0, 2):
        if not bool(torch.all(torch.isfinite(l[m]))):
            raise AssertionError("K5 gave NaN in a matrix beside a bad one")
        gc.check_cholesky(a[m:m + 1].contiguous())
    log(f"[K5] {k5_path(gc, 1000)} path, (P,N)=(3,1000), bad pivot in the "
        f"last panel of the middle matrix -> NaN in its lower triangle only:"
        f" ok")
    # the JAX package's shapes, the large-fit and the car validations', a
    # ragged one (N % 4 != 0: 4-byte stores) and D past one and many
    # feature chunks
    for ny, b, n, d in K3_CHECK_SHAPES:
        err = gc.check_gp_predict_batch(*gc.predict_inputs(
            n, d, b, ny, b, device=dev,
            ell_scale=np.sqrt(d) if d > 6 else 1.0))
        log(f"[K3] (Ny,B,N,D)=({ny},{b},{n},{d}) max|err| k* {err:.3e} (k* "
            f"2e-5, mu 2e-4)")
        if (ny, b, n, d) == (4, 100, 100, 6):
            errs["gp_predict_batch"] = err
    torch.cuda.synchronize()
    return errs


#: (Ny, B, N, D) at which phase 7 holds K3 against its plain version
K3_CHECK_SHAPES = ((4, 33, 90, 6), (4, 100, 100, 6), (4, 1000, 1000, 6),
                   (4, 200, 80, 6), (3, 37, 101, 6), (4, 19, 130, 65),
                   (2, 33, 101, 300))


def k5_path(gc, n):
    """Which of K5's paths factors a matrix of order ``n``."""
    return "one-block" if n <= gc.CHOL_ONE_BLOCK_MAX_N else "blocked"


def fixture_nll_f64(hyper):
    """NLL per dim of the log hypers ``(log_ell, log_sf2, log_sn2)`` on the
    fixture's normalized training set, in f64 on the CPU through the plain
    versions."""
    from gpmpc_tpu_torch.models import gp_core
    from gpmpc_tpu_torch.models.convert import FIXTURE
    from gpmpc_tpu_torch.utils.config import GPConfig

    f = np.load(FIXTURE)
    f64 = dict(dtype=torch.float64)
    x, y = (torch.tensor(f[k], **f64) for k in ("tank_X", "tank_Y"))
    xn = (x - x.mean(0)) / x.std(0, correction=0)
    yn = (y - y.mean(0)) / y.std(0, correction=0)
    h = [torch.as_tensor(np.asarray(v.cpu() if torch.is_tensor(v) else v),
                         **f64) for v in hyper]
    return gp_core.nll_batch(*h, torch.zeros((4, 0), **f64), xn, yn.mT,
                             GPConfig(**GP_OPTS), "zero").numpy()


def train_on_card(ck, dev, name, recipe):
    """Phase 8: GP(tank_X, tank_Y) trained on the card with ``recipe``;
    exact launch counts, NLL per dim (f64, CPU) within 0.1 of the fixture
    hypers'.  Returns the GP and its launch counts."""
    from gpmpc_tpu_torch import GP
    from gpmpc_tpu_torch.models.convert import FIXTURE

    f = np.load(FIXTURE)
    ck.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gp = GP(f["tank_X"], f["tank_Y"], mean_func="zero", gp_method="TA",
            optimizer_opts=GP_OPTS, device=dev, dtype=torch.float32,
            **recipe)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    expect = {"riccati_sweep": 0, "rk4_substeps": 0,
              "se_ard_gram": gp.n_evals + 1, "cholesky": gp.n_evals + 3,
              "gp_predict_batch": 0}
    log(f"[train] {name} recipe {recipe}: {wall:.3f} s wall, {gp.n_evals} "
        f"batched objective evaluations ({recipe['multistart'] * 4} problems "
        f"each); launches {launches}")
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")
    nll = fixture_nll_f64(gp.hyper[:3])
    ref = fixture_nll_f64([f[f"tank_log_{k}"] for k in ("ell", "sf2",
                                                          "sn2")])
    gap = np.abs(nll - ref)
    log(f"[train] {name}: NLL per dim (f64 on the CPU) {nll.tolist()}, "
        f"fixture hypers {ref.tolist()}, max gap {gap.max():.4f} (<= 0.1)")
    if not (np.all(np.isfinite(nll)) and gap.max() <= 0.1):
        raise AssertionError(f"the {name} fit's NLL is off the fixture's")
    return gp, launches


def validate_on_card(ck, dev, gp):
    """Phase 9: held-out data from the fused plant, validate of the
    card-trained and the fixture GP; SMSE within 1.5x per dim.  Returns
    the validation's launch counts."""
    from benchmarks.bench_spec import TRAIN_ULB, TRAIN_UUB, TRAIN_XLB, \
        TRAIN_XUB
    from gpmpc_tpu_torch.models.convert import gp_from_fixture

    ck.reset_launches()
    xt, yt = build_plant(dev).generate_training_data(
        100, uub=TRAIN_UUB, ulb=TRAIN_ULB, xub=TRAIN_XUB, xlb=TRAIN_XLB,
        noise=False, generator=torch.Generator(device=dev).manual_seed(9))
    if ck.LAUNCHES["rk4_substeps"] != 1:
        raise AssertionError(f"held-out data: launches {ck.LAUNCHES}")
    fixture = gp_from_fixture(device=dev, dtype=torch.float32,
                              gp_method="TA", optimizer_opts=GP_OPTS)
    ck.reset_launches()
    smse_t, mnlp_t, _ = gp.validate(xt, yt, verbose=False)
    smse_f, mnlp_f, _ = fixture.validate(xt, yt, verbose=False)
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    log(f"[validate] held-out SMSE card-trained {smse_t.tolist()}, fixture "
        f"{smse_f.tolist()}; MNLP {mnlp_t.tolist()} vs {mnlp_f.tolist()}; "
        f"launches {launches}")
    expect = {"riccati_sweep": 0, "rk4_substeps": 0, "se_ard_gram": 0,
              "cholesky": 0, "gp_predict_batch": 2}
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")
    if not (np.all(np.isfinite(mnlp_t)) and np.all(smse_t <= 1.5 * smse_f)):
        raise AssertionError("the card-trained GP validates worse than 1.5x "
                             "the fixture GP's SMSE")
    return launches


def build_car(dev):
    """The car bench (bench.py:266-330) in the port: the pinned car fixture
    GP (N=80, D=6, Ny=4, zero mean), EM propagation, the hybrid
    discretization, the delta-u penalty S, both ellipse obstacles with
    scale 2, chance tightening and LQR feedback at x0, Nt=20, the RTI
    preset, f32.  The plant is unfused, as in the bench."""
    from gpmpc_tpu_torch import MPC, Model
    from gpmpc_tpu_torch.models.convert import gp_from_fixture
    from gpmpc_tpu_torch.systems import (CAR_OBSTACLES, CAR_U_LB, CAR_U_UB,
                                         CAR_X0, car_ode,
                                         ellipse_obstacle_constraints)
    model = Model(Nx=4, Nu=2, ode=car_ode, dt=CAR_DT,
                  R=np.diag([1e-5, 1e-5, 1e-6, 1e-5]), integrator_substeps=10,
                  device=dev, dtype=torch.float32)
    gp = gp_from_fixture(prefix="car", device=dev, dtype=torch.float32,
                         gp_method="EM")
    cb, n_par = ellipse_obstacle_constraints(len(CAR_OBSTACLES), scale=2.0)
    return MPC(horizon=20 * CAR_DT, model=model, gp=gp, gp_method="EM",
               discrete_method="hybrid", Q=np.diag([5.0, 20.0, 0.5, 1.0]),
               R=np.diag([0.1, 1.0]), S=np.diag([0.05, 0.5]), ulb=CAR_U_LB,
               uub=CAR_U_UB, xlb=[-5.0, -4.0, -2.0, 0.0],
               xub=[25.0, 4.0, 2.0, 10.0], percentile=0.95, feedback=True,
               op_x=CAR_X0, inequality_constraints=cb, num_con_par=n_par,
               cov_updates=1, solver_opts="rti", device=dev)


def car_metric(xs):
    """The bench's ellipse metric (bench.py:333-341) per state and
    obstacle, ((px - cx)/rx)^2 + ((py - cy)/ry)^2 (>= 1 outside): (T, 2)."""
    from gpmpc_tpu_torch.systems import CAR_OBSTACLES
    xs = np.asarray(xs, np.float64)
    return np.stack([((xs[:, 0] - cx) / rx) ** 2 + ((xs[:, 1] - cy) / ry) ** 2
                     for cx, cy, rx, ry in CAR_OBSTACLES], axis=1)


class StepRecorder:
    """Wraps a controller's ``_solve_step`` while ``MPC.solve`` runs: keeps
    each loop step's inputs (warm start, state, last input, constraint
    parameters), the last step's output state, and a CUDA event at the
    start of each step.  The cold-start preparation (which
    passes ``cfg``) is not recorded."""

    def __init__(self, mpc):
        self.calls, self.events, self.last = [], [], None
        inner = mpc._solve_step

        def solve_step(warm, x0, x_sp, u_prev, sigma0, con_par, consts,
                       cfg=None):
            if cfg is None:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                self.events.append(ev)
                self.calls.append((warm, x0, u_prev, con_par))
            out = inner(warm, x0, x_sp, u_prev, sigma0, con_par, consts,
                        cfg=cfg)
            if cfg is None:
                self.last = out[0]
            return out

        mpc._solve_step = solve_step


def car_replay_steps(xs, n_first=4, nearest=CAR_NEAREST):
    """The steps the car replay holds: the first ``n_first``, and the
    ``nearest`` steps after them whose next state is nearest each
    obstacle."""
    metric = car_metric(xs[1:])
    steps = set(range(n_first))
    for o in range(metric.shape[1]):
        order = [k for k in np.argsort(metric[:, o]) if k >= n_first]
        steps.update(int(k) for k in order[:nearest])
    return sorted(steps)


def car_replay(mpc, rec, xs, us, dev):
    """Per-step check of the card against the CPU on the car: at each of
    :func:`car_replay_steps`, solve the step on the CPU in f32 from the
    card's state, warm start, last input and obstacle parameters, with the
    card's posterior, gain and bounds, and step the CPU plant.  Returns
    (step, max |next-state difference| / (1 + |x|), |u difference|) rows.

    The car is chaotic under last-ulp reordering (a reordered sum changes
    the line search's choices), so it is held step by step, not as a
    trajectory, within CAR_REPLAY_TOL."""
    from gpmpc_tpu_torch.solvers.al_sqp import SolverState
    from gpmpc_tpu_torch.systems import CAR_XSP
    cpu = build_car(torch.device("cpu"))
    cpu.consts = to_cpu(mpc.consts)
    rows = []
    for k in car_replay_steps(xs):
        warm, x, u_prev, par = rec.calls[k]
        u_c, _, _, _ = cpu.solve_step(
            x.cpu(), CAR_XSP, warm=SolverState(*(t.cpu() for t in warm)),
            u_prev=u_prev.cpu(), con_par=par.cpu())
        x_c = cpu.model.integrate(x.cpu(), u_c).numpy()
        rel = float(np.max(np.abs(xs[k + 1] - x_c) / (1.0 + np.abs(x_c))))
        rows.append((k, rel, float(np.max(np.abs(us[k] - u_c.numpy())))))
    return rows


def car_loop(ck, dev, card):
    """Phase 12: the car bench's closed loop on the card, CAR_STEPS steps
    from x0 through ``MPC.solve`` with the obstacles as ``con_par``: exact
    launch counts (the posterior's one K4 and three K5, K1 at (6, 2) once
    per inner SQP step, no K2: the plant is unfused), finite values, px
    past the second obstacle, the clearance, ten steps replayed on the CPU
    (:func:`car_replay`), ms per control step by CUDA events and a
    torch.profiler trace of three steps (device activity only: with the
    CPU ops, reading back a car step's trace took minutes).  Returns the
    loop's launches."""
    from gpmpc_tpu_torch.systems import CAR_OBSTACLES, CAR_X0, CAR_XSP
    ck.reset_launches()
    mpc = build_car(dev)
    rec = StepRecorder(mpc)
    par = CAR_OBSTACLES.reshape(-1)
    t0 = time.perf_counter()
    xs, us = mpc.solve(CAR_X0, CAR_STEPS * CAR_DT, CAR_XSP, noise=False,
                       con_par_func=lambda k: par)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    cfg, init = mpc.sqp_cfg, mpc.init_sqp_cfg
    per_step = cfg.al_iters * cfg.max_iters
    cold = init.al_iters * init.max_iters if init.fused_kkt else 0
    expect = {"riccati_sweep": CAR_STEPS * per_step + cold,
              "rk4_substeps": 0, "se_ard_gram": 1, "cholesky": 3,
              "gp_predict_batch": 0}
    log(f"[car] {CAR_STEPS}-step closed loop (EM, hybrid, delta-u, two "
        f"obstacles, Nt=20, RTI al{cfg.al_iters} x mi{cfg.max_iters}, f32) "
        f"on the card: {wall:.3f} s (cold start included); launches "
        f"{launches}, expected {expect} (K1 {per_step} a step, {cold} in "
        f"the unfused cold start)")
    if launches != expect:
        raise AssertionError(f"car launch counts {launches} != {expect}")
    xs, us = xs.cpu().numpy(), us.cpu().numpy()
    if xs.shape != (CAR_STEPS + 1, 4) or us.shape != (CAR_STEPS, 2):
        raise AssertionError(f"car shapes {xs.shape}, {us.shape}")
    run = mpc.last_run
    if not (np.all(np.isfinite(xs)) and np.all(np.isfinite(us))
            and np.all(np.isfinite(run["obj"]))):
        raise AssertionError("non-finite car closed loop")
    far_edge = CAR_OBSTACLES[1, 0] + CAR_OBSTACLES[1, 2]
    metric = car_metric(xs)
    clear = metric.min(axis=0)
    log(f"[car] final state {xs[-1].tolist()}; px {xs[-1, 0]:.4f} (> "
        f"{far_edge}, the second obstacle's far edge); max |defect| "
        f"{float(np.max(run['defect'])):.3e}, max violation "
        f"{float(np.max(run['con_viol'])):.3e}, converged "
        f"{int(run['converged'].sum())}/{CAR_STEPS}")
    log(f"[car] clearance (min ellipse metric, >= 1 outside): obstacle 1 "
        f"{clear[0]:.5f} at step {int(metric[:, 0].argmin())}, obstacle 2 "
        f"{clear[1]:.5f} at step {int(metric[:, 1].argmin())}; min "
        f"{clear.min():.5f}: bench gate {CAR_BENCH_GATE} "
        f"{'met' if clear.min() >= CAR_BENCH_GATE else 'not met'} "
        f"(information), this smoke's floor {CAR_CLEARANCE_FLOOR} "
        f"{'met' if clear.min() >= CAR_CLEARANCE_FLOOR else 'NOT met'}")
    if xs[-1, 0] <= far_edge or clear.min() < CAR_CLEARANCE_FLOOR:
        raise AssertionError("the car did not pass both obstacles clear")
    ev = rec.events
    step_ms = [ev[k].elapsed_time(ev[k + 1]) for k in range(4, len(ev) - 1)]
    log(f"[time] car control step (solve + plant step), CUDA events between "
        f"step starts {4}..{len(ev) - 1}: mean {np.mean(step_ms):.3f} ms, "
        f"median {np.median(step_ms):.3f}, min {np.min(step_ms):.3f}, max "
        f"{np.max(step_ms):.3f} ms/step on {card}")
    t0 = time.perf_counter()
    rows = car_replay(mpc, rec, xs, us, dev)
    near = set(car_replay_steps(xs)) - set(range(4))
    worst = max(r[1] for r in rows)
    for k, rel, du in rows:
        log(f"[car] replay step {k:2d}: next state card vs CPU max "
            f"|diff|/(1+|x|) {rel:.3e}, |u diff| {du:.3e}"
            f"{' (near an obstacle)' if k in near else ''}")
    log(f"[car] per-step replay of {len(rows)} steps against the CPU "
        f"({time.perf_counter() - t0:.1f} s): worst {worst:.3e} (bound "
        f"{CAR_REPLAY_TOL})")
    if len(rows) < 10 or worst > CAR_REPLAY_TOL:
        raise AssertionError("CUDA and CPU car steps disagree")
    state = {"x": torch.as_tensor(xs[-1], device=dev), "warm": rec.last,
             "u": torch.as_tensor(us[-1], device=dev)}
    con_par = torch.as_tensor(par, dtype=torch.float32, device=dev)

    def step():
        u, w, _, _ = mpc.solve_step(state["x"], CAR_XSP, warm=state["warm"],
                                    u_prev=state["u"], con_par=con_par)
        state.update(u=u, warm=w, x=mpc.model.integrate(state["x"], u))

    prof = profile_steps(step, cpu_ops=False)
    log(f"[profile] per car control step: {prof['kernels_per_step']:.0f} "
        f"device kernels, {prof['device_ms_per_step']:.3f} ms device time, "
        f"{prof['wall_ms_per_step']:.3f} ms wall under the profiler; device "
        f"busy {100 * prof['busy_share']:.2f}% on {card}")
    for name, count, us_ in prof["top"]:
        log(f"[profile]   {name:60s} {count:6d} launches/3 steps "
            f"{us_:9.1f} us/step")
    return launches


def car_validation(ck, gc, dev, card):
    """Phase 13: the car residual GP's held-out check (the one of
    benchmarks/r5_car_seeds.py:110-131) on the card: 200 points drawn in
    the car's training box from a seeded torch.Generator, targets
    integrate - rk4 with the fused plant (one K2 Car launch at B=200), the
    fixture GP's validate (one K3 launch at (Ny,B,N,D) = (4,200,80,6));
    SMSE finite and within 1.5x of the port's f64 validation on the CPU on
    the same points, per dim.  That ratio is loose by nature (the
    fixture's residuals are f32 rounding, so SMSE is ~1 whatever the
    prediction), so both kernels are then held against their plain
    versions on the validation's own inputs (:func:`check_car_predict`).
    Returns the launches."""
    from gpmpc_tpu_torch import Model
    from gpmpc_tpu_torch.models.convert import gp_from_fixture
    from gpmpc_tpu_torch.systems import (CAR_U_LB, CAR_U_UB, CAR_X_LB,
                                         CAR_X_UB, car_ode)
    lo = np.concatenate([CAR_X_LB, CAR_U_LB])
    hi = np.concatenate([CAR_X_UB, CAR_U_UB])
    gp = gp_from_fixture(prefix="car", device=dev, dtype=torch.float32,
                         gp_method="EM")
    plant = Model(Nx=4, Nu=2, ode=car_ode, dt=CAR_DT, integrator_substeps=10,
                  fused_integrator=True, device=dev, dtype=torch.float32)
    g = torch.Generator(device=dev).manual_seed(9)
    kw = dict(dtype=torch.float32, device=dev)
    z = torch.as_tensor(lo, **kw) + torch.as_tensor(hi - lo, **kw) \
        * torch.rand((200, 6), generator=g, **kw)
    x, u = z[:, :4].contiguous(), z[:, 4:].contiguous()
    ck.reset_launches()
    t0 = time.perf_counter()
    y = plant.integrate(x, u) - plant.rk4(x, u)
    smse, mnlp, _ = gp.validate(z, y, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    refs = {}
    for dtype in (torch.float64, torch.float32):
        cpu = torch.device("cpu")
        m = Model(Nx=4, Nu=2, ode=car_ode, dt=CAR_DT, integrator_substeps=10,
                  device=cpu, dtype=dtype)
        zc = z.cpu().to(dtype)
        yc = m.integrate(zc[:, :4], zc[:, 4:]) - m.rk4(zc[:, :4], zc[:, 4:])
        refs[dtype] = gp_from_fixture(prefix="car", device=cpu, dtype=dtype,
                                      gp_method="EM").validate(
            zc, yc, verbose=False)[0]
    log(f"[car validate] 200 held-out points, targets integrate - rk4 "
        f"({1e3 * wall:.3f} ms wall): SMSE per dim on the card "
        f"{smse.tolist()}, MNLP {mnlp.tolist()}; the port on the CPU on "
        f"the same points: f64 {refs[torch.float64].tolist()}, f32 "
        f"{refs[torch.float32].tolist()} (information: the fixture's "
        f"residuals are f32 rounding, y std 3e-8 to 1e-6); launches "
        f"{launches} on {card}")
    none = dict.fromkeys(ck.LAUNCHES, 0)
    if launches != dict(none, rk4_substeps=1, gp_predict_batch=1):
        raise AssertionError(f"car validation launches {launches}")
    if not (np.all(np.isfinite(smse)) and np.all(np.isfinite(mnlp))
            and np.all(smse <= 1.5 * refs[torch.float64])):
        raise AssertionError("the car validation on the card is off the "
                             "CPU's")
    err = ck.check_rk4_substeps(car_ode, x, u, CAR_DT / 10, 10)
    log(f"[car validate] K2 Car on the validation's 200 rollouts against its"
        f" plain version: max|err| {err:.3e} (rtol 1e-5, atol 1e-6)")
    check_car_predict(gc, gp, z)
    return launches


def check_car_predict(gc, gp, z):
    """K3 on the car validation's own inputs (the normalized queries and
    the fixture posterior) against its plain version: k* and the mean at
    K3's tolerances (``gp_cuda.check_gp_predict_batch``), and the
    predictive variance sf2 - ||L^-1 k*||^2 formed from each one's k*
    through the posterior's Cholesky factor (as ``gp_core.predict_batch``
    forms it), within K3's k* tolerance carried through that solve: per
    point and dim, |dvar| <= 2 ||v|| e + e^2 with e = ||L^-1||_2 ||dk||
    and dk = KS_TOL (1 + |k*|)."""
    post = gp.post
    h = post.hypers
    sf2 = torch.exp(h.log_sf2).contiguous()
    args = (((z - gp.norm.z_mean) / gp.norm.z_std).contiguous(),
            post.x.contiguous(), torch.exp(h.log_ell).contiguous(), sf2,
            post.alpha.contiguous())
    err_k = gc.check_gp_predict_batch(*args)
    (mu, ks), (mu_r, ks_r) = gc.gp_predict_batch(*args), \
        gc.gp_predict_batch_reference(*args)
    v, v_r = (torch.linalg.solve_triangular(post.chol, k.mT, upper=False)
              for k in (ks, ks_r))
    var, var_r = (sf2[:, None] - torch.sum(w * w, dim=-2) for w in (v, v_r))
    inv_norm = torch.linalg.matrix_norm(torch.linalg.inv(post.chol.double()),
                                        ord=2).float()
    e = inv_norm[:, None] * torch.linalg.vector_norm(
        gc.KS_TOL * (1.0 + ks_r.abs()), dim=-1)
    tol = 2.0 * torch.linalg.vector_norm(v_r, dim=-2) * e + e * e
    gap = (var - var_r).abs()
    log(f"[car validate] K3 on the validation's inputs against its plain "
        f"version: max|err| k* {err_k:.3e} (rtol, atol {gc.KS_TOL}), mu "
        f"{float((mu - mu_r).abs().max()):.3e} (rtol, atol {gc.MU_TOL}); "
        f"variance max|err| {float(gap.max()):.3e}, largest share of its "
        f"carried tolerance {float((gap / tol).max()):.3f} (<= 1; tolerance "
        f"{float(tol.min()):.3e} to {float(tol.max()):.3e}, variance "
        f"{float(var_r.min()):.3e} to {float(var_r.max()):.3e})")
    if not bool(torch.all(gap <= tol)):
        raise AssertionError("K3's car predictive variance is off its plain "
                             "version's")


def bound(nbytes, flops):
    """The least time the card could take for the work, in ms: the bytes
    over HBM bandwidth or the f32 operations over the f32 peak, whichever
    is larger, and which one it is."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def cholesky_bound(p, n):
    """Bound of K5 on ``p`` f32 matrices of order ``n``: each reads its
    lower triangle, n(n+1)/2 floats, writes all n^2 of its factor, and does
    n^3/3 operations."""
    return bound(4 * p * (n * (n + 1) // 2 + n * n), p * n ** 3 / 3)


def riccati_flops(nt, nx, nu):
    """f32 operations of one Riccati sweep (multiply-add = 2): per stage the
    value recursion's products, the nu x nu Cholesky and solves, and the
    forward rollout."""
    per_stage = (4 * nx ** 3 + 2 * nu * nx ** 2 + nx ** 2          # h_xx
                 + 2 * nu ** 2 * nx + 2 * nu ** 2                   # h_uu
                 + 2 * nx ** 2 * nu + nx * nu                       # h_xu
                 + 4 * nx ** 2 + 2 * nx + 2 * nx * nu + nu          # h_x, h_u
                 + nu ** 3 // 3 + 2 * nu ** 2 * (nx + 1)            # solves
                 + 2 * nx ** 2 * nu + 3 * nx ** 2                   # V_xx
                 + 2 * nx * nu + nx + 2 * nu ** 2 + 4 * nu          # v_x, dec
                 + 2 * nu * nx + nu + 2 * nx ** 2 + 2 * nx * nu + 2 * nx)
    return nt * per_stage


#: the batched study, bench config 5 (bench.py:400-454): B rollouts, the
#: online capacity, the horizon in steps, the solver budget, the steps of
#: the long and the short timed run (the rate is B over the slope between
#: them), the rollouts replayed on the CPU
STUDY_B = 1024
STUDY_CAPACITY = 128
STUDY_NT = 8
STUDY_BUDGET = dict(al_iters=1, max_iters=3, ls_steps=4)
STUDY_STEPS = 12
STUDY_SHORT = 4
STUDY_REPLAY = (0, 1, 511, 1023)
#: the study's setpoint (bench.py:432), not the main path's
STUDY_XSP = np.array([12.4, 12.7, 1.8, 1.4])
#: bound of the study replay's next-state difference, card vs CPU, per
#: step and replayed rollout (max |diff| / (1 + |x|)): the first reading
#: was 1.107e-4 (H100 80GB HBM3 at 700 W), the f32 line search's choices
#: moving with the summation order as in the tank's replay
STUDY_REPLAY_TOL = 1e-3
#: bound of the fused variant's ensemble mean cost against the bench
#: configuration's, relative: the two differ only in K1's and K2's f32
#: rounding, which can flip a line-search choice (first reading 1.2e-7)
STUDY_COST_RTOL = 1e-3


def build_study(dev, fused):
    """The batched study as bench.py builds it (bench config 5) on ``dev``,
    f32: the pinned fixture GP, capacity 128, saturate, Nt=8, the al1 x mi3
    x ls4 budget, the plant with clip_negative; with ``fused`` the KKT
    sweep kernel (K1) and the fused plant (K2)."""
    from benchmarks.bench_spec import DT, MODEL_R
    from gpmpc_tpu_torch import Model
    from gpmpc_tpu_torch.models.convert import gp_from_fixture
    from gpmpc_tpu_torch.parallel import BatchedStudy
    from gpmpc_tpu_torch.systems import four_tank_ode

    model = Model(Nx=4, Nu=2, ode=four_tank_ode, dt=DT, R=MODEL_R,
                  clip_negative=True, integrator_substeps=10,
                  fused_integrator=fused, device=dev, dtype=torch.float32)
    gp = gp_from_fixture(device=dev, dtype=torch.float32,
                         optimizer_opts=GP_OPTS)
    opts = dict(STUDY_BUDGET, fused_kkt=True) if fused else STUDY_BUDGET
    return BatchedStudy(model, gp, horizon=STUDY_NT * DT,
                        Q=np.diag([10.0, 10.0, 0.1, 0.1]), R=0.01 * np.eye(2),
                        ulb=[0.0, 0.0], uub=[8.0, 8.0],
                        capacity=STUDY_CAPACITY, online_policy="saturate",
                        solver_opts=opts)


def study_inputs(study):
    """x0s = (8, 9, 1, 1) + 0.5 U(0, 1) from a numpy generator seeded 0 (the
    bench draws them with jax.random), and the process noise of
    STUDY_STEPS steps from a torch generator on the study's device seeded
    1: (B, 4) and (B, STUDY_STEPS, 4) on the device."""
    rng = np.random.default_rng(0)
    x0s = np.array([8.0, 9.0, 1.0, 1.0]) + 0.5 * rng.uniform(
        size=(STUDY_B, 4))
    gen = torch.Generator(device=study.device).manual_seed(1)
    return (torch.tensor(x0s, dtype=torch.float32, device=study.device),
            study.noise(STUDY_B, STUDY_STEPS, gen))


def study_step_fn(study, x0s, noise):
    """A callable that runs one vmapped control step of every rollout and
    carries their state, for timing and profiling single steps."""
    from torch.func import vmap
    xsp = torch.as_tensor(STUDY_XSP, dtype=torch.float32,
                          device=study.device)
    warm = vmap(study._init_warm, in_dims=(0, None, None, None))(
        x0s, study.post0, xsp, study.consts)
    state = {"x": x0s, "warm": warm, "post": study.post0, "k": 0}

    def step():
        pdim = 0 if state["k"] else None
        x, w, post, _, _ = vmap(study._step,
                                in_dims=(0, 0, pdim, 0, None, None))(
            state["x"], state["warm"], state["post"],
            noise[:, state["k"] % STUDY_STEPS], xsp, study.consts)
        state.update(x=x, warm=w, post=post, k=state["k"] + 1)

    return step


def study_timing(study, x0s, noise, card, tag):
    """bench.py's rate: wall time of a STUDY_STEPS-step and a STUDY_SHORT-step
    run (best of two), their slope per step, twice; B / the median slope.
    Beside it the same slope from CUDA events (one run each).  Returns
    (rollout solves per s, event ms per control step)."""
    b = x0s.shape[0]

    def run(n):
        return study.run(x0s, STUDY_XSP, n, noise_ws=noise[:, :n]).cost

    def wall(n, reps=2):
        torch.cuda.synchronize()
        best = np.inf
        for _ in range(reps):
            t0 = time.perf_counter()
            run(n)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        return best

    run(STUDY_SHORT)                                 # warm-up
    span = STUDY_STEPS - STUDY_SHORT
    slopes = [(wall(STUDY_STEPS) - wall(STUDY_SHORT)) / span
              for _ in range(2)]
    per_step = max(float(np.median(slopes)), 1e-9)
    ev_ms = (cuda_time_ms(lambda: run(STUDY_STEPS), reps=1, warmup=0)
             - cuda_time_ms(lambda: run(STUDY_SHORT), reps=1, warmup=0)) \
        / span
    rate = b / per_step
    log(f"[study] ({tag}) study_rollout_solves_per_s {rate:.1f} (B={b} / "
        f"median wall slope {per_step * 1e3:.3f} ms per control step, "
        f"slopes {[round(v * 1e3, 3) for v in slopes]} ms); CUDA events "
        f"{ev_ms:.3f} ms per control step on {card}")
    return rate, ev_ms


def study_replay(study, x0s, noise, dev):
    """Per-step replay of STUDY_REPLAY's rollouts on the CPU in f32: drive
    the STUDY_STEPS steps of all B rollouts on the card one vmapped step at
    a time and, at each step, run the same step of the replayed rollouts on
    the CPU from the card's state, warm start and posterior (the CPU study
    takes the card's posterior and constants).  Returns the worst next-state
    difference max |diff| / (1 + |x|) and its step."""
    from torch.func import vmap
    cpu = build_study(torch.device("cpu"), fused=False)
    cpu.post0, cpu.consts = to_cpu(study.post0), to_cpu(study.consts)
    idx = torch.tensor(STUDY_REPLAY, device=dev)
    xsp = torch.as_tensor(STUDY_XSP, dtype=torch.float32, device=dev)
    warm = vmap(study._init_warm, in_dims=(0, None, None, None))(
        x0s, study.post0, xsp, study.consts)
    x, post = x0s, study.post0
    worst = (0.0, 0)

    def pick(tree, batched):
        if not batched:
            return to_cpu(tree)
        return type(tree)(*(t.index_select(0, idx).cpu() for t in tree))

    for k in range(STUDY_STEPS):
        pdim = 0 if k else None
        args = (x.index_select(0, idx).cpu(), pick(warm, True),
                pick(post, k > 0), noise[:, k].index_select(0, idx).cpu(),
                xsp.cpu(), cpu.consts)
        x, warm, post, _, _ = vmap(study._step, in_dims=(
            0, 0, pdim, 0, None, None))(x, warm, post, noise[:, k], xsp,
                                        study.consts)
        x_c = vmap(cpu._step, in_dims=(0, 0, pdim, 0, None, None))(*args)[0]
        x_g = x.index_select(0, idx).cpu()
        if not bool(torch.all(torch.isfinite(x_g))):
            raise AssertionError("non-finite state in the study replay")
        rel = float(((x_g - x_c).abs() / (1.0 + x_c.abs())).max())
        worst = max(worst, (rel, k))
    torch.cuda.synchronize()
    return worst


#: bound of the card's conditioned posteriors against the CPU's on the
#: same f32 inputs: count, x and y equal, inv_k and alpha within this
#: fraction of their largest entry
STUDY_CONDITION_TOL = 1e-3


def gate_schur(post, norm, z):
    """The novelty gate's Schur complement s = sf2 + sn2 - k*' invK k* of
    every output dim at the raw inputs ``z`` (M, D) against the online
    posterior ``post`` (online_gp.condition's first pass, for M points at
    once), and the gate's threshold per dim: ((M, Ny), (Ny,))."""
    zn = (z - norm.z_mean) / norm.z_std
    live = torch.arange(post.x.shape[0], device=z.device) < post.count
    ell, sf2 = torch.exp(post.log_ell), torch.exp(post.log_sf2)
    s = []
    for d in range(ell.shape[0]):
        d2 = (((zn[:, None, :] - post.x[None]) / ell[d]) ** 2).sum(-1)
        ks = torch.where(live, sf2[d] * torch.exp(-0.5 * d2), 0.0)
        s.append(sf2[d] + post.sn2[d] - (ks * (ks @ post.inv_k[d])).sum(-1))
    thr = torch.maximum(3.0 * post.sn2, 1e-6 * (sf2 + post.sn2))
    return torch.stack(s, dim=-1), thr


def study_gate_reading(study, res, card):
    """Information: the novelty gate on the study's STUDY_STEPS x B
    transitions, each against the initial posterior, in f32 on the card
    and in f64 on the CPU (the fixture GP rebuilt in f64): the share each
    precision would take and the largest gap between the two s."""
    from gpmpc_tpu_torch.models.convert import gp_from_fixture
    from gpmpc_tpu_torch.parallel import online_gp

    z = torch.cat([res.x_traj[:, :-1], res.u_traj], dim=-1).reshape(-1, 6)
    s32, thr = gate_schur(study.post0, study.norm, z)
    gp64 = gp_from_fixture(device="cpu", dtype=torch.float64,
                           optimizer_opts=GP_OPTS)
    post64, norm64 = online_gp.from_gp(gp64, STUDY_CAPACITY)
    s64, thr64 = gate_schur(post64, norm64, z.cpu().double())
    take32 = float((s32 > thr).all(-1).double().mean())
    take64 = float((s64 > thr64).all(-1).double().mean())
    gap = (s32.cpu().double() - s64).abs().max(dim=0).values
    log(f"[study] (a) novelty gate on the {z.shape[0]} transitions against "
        f"the initial posterior: taken {100 * take32:.3f}% in f32 on the "
        f"card, {100 * take64:.3f}% in f64 on the CPU; largest |s f32 - s "
        f"f64| per output dim {[float(f'{v:.3e}') for v in gap]} against "
        f"thresholds {[float(f'{v:.3e}') for v in thr64]} (information) on "
        f"{card}")


def study_condition_check(study, res, dev, card):
    """Condition every rollout's posterior on the card on one novel
    transition (the last state and input moved by (40, 40, 10, 10) and
    (10, 10), several lengthscales off the data: the gate's Schur
    complement is 4e2-3e3 times its threshold in f64, far above f32's
    rounding; nearer points this smooth GP does not take, even in f64),
    all B at once, and hold STUDY_REPLAY's rollouts against the same
    conditioning on the CPU."""
    from torch.func import vmap
    from gpmpc_tpu_torch.parallel import online_gp

    shift = torch.tensor([40.0, 40.0, 10.0, 10.0], device=dev)
    z = torch.cat([res.x_traj[:, -1] + shift, res.u_traj[:, -1] + 10.0],
                  dim=-1)
    y = res.x_traj[:, -1] + shift

    def cond(post, norm, zz, yy):
        return online_gp.condition(post, norm, zz, yy,
                                   kernel=study.kernel,
                                   policy=study.online_policy,
                                   mean_func=study.mean_func)

    new = vmap(cond, in_dims=(0, None, 0, 0))(res.post, study.norm, z, y)
    torch.cuda.synchronize()
    idx = torch.tensor(STUDY_REPLAY, device=dev)
    sub = type(res.post)(*(t.index_select(0, idx).cpu() for t in res.post))
    cpu = vmap(cond, in_dims=(0, None, 0, 0))(
        sub, to_cpu(study.norm), z.index_select(0, idx).cpu(),
        y.index_select(0, idx).cpu())
    got = type(new)(*(t.index_select(0, idx).cpu() for t in new))
    rel = max(float((g - c).abs().max() / c.abs().max())
              for g, c in ((got.inv_k, cpu.inv_k), (got.alpha, cpu.alpha)))
    grown = bool(torch.all(new.count == res.post.count + 1))
    same = (torch.equal(got.count, cpu.count) and torch.equal(got.x, cpu.x)
            and torch.equal(got.y, cpu.y))
    log(f"[study] (a) conditioning all {new.count.shape[0]} posteriors on "
        f"the card on a novel transition: every count +1: {grown}; "
        f"rollouts {list(STUDY_REPLAY)} against the CPU: count, x, y equal:"
        f" {same}, inv_k and alpha within {rel:.3e} of their largest entry "
        f"(bound {STUDY_CONDITION_TOL}) on {card}")
    if not (grown and same and rel <= STUDY_CONDITION_TOL):
        raise AssertionError("the study's conditioning on the card is off")


def study_phase(ck, dev, card):
    """Phase 14: the batched closed-loop study at full width (B=1024).
    (a) bench config 5 as the JAX package runs it, no kernel (unfused
    plant, sequential KKT): rate and ms per control step, finite values,
    gp_points in [100, capacity] (the f32 novelty gate's decisions here
    are rounding), every posterior conditioned on the card on a novel
    transition and held against the CPU (study_condition_check), a
    per-step CPU replay of four rollouts, a profile of three steps; (b) the
    same study with ``fused_kkt`` and the fused plant: exact launch counts
    (K1 once per inner SQP step, K2 once per control step, both batched
    over the 1024 rollouts), ms per control step, a profile, its ensemble
    mean cost within STUDY_COST_RTOL of (a)'s; (c) save_study/load_study on
    the card (the loaded posterior bitwise the saved one) and a resumed
    run.  Returns (b)'s launches and (a)'s result for phase 11's rows."""
    from gpmpc_tpu_torch.parallel import load_study, save_study

    # (a) the bench configuration
    study = build_study(dev, fused=False)
    x0s, noise = study_inputs(study)
    rate_a, ms_a = study_timing(study, x0s, noise, card, "a: bench config, "
                                "unfused plant, sequential KKT")
    ck.reset_launches()
    res_a = study.run(x0s, STUDY_XSP, STUDY_STEPS, noise_ws=noise)
    torch.cuda.synchronize()
    if any(ck.LAUNCHES.values()):
        raise AssertionError(f"the unfused study launched kernels: "
                             f"{ck.LAUNCHES}")
    for name in ("x_traj", "u_traj", "cost", "obj"):
        if not bool(torch.all(torch.isfinite(getattr(res_a, name)))):
            raise AssertionError(f"non-finite study {name}")
    pts = res_a.gp_points
    log(f"[study] (a) {STUDY_STEPS} steps at B={STUDY_B}: mean cost "
        f"{float(res_a.mean_cost):.4f}, gp_points min/mean/max "
        f"{int(pts.min())}/{float(pts.float().mean()):.2f}/{int(pts.max())} "
        f"(training set 100, capacity {STUDY_CAPACITY}); final state of "
        f"rollout 0 {res_a.x_traj[0, -1].tolist()} on {card}")
    # in f32 the novelty gate's decisions on this configuration's
    # transitions are rounding: its Schur complement s = sf2 + sn2 - k*'w
    # is a cancellation whose f32 error dwarfs the gate's 3 sn2
    # (study_gate_reading), so the counts are only checked for range, and
    # the conditioning itself on a transition the gate must take
    if int(pts.min()) < 100 or int(pts.max()) > STUDY_CAPACITY:
        raise AssertionError("gp_points out of [100, capacity]")
    study_gate_reading(study, res_a, card)
    study_condition_check(study, res_a, dev, card)
    t0 = time.perf_counter()
    worst, at = study_replay(study, x0s, noise, dev)
    log(f"[study] (a) per-step replay of rollouts {list(STUDY_REPLAY)} on "
        f"the CPU in f32 ({time.perf_counter() - t0:.1f} s): worst next-state"
        f" max |diff|/(1+|x|) {worst:.3e} at step {at} (bound "
        f"{STUDY_REPLAY_TOL}) on {card}")
    if worst > STUDY_REPLAY_TOL:
        raise AssertionError("CUDA and CPU study steps disagree")
    prof_a = profile_steps(study_step_fn(study, x0s, noise), cpu_ops=False)
    log(f"[profile] (a) per study step: {prof_a['kernels_per_step']:.0f} "
        f"device kernels, {prof_a['device_ms_per_step']:.3f} ms device time,"
        f" {prof_a['wall_ms_per_step']:.3f} ms wall under the profiler; "
        f"device busy {100 * prof_a['busy_share']:.2f}% on {card}")
    for name, count, us_ in prof_a["top"]:
        log(f"[profile]   {name:60s} {count:6d} launches/3 steps "
            f"{us_:9.1f} us/step")

    # (b) the fused variant: K1 and K2 batched over the rollouts
    fstudy = build_study(dev, fused=True)
    _, ms_b = study_timing(fstudy, x0s, noise, card,
                           "b: fused_kkt, fused plant")
    ck.reset_launches()
    res_b = fstudy.run(x0s, STUDY_XSP, STUDY_STEPS, noise_ws=noise)
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    cfg = fstudy.sqp_cfg
    expect = {"riccati_sweep": STUDY_STEPS * cfg.al_iters * cfg.max_iters,
              "rk4_substeps": STUDY_STEPS, "se_ard_gram": 0, "cholesky": 0,
              "gp_predict_batch": 0}
    log(f"[study] (b) {STUDY_STEPS} steps at B={STUDY_B}: launches "
        f"{launches}, expected {expect}; mean cost "
        f"{float(res_b.mean_cost):.4f} against (a)'s "
        f"{float(res_a.mean_cost):.4f} (relative difference "
        f"{abs(float(res_b.mean_cost / res_a.mean_cost) - 1):.3e}, bound "
        f"{STUDY_COST_RTOL}) on {card}")
    if launches != expect:
        raise AssertionError(f"study launch counts {launches} != {expect}")
    if not bool(torch.all(torch.isfinite(res_b.x_traj))):
        raise AssertionError("non-finite fused study")
    if abs(float(res_b.mean_cost / res_a.mean_cost) - 1) > STUDY_COST_RTOL:
        raise AssertionError("the fused study's mean cost is off (a)'s")
    prof_b = profile_steps(study_step_fn(fstudy, x0s, noise), cpu_ops=False)
    log(f"[profile] (b) per study step: {prof_b['kernels_per_step']:.0f} "
        f"device kernels, {prof_b['device_ms_per_step']:.3f} ms device time,"
        f" {prof_b['wall_ms_per_step']:.3f} ms wall under the profiler; "
        f"device busy {100 * prof_b['busy_share']:.2f}% on {card}")

    # (c) a checkpoint on the card, and a resumed run
    path = str(ck.BUILD_DIR / "study_checkpoint.npz")
    ck.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    save_study(path, res_b)
    loaded = load_study(path, fstudy.post0)
    same = all(torch.equal(a, b) for a, b in zip(loaded.post, res_b.post))
    resumed = fstudy.run(res_b.x_traj[:, -1], STUDY_XSP, 2,
                         noise_ws=noise[:, :2], init_post=loaded.post)
    torch.cuda.synchronize()
    ok = (same and bool(torch.all(torch.isfinite(resumed.x_traj)))
          and bool(torch.all(resumed.gp_points >= loaded.gp_points)))
    log(f"[study] (c) save_study/load_study on the card: loaded posterior "
        f"bitwise the saved one: {same}; resumed 2 steps: finite, gp_points"
        f" {int(resumed.gp_points.min())}..{int(resumed.gp_points.max())} "
        f"on {card}")
    os.remove(path)
    if not ok:
        raise AssertionError("the study checkpoint does not resume")
    log(f"[study] study_rollout_solves_per_s {rate_a:.1f}; ms per control "
        f"step (CUDA events) {ms_a:.3f} (a), {ms_b:.3f} (b); device busy "
        f"{100 * prof_a['busy_share']:.2f}% (a), "
        f"{100 * prof_b['busy_share']:.2f}% (b); launches {launches} on "
        f"{card}")
    return launches, res_a


def study_kernel_rows(ck, dev, card, launches, res_a, sources):
    """Phase 11's rows of the study's shapes: K1 at (B, Nt, nx, nu) =
    (1024, 8, 4, 2) and K2 at B=1024 on (a)'s own states and inputs of step
    5, each held against its plain version, timed (event ms over 200 calls,
    device ms per launch), beside the plain version's time and the bound,
    with the launches of phase 14 (b)."""
    from benchmarks.bench_spec import DT
    from gpmpc_tpu_torch.systems import four_tank_ode
    rows = []
    q = ck.stage_qp_inputs(STUDY_NT, 4, 2, 14, STUDY_B, device=dev)
    reg = torch.full((STUDY_B,), 1e-6, device=dev)
    err1 = ck.check_riccati_sweep(q, reg)
    out = ck.riccati_sweep(*q, reg)
    x = res_a.x_traj[:, 5].contiguous()
    u = res_a.u_traj[:, 5].contiguous()
    err2 = ck.check_rk4_substeps(four_tank_ode, x, u, DT / 10, 10)
    y = ck.rk4_substeps(four_tank_ode, x, u, DT / 10, 10)
    for name, kernel, fn, plain, b, err in (
            ("riccati_sweep[study]", "riccati_sweep",
             lambda: ck.riccati_sweep(*q, reg),
             lambda: ck.riccati_sweep_reference(*q, reg),
             bound(nbytes(*q, reg, *out),
                   STUDY_B * riccati_flops(STUDY_NT, 4, 2)), err1),
            ("rk4_substeps[study]", "rk4_substeps",
             lambda: ck.rk4_substeps(four_tank_ode, x, u, DT / 10, 10),
             lambda: ck.rk4_substeps_reference(four_tank_ode, x, u, DT / 10,
                                               10),
             bound(nbytes(x, u, y), STUDY_B * 10 * (4 * 22 + 52)), err2)):
        ms = cuda_time_ms(fn, reps=200)
        dev_ms, _, note = device_time_ms(fn)
        plain_ms = cuda_time_ms(plain, reps=20)
        log(f"[time] {name} (B={STUDY_B}"
            f"{', Nt=8, nx=4, nu=2' if kernel == 'riccati_sweep' else ''}): "
            f"kernel {ms:.4f} ms, device {fmt_ms(dev_ms)}{note} per launch, "
            f"plain torch on the card {plain_ms:.4f} ms, bound {b[0]:.3e} ms "
            f"({b[1]}); {launches[kernel]} launches in phase 14 (b); max|err|"
            f" {err:.3e} on {card}")
        rows.append({"name": name, "route": "cuda",
                     "source": f"gpmpc_tpu_torch/csrc/{kernel}.cu",
                     "replaces": f"gpmpc_tpu/ops/pallas_kernels.py:"
                                 f"{sources[kernel]}",
                     "launches": launches[kernel], "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms, "device_ms": dev_ms,
                     "bound_ms": b[0], "bound_by": b[1], "library_ms": None})
    return rows


def kernel_times(ck, gc, four_tank_ode, dev, card):
    """Phase 11: each kernel's time beside its plain version's, the library
    call's (K5), its device time per launch (torch.profiler) and its
    bound, at the paths' shapes; K5 also at larger N.  Returns rows keyed
    by kernel name."""
    from benchmarks.bench_spec import DT
    t = {}
    q1 = ck.stage_qp_inputs(20, 4, 2, 0, device=dev)
    reg = torch.tensor(1e-6, device=dev)
    out = ck.riccati_sweep(*q1, reg)
    t["riccati_sweep"] = dict(
        fn=lambda: ck.riccati_sweep(*q1, reg),
        plain_ms=cuda_time_ms(lambda: ck.riccati_sweep_reference(*q1, reg),
                              reps=20),
        library_ms=None, shape="Nt=20, nx=4, nu=2",
        bound=bound(nbytes(*q1, reg, *out), riccati_flops(20, 4, 2)))
    x1 = torch.tensor([8.0, 10.0, 1.0, 1.5], device=dev)
    u1 = torch.tensor([3.0, 3.0], device=dev)
    # per substep 4 ODE evaluations (~22 operations each) and ~52 for the
    # stage combinations
    t["rk4_substeps"] = dict(
        fn=lambda: ck.rk4_substeps(four_tank_ode, x1, u1, DT / 10, 10),
        plain_ms=cuda_time_ms(lambda: ck.rk4_substeps_reference(
            four_tank_ode, x1, u1, DT / 10, 10), reps=20),
        library_ms=None, shape="nx=4, nu=2, n_sub=10",
        bound=bound(nbytes(x1, u1, x1), 10 * (4 * 22 + 52)))
    g = gc.gram_inputs(100, 6, 8, 106, device=dev)
    k = gc.se_ard_gram(*g, 1e-5)
    t["se_ard_gram"] = dict(
        fn=lambda: gc.se_ard_gram(*g, 1e-5),
        plain_ms=cuda_time_ms(lambda: gc.se_ard_gram_reference(*g, 1e-5),
                              reps=50),
        library_ms=None, shape="P=8, N=100, D=6",
        bound=bound(nbytes(*g, k), 8 * 100 * 100 * (3 * 6 + 3)))
    t["cholesky"] = dict(
        fn=lambda: gc.cholesky(k),
        plain_ms=cuda_time_ms(lambda: gc.cholesky_reference(k), reps=50),
        library_ms=cuda_time_ms(lambda: torch.linalg.cholesky_ex(k),
                                reps=50),
        library_device=device_time_ms(lambda: torch.linalg.cholesky_ex(k)),
        shape="P=8, N=100", bound=cholesky_bound(8, 100))
    p3 = gc.predict_inputs(100, 6, 100, 4, 100, device=dev)
    mu, ks = gc.gp_predict_batch(*p3)
    t["gp_predict_batch"] = dict(
        fn=lambda: gc.gp_predict_batch(*p3),
        plain_ms=cuda_time_ms(lambda: gc.gp_predict_batch_reference(*p3),
                              reps=50),
        library_ms=None, shape="Ny=4, B=100, N=100, D=6",
        bound=bound(nbytes(*p3, mu, ks), 4 * 100 * 100 * (3 * 6 + 5)))
    for name, r in t.items():
        r["ms"] = cuda_time_ms(r["fn"], reps=200)
        r["device_ms"], r["device_kernels"], note = device_time_ms(r["fn"])
        lib = "none" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms"
        log(f"[time] {name} ({r['shape']}): kernel {r['ms']:.4f} ms, device "
            f"{fmt_ms(r['device_ms'])}{note} per launch "
            f"({r['device_kernels']:.0f} device kernels), plain torch on the "
            f"card {r['plain_ms']:.4f} ms, library call {lib}, bound "
            f"{r['bound'][0]:.3e} ms ({r['bound'][1]}) on {card}")
    lib_ms, _, note = t["cholesky"]["library_device"]
    log(f"[time] cholesky_ex (P=8, N=100) device {fmt_ms(lib_ms)}{note} on "
        f"{card}")
    for p, n in [(1, 1024), (4, 500), (4, 1000), (1, 2048)]:
        a = gc.spd_inputs(n, p, 7, device=dev)
        ms = cuda_time_ms(lambda: gc.cholesky(a), reps=20)
        dev_ms, kern, note = device_time_ms(lambda: gc.cholesky(a))
        plain = cuda_time_ms(lambda: gc.cholesky_reference(a), reps=20)
        lib = cuda_time_ms(lambda: torch.linalg.cholesky_ex(a), reps=20)
        lib_dev, _, lib_note = device_time_ms(
            lambda: torch.linalg.cholesky_ex(a))
        b = cholesky_bound(p, n)
        log(f"[time] cholesky (P={p}, N={n}, {k5_path(gc, n)}): kernel "
            f"{ms:.4f} ms, device {fmt_ms(dev_ms)}{note} ({kern:.0f} device "
            f"kernels), plain {plain:.4f} ms, library call {lib:.4f} ms "
            f"(device {fmt_ms(lib_dev)}{lib_note}), bound {b[0]:.3e} ms "
            f"({b[1]}) on {card}")
    return t


#: (B, Nt) at which phase 11 times K1 at (nx, nu) = (4, 2): the main path,
#: two batches on the way to the batched study's B=1024, a long horizon
K1_TIME_SHAPES = ((1, 20), (64, 20), (1024, 20), (1, 300))


def fmt_pair(pair):
    return ("not measured" if pair[0] is None else
            f"{pair[0]:.4f}/{pair[1]:.4f} ms") + pair[2]


def k1_times(ck, dev, card, sweep=None):
    """Phase 11's K1 lines at K1_TIME_SHAPES: event ms over 200 calls,
    device ms per launch (torch.profiler; mean/median) over 20 calls, over
    200 and over 20 again after those, the plain version's event ms and
    the bound; the launch floor (device ms of a one-element ``add_``) over
    the same windows; nvidia-smi's SM clock and power draw over the whole.
    ``sweep`` stands in for the wrapper (another build of K1, to compare
    two in one run)."""
    sweep = sweep or ck.riccati_sweep
    with SmiSampler() as smi:
        for bsz, nt in K1_TIME_SHAPES:
            q = ck.stage_qp_inputs(nt, 4, 2, nt + bsz,
                                   None if bsz == 1 else bsz, device=dev)
            reg = torch.full(() if bsz == 1 else (bsz,), 1e-6, device=dev)
            out = sweep(*q, reg)

            def call():
                sweep(*q, reg)

            r = dict(ms=cuda_time_ms(call, reps=200),
                     dev20=launch_ms(call, 20), dev200=launch_ms(call, 200),
                     dev20_after=launch_ms(call, 20),
                     bound=bound(nbytes(*q, reg, *out),
                                 bsz * riccati_flops(nt, 4, 2)))
            r["plain_ms"] = cuda_time_ms(
                lambda: ck.riccati_sweep_reference(*q, reg),
                reps=3 if nt > 100 else 20)
            log(f"[K1 time] B={bsz}, Nt={nt}, (nx,nu)=(4,2): event "
                f"{r['ms']:.4f} ms (200 calls); device per launch mean/median"
                f" {fmt_pair(r['dev20'])} over 20 calls, "
                f"{fmt_pair(r['dev200'])} over 200, "
                f"{fmt_pair(r['dev20_after'])} over 20 after those; plain "
                f"{r['plain_ms']:.4f} ms; bound {r['bound'][0]:.3e} ms "
                f"({r['bound'][1]}) on {card}")
        z = torch.zeros(1, device=dev)
        floor = [launch_ms(lambda: z.add_(1.0), reps)
                 for reps in (20, 200, 20)]
        log(f"[K1 time] launch floor (one-element add_): device per launch "
            f"mean/median {fmt_pair(floor[0])} over 20 calls, "
            f"{fmt_pair(floor[1])} over 200, {fmt_pair(floor[2])} over 20 "
            f"after those on {card}")
    log(f"[K1 time] nvidia-smi over the K1 window: {smi.summary()}")


def car_kernel_times(ck, gc, dev, card):
    """Phase 11's car lines: K1 at (nx, nu) = (6, 2), Nt=20, B=1 and the
    K2 Car functor at B = 1 and 200 (n_sub=10, h = dt/10), and K3, K4 and
    K5 at the car GP's shapes (posterior: P = Ny = 4, N = 80; validation:
    (Ny,B,N,D) = (4,200,80,6)): event ms over 200 calls, device ms per
    launch (torch.profiler, mean/median over 200 calls), the plain
    version's event ms and the bound, beside the launch floor and
    nvidia-smi's clocks.  Returns the rows keyed by name: those of the two
    new instantiations at their paths' shapes are "riccati_sweep[6,2]"
    (B=1) and "rk4_substeps[car]" (B=200)."""
    from gpmpc_tpu_torch.systems import car_ode
    rows = {}
    with SmiSampler() as smi:
        q = ck.stage_qp_inputs(20, 6, 2, 26, device=dev)
        reg = torch.tensor(1e-6, device=dev)
        out = ck.riccati_sweep(*q, reg)
        cases = [("riccati_sweep[6,2]", "B=1, Nt=20, nx=6, nu=2",
                  lambda: ck.riccati_sweep(*q, reg),
                  lambda: ck.riccati_sweep_reference(*q, reg),
                  bound(nbytes(*q, reg, *out), riccati_flops(20, 6, 2)))]
        for bsz in (1, 200):
            x, u = ck.car_inputs(None if bsz == 1 else bsz, bsz + 1, dev)
            xo = ck.rk4_substeps(car_ode, x, u, CAR_DT / 10, 10)
            # per rollout the slip angle (~60 operations: tan, atan, sin);
            # per substep 4 evaluations (~44: one sincos, 3 products) and
            # ~52 for the stage combinations
            cases.append((
                "rk4_substeps[car]" if bsz == 200 else "rk4_substeps[car] B=1",
                f"B={bsz}, n_sub=10",
                lambda x=x, u=u: ck.rk4_substeps(car_ode, x, u, CAR_DT / 10,
                                                 10),
                lambda x=x, u=u: ck.rk4_substeps_reference(
                    car_ode, x, u, CAR_DT / 10, 10),
                bound(nbytes(x, u, xo), bsz * (60 + 10 * (4 * 44 + 52)))))
        g = gc.gram_inputs(80, 6, 4, 86, device=dev)
        k = gc.se_ard_gram(*g, 1e-6)
        cases.append(("se_ard_gram", "P=4, N=80, D=6 (car posterior)",
                      lambda: gc.se_ard_gram(*g, 1e-6),
                      lambda: gc.se_ard_gram_reference(*g, 1e-6),
                      bound(nbytes(*g, k), 4 * 80 * 80 * (3 * 6 + 3))))
        a = gc.spd_inputs(80, 4, 80, device=dev)
        cases.append(("cholesky", "P=4, N=80 (car posterior)",
                      lambda: gc.cholesky(a),
                      lambda: gc.cholesky_reference(a),
                      cholesky_bound(4, 80)))
        p3 = gc.predict_inputs(80, 6, 200, 4, 280, device=dev)
        mu, ks = gc.gp_predict_batch(*p3)
        cases.append(("gp_predict_batch", "Ny=4, B=200, N=80, D=6 (car "
                      "validation)", lambda: gc.gp_predict_batch(*p3),
                      lambda: gc.gp_predict_batch_reference(*p3),
                      bound(nbytes(*p3, mu, ks), 4 * 200 * 80 * (3 * 6 + 5))))
        lib, _, note = device_time_ms(lambda: torch.linalg.cholesky_ex(a))
        log(f"[car time] cholesky_ex (P=4, N=80), the library call: event "
            f"{cuda_time_ms(lambda: torch.linalg.cholesky_ex(a), 200):.4f} "
            f"ms (200 calls), device {fmt_ms(lib)}{note} on {card}")
        for name, shape, fn, plain, bd in cases:
            r = dict(ms=cuda_time_ms(fn, reps=200),
                     plain_ms=cuda_time_ms(plain, reps=20),
                     dev=launch_ms(fn, 200), bound=bd, shape=shape)
            log(f"[car time] {name} ({shape}): event {r['ms']:.4f} ms (200 "
                f"calls); device per launch mean/median "
                f"{fmt_pair(r['dev'])}; plain {r['plain_ms']:.4f} ms; bound "
                f"{bd[0]:.3e} ms ({bd[1]}) on {card}")
            rows[name] = r
        log(f"[car time] launch floor (one-element add_): device per launch "
            f"mean/median {fmt_pair(floor_ms(dev))} on {card}")
    log(f"[car time] nvidia-smi over the window: {smi.summary()}")
    return rows


#: (P, N, D) at which phase 11 times K4: the training path's (the example
#: recipe's P), the --large-fit path's two N at P=4, one matrix at 2048
K4_TIME_SHAPES = ((8, 100, 6), (4, 500, 6), (4, 1000, 6), (1, 2048, 6))
#: rollouts at which phase 11 times K2 (n_sub=10): the main path's one, a
#: batch, the batched study's width
K2_TIME_BATCHES = (1, 64, 1024)


def floor_ms(dev):
    """The launch floor: mean/median device ms of a one-element add_ over
    200 calls."""
    z = torch.zeros(1, device=dev)
    return launch_ms(lambda: z.add_(1.0), 200)


def k4_times(gc, dev, card, gram=None):
    """Phase 11's K4 lines at K4_TIME_SHAPES: event ms over 200 calls,
    device ms per launch (torch.profiler, mean/median over 200 calls), a
    fill_ of the same (P, N, N) output (the practical write floor), the
    plain version's event ms and the bound, beside the launch floor and
    nvidia-smi's clocks over the window.  ``gram`` stands in for the
    wrapper (another build of K4)."""
    gram = gram or gc.se_ard_gram
    with SmiSampler() as smi:
        for p, n, d in K4_TIME_SHAPES:
            x, ell, sf2, sn2 = gc.gram_inputs(n, d, p, n + d, device=dev)
            k = gram(x, ell, sf2, sn2, 1e-5)

            def call():
                gram(x, ell, sf2, sn2, 1e-5)

            out = torch.empty_like(k)
            fill = launch_ms(lambda: out.fill_(1.0), 200)
            plain = cuda_time_ms(lambda: gc.se_ard_gram_reference(
                x, ell, sf2, sn2, 1e-5), reps=20)
            b = bound(nbytes(x, ell, sf2, sn2, k), p * n * n * (3 * d + 3))
            log(f"[K4 time] (P,N,D)=({p},{n},{d}): event "
                f"{cuda_time_ms(call, reps=200):.4f} ms (200 calls); device "
                f"per launch mean/median {fmt_pair(launch_ms(call, 200))}; "
                f"fill_ of the output {fmt_pair(fill)}; plain "
                f"{plain:.4f} ms; bound {b[0]:.3e} ms ({b[1]}) on {card}")
        log(f"[K4 time] launch floor (one-element add_): device per launch "
            f"mean/median {fmt_pair(floor_ms(dev))} on {card}")
    log(f"[K4 time] nvidia-smi over the K4 window: {smi.summary()}")


#: (Ny, B, N, D) at which phase 11 times K3: the validation path's, and the
#: --large-fit validations' at N = 500 and 1000
K3_TIME_SHAPES = ((4, 100, 100, 6), (4, 1000, 500, 6), (4, 1000, 1000, 6))


def k3_times(gc, dev, card, predict=None):
    """Phase 11's K3 lines at K3_TIME_SHAPES: event ms over 200 calls,
    device ms per launch (torch.profiler, mean/median over 200 calls), a
    fill_ of the same (Ny, B, N) k* (the practical write floor), the plain
    version's event ms and the bound, beside the launch floor and
    nvidia-smi's clocks over the window.  ``predict`` stands in for the
    wrapper (another build of K3)."""
    predict = predict or gc.gp_predict_batch
    with SmiSampler() as smi:
        for ny, b, n, d in K3_TIME_SHAPES:
            args = gc.predict_inputs(n, d, b, ny, b + n, device=dev)
            mu, ks = predict(*args)

            def call():
                predict(*args)

            out = torch.empty_like(ks)
            fill = launch_ms(lambda: out.fill_(1.0), 200)
            plain = cuda_time_ms(
                lambda: gc.gp_predict_batch_reference(*args), reps=20)
            bd = bound(nbytes(*args, mu, ks), ny * b * n * (3 * d + 5))
            log(f"[K3 time] (Ny,B,N,D)=({ny},{b},{n},{d}): event "
                f"{cuda_time_ms(call, reps=200):.4f} ms (200 calls); device "
                f"per launch mean/median {fmt_pair(launch_ms(call, 200))}; "
                f"fill_ of k* {fmt_pair(fill)}; plain {plain:.4f} ms; bound "
                f"{bd[0]:.3e} ms ({bd[1]}) on {card}")
        log(f"[K3 time] launch floor (one-element add_): device per launch "
            f"mean/median {fmt_pair(floor_ms(dev))} on {card}")
    log(f"[K3 time] nvidia-smi over the K3 window: {smi.summary()}")


def k2_times(ck, four_tank_ode, dev, card, integrate=None):
    """Phase 11's K2 lines at K2_TIME_BATCHES (n_sub=10, h = DT/10): event
    ms over 200 calls, device ms per launch (torch.profiler, mean/median
    over 200 calls), the plain version's event ms and the bound, beside the
    launch floor and nvidia-smi's clocks over the window.  ``integrate``
    stands in for the wrapper (another build of K2)."""
    from benchmarks.bench_spec import DT
    integrate = integrate or ck.rk4_substeps
    with SmiSampler() as smi:
        for bsz in K2_TIME_BATCHES:
            x, u = ck.rk4_inputs(None if bsz == 1 else bsz, bsz, dev)
            out = integrate(four_tank_ode, x, u, DT / 10, 10)

            def call():
                integrate(four_tank_ode, x, u, DT / 10, 10)

            # per substep 4 ODE evaluations (~22 operations each) and ~52
            # for the stage combinations
            b = bound(nbytes(x, u, out), bsz * 10 * (4 * 22 + 52))
            plain = cuda_time_ms(lambda: ck.rk4_substeps_reference(
                four_tank_ode, x, u, DT / 10, 10), reps=20)
            log(f"[K2 time] B={bsz}, n_sub=10: event "
                f"{cuda_time_ms(call, reps=200):.4f} ms (200 calls); device "
                f"per launch mean/median {fmt_pair(launch_ms(call, 200))}; "
                f"plain {plain:.4f} ms; bound {b[0]:.3e} ms ({b[1]}) on "
                f"{card}")
        log(f"[K2 time] launch floor (one-element add_): device per launch "
            f"mean/median {fmt_pair(floor_ms(dev))} on {card}")
    log(f"[K2 time] nvidia-smi over the K2 window: {smi.summary()}")


def k2_chain_cycles(ck, dev, card):
    """K2's dependent chain in SM cycles: gpmpc_rk4_chain_cycles_f32 runs
    one rollout's substeps in one thread between two clock64() reads (from
    before its loads to after its stores), min over 20 calls, at n_sub = 0
    (loads and stores alone), 10 (the compiled-in count), 20 and 40 (the
    run-time loop).  (c10 - c0) / 40 is one evaluation's cycles on the main
    path, (c40 - c20) / 80 in the run-time loop (each with its share of the
    RK4 combination)."""
    from benchmarks.bench_spec import DT
    lib = ck.build_library()
    x, u = ck.rk4_inputs(None, 1, dev)
    out = torch.empty_like(x)
    cyc = torch.zeros(1, dtype=torch.int64, device=dev)
    c = {}
    with SmiSampler() as smi:
        for n_sub in (0, 10, 20, 40):
            reads = []
            for _ in range(20):
                with torch.cuda.device(dev):
                    stream = torch.cuda.current_stream(dev).cuda_stream
                    code = lib.gpmpc_rk4_chain_cycles_f32(
                        0, x.data_ptr(), u.data_ptr(), out.data_ptr(),
                        cyc.data_ptr(), n_sub, float(DT / 10), stream)
                ck._raise_on_error("rk4_chain_cycles", code)
                reads.append(int(cyc.item()))
            c[n_sub] = min(reads)
    mhz = float(np.median([r[0] for r in smi.rows])) if smi.rows else None
    at = "" if mhz is None else \
        f" = {c[10] / mhz:.3f} us at the median SM clock {mhz:.0f} MHz"
    log(f"[K2 chain] one thread, clock64 from before the loads to after the "
        f"stores, min of 20: n_sub=0 {c[0]} cycles, n_sub=10 (compiled-in) "
        f"{c[10]}{at}, so {(c[10] - c[0]) / 40:.1f} cycles per ODE "
        f"evaluation on the main path; run-time loop n_sub=20 {c[20]}, 40 "
        f"{c[40]}: {(c[40] - c[20]) / 80:.1f} per evaluation, on {card}")
    log(f"[K2 chain] nvidia-smi over the window: {smi.summary()}")
    return c


def sass_summary(so, tag):
    """Write the SASS of library ``so`` (cuobjdump -sass) under the build
    directory and log, for each K2 kernel in it, its instruction count by
    the opcodes that make the chain."""
    import re
    from gpmpc_tpu_torch.ops import cuda_kernels as ck
    tool = os.path.join(os.path.dirname(ck._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    path = ck.BUILD_DIR / "sass" / f"{tag}.sass"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    for part in text.split("Function : ")[1:]:
        name = part.splitlines()[0].strip()
        if "rk4" not in name:
            continue
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                         part)
        count = {k: sum(o == k for o in ops) for k in
                 ("MUFU", "FFMA", "FMUL", "FADD", "FMNMX", "FSETP", "BRA",
                  "CALL", "LDG", "STG")}
        log(f"[sass] {tag} {name}: {len(ops)} instructions, {count} "
            f"-> {path}")


#: --compare's kernels: key -> the C symbol of its launch
COMPARE = {"k1": "gpmpc_riccati_sweep_f32", "k2": "gpmpc_rk4_substeps_f32",
           "k3": "gpmpc_gp_predict_batch_f32", "k4": "gpmpc_se_ard_gram_f32"}


def compare(kernel, other_src):
    """Build ``other_src`` (a source of kernel ``kernel`` with the same C
    interface) into its own library, check it against the plain version,
    and time it in turns with the repository's build of that kernel:
    other, repo, repo, other, at phase 11's shapes."""
    import ctypes
    from types import SimpleNamespace
    from gpmpc_tpu_torch.ops import cuda_kernels as ck
    from gpmpc_tpu_torch.ops import gp_cuda as gc
    from gpmpc_tpu_torch.systems import four_tank_ode

    card = card_line()
    dev = torch.device("cuda")
    log(f"[card] nvidia-smi: {card}")
    sym = COMPARE[kernel]
    repo = ck.build_library()
    so = ck.BUILD_DIR / f"{kernel}_other" / f"lib{kernel}_other.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    build = subprocess.run([ck._nvcc(), *ck.NVCC_FLAGS, "-shared", "-o",
                            str(so), other_src], capture_output=True,
                           text=True)
    if build.returncode != 0:
        raise RuntimeError(f"nvcc failed on {other_src}:\n{build.stdout}"
                           f"{build.stderr}")
    for line in (build.stdout + build.stderr).splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build other] {line.strip()}")
    fn = getattr(ctypes.CDLL(str(so)), sym)
    fn.argtypes, fn.restype = getattr(repo, sym).argtypes, ctypes.c_int
    libs = {"other": SimpleNamespace(**{sym: fn}), "repo": repo}

    def through(name, call, *args):
        keep, ck._lib = ck._lib, libs[name]
        try:
            return call(*args)
        finally:
            ck._lib = keep

    if kernel == "k1":
        err = through("other", ck.check_riccati_sweep,
                      ck.stage_qp_inputs(20, 4, 2, 0, device=dev),
                      torch.tensor(1e-6, device=dev))
        shape = "(Nt,nx,nu)=(20,4,2)"

        def times(name):
            k1_times(ck, dev, card, sweep=lambda *a: through(
                name, ck.riccati_sweep, *a))
    elif kernel == "k2":
        err = through("other", ck.check_rk4_substeps, four_tank_ode,
                      *ck.rk4_inputs(None, 1, dev), 0.3, 10)
        shape = "B=1, n_sub=10"
        sass_summary(so, "k2_other")
        sass_summary(ck.BUILD_INFO["path"], "repo")

        k2_chain_cycles(ck, dev, card)

        def times(name):
            k2_times(ck, four_tank_ode, dev, card, integrate=lambda *a:
                     through(name, ck.rk4_substeps, *a))
    elif kernel == "k3":
        err = through("other", gc.check_gp_predict_batch,
                      *gc.predict_inputs(100, 6, 100, 4, 100, device=dev))
        shape = "(Ny,B,N,D)=(4,100,100,6)"

        def times(name):
            k3_times(gc, dev, card, predict=lambda *a: through(
                name, gc.gp_predict_batch, *a))
    else:
        err = through("other", gc.check_se_ard_gram,
                      *gc.gram_inputs(100, 6, 8, 106, device=dev), 1e-6)
        shape = "(P,N,D)=(8,100,6)"

        def times(name):
            k4_times(gc, dev, card, gram=lambda *a: through(
                name, gc.se_ard_gram, *a))
    log(f"[{kernel} other] {other_src}: max|err| {err:.3e} against the plain "
        f"version at {shape}")
    for name in ("other", "repo", "repo", "other"):
        log(f"[{kernel} other] timing {name}")
        times(name)
    return 0


def k1_alone(other_src=None):
    """Phase 3's K1 and K2 checks and phase 11's K1 lines alone; with
    ``other_src``, ``compare("k1", other_src)``."""
    from gpmpc_tpu_torch.ops import cuda_kernels as ck
    from gpmpc_tpu_torch.systems import four_tank_ode

    if other_src is not None:
        return compare("k1", other_src)
    card = card_line()
    dev = torch.device("cuda")
    log(f"[card] nvidia-smi: {card}")
    ck.build_library()
    log_ptxas(ck)
    check_kernels(ck, four_tank_ode, dev)
    k1_times(ck, dev, card)
    return 0


def study_alone():
    """Phases 1-2 and 14, and phase 11's study rows, alone."""
    from gpmpc_tpu_torch.ops import cuda_kernels as ck
    card = card_line()
    dev = torch.device("cuda")
    log(f"[card] nvidia-smi: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    ck.build_library()
    log(f"[build] {time.perf_counter() - t0:.2f} s")
    launches, res = study_phase(ck, dev, card)
    rows = study_kernel_rows(ck, dev, card, launches, res,
                             {"riccati_sweep": 394, "rk4_substeps": 233})
    print(card_line(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    return 0


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
    if "--large-fit" in argv:
        return large_fit()
    if "--build-times" in argv:
        return build_times()
    if "--k5-paths" in argv:
        return k5_paths()
    if "--study" in argv:
        return study_alone()
    if "--k1" in argv:
        i = argv.index("--k1") + 1
        return k1_alone(argv[i] if i < len(argv) else None)
    if "--compare" in argv:
        i = argv.index("--compare")
        if len(argv) < i + 3 or argv[i + 1] not in COMPARE:
            print(f"chip_smoke: --compare needs one of {sorted(COMPARE)} and "
                  f"a source path", file=sys.stderr)
            return 2
        return compare(argv[i + 1], argv[i + 2])
    from benchmarks.bench_spec import DT, X0, XSP, closed_loop_cost
    from gpmpc_tpu_torch.ops import cuda_kernels as ck
    from gpmpc_tpu_torch.ops import gp_cuda as gc
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
    log_ptxas(ck)

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
              "rk4_substeps": N_STEPS, "se_ard_gram": 0, "cholesky": 0,
              "gp_predict_batch": 0}
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
    xs_c, us_c = build_slice(dev, CONVERGED).solve(X0, ANCHOR_STEPS * DT,
                                                   XSP, noise=False)
    cost_conv = closed_loop_cost(xs_c.cpu().numpy(), us_c.cpu().numpy(), XSP)
    cost_rti_a = closed_loop_cost(xs_np[:ANCHOR_STEPS + 1],
                                  us_np[:ANCHOR_STEPS], XSP)
    log(f"[slice] realized cost over the first {ANCHOR_STEPS} steps at X0: "
        f"RTI {cost_rti_a:.4f}, converged al4xmi20 {cost_conv:.4f}, ratio "
        f"{cost_rti_a / cost_conv:.5f} (information; converged run "
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
        f"device kernels, {prof['device_ms_per_step']:.3f} ms device time "
        f"({prof['all_rows_ms_per_step']:.3f} ms summed over every row, "
        f"CPU ops included, as PRs 1-6 summed it), "
        f"{prof['wall_ms_per_step']:.3f} ms wall under the profiler; device "
        f"busy {100 * prof['busy_share']:.2f}% on {card}")
    for name, count, us in prof["top"]:
        log(f"[profile]   {name:60s} {count:6d} launches/3 steps "
            f"{us:9.1f} us/step")

    # 7. the GP path's kernels against their plain versions
    errs = check_gp_kernels(gc, dev)
    errs.update(riccati_sweep=k1_err, rk4_substeps=k2_err)

    # 8. training at full width, 9. validation, 10. the trained GP's loop
    gp, train_launches = train_on_card(
        ck, dev, "fixture", dict(multistart=1, max_iters=100))
    train_on_card(ck, dev, "example",
                  dict(multistart=2, max_iters=200, seed=1))
    val_launches = validate_on_card(ck, dev, gp)
    t0 = time.perf_counter()
    xs_t, us_t = build_slice(dev, RTI, gp=gp).solve(X0, N_STEPS * DT, XSP,
                                                    noise=False)
    xs_t, us_t = xs_t.cpu().numpy(), us_t.cpu().numpy()
    if not (np.all(np.isfinite(xs_t)) and np.all(np.isfinite(us_t))):
        raise AssertionError("non-finite loop with the card-trained GP")
    miss = float(np.abs(xs_t[-1, :2] - XSP[:2]).max())
    cost_t = closed_loop_cost(xs_t, us_t, XSP)
    log(f"[trained] {N_STEPS}-step RTI loop with the card-trained GP "
        f"({time.perf_counter() - t0:.1f} s): ends {miss:.4f} from the "
        f"setpoint of the tracked tanks (<= 0.5), realized cost "
        f"{cost_t:.4f} against {cost_rti:.4f} with the fixture GP (ratio "
        f"{cost_t / cost_rti:.5f}, <= 1.1)")
    if miss > 0.5 or cost_t > 1.1 * cost_rti:
        raise AssertionError("the card-trained GP's closed loop misses")

    # 12. the car's closed loop, 13. the car's validation
    car_launches = car_loop(ck, dev, card)
    car_val_launches = car_validation(ck, gc, dev, card)

    # 14. the batched study
    study_launches, study_res = study_phase(ck, dev, card)

    # 11. kernel times beside their bounds
    times = kernel_times(ck, gc, four_tank_ode, dev, card)
    car_times = car_kernel_times(ck, gc, dev, card)
    k1_times(ck, dev, card)
    k4_times(gc, dev, card)
    k3_times(gc, dev, card)
    k2_times(ck, four_tank_ode, dev, card)
    k2_chain_cycles(ck, dev, card)
    path_launches = {"riccati_sweep": launches["riccati_sweep"],
                     "rk4_substeps": launches["rk4_substeps"],
                     "se_ard_gram": train_launches["se_ard_gram"],
                     "cholesky": train_launches["cholesky"],
                     "gp_predict_batch": val_launches["gp_predict_batch"]}
    sources = {"riccati_sweep": 394, "rk4_substeps": 233, "se_ard_gram": 78,
               "cholesky": 206, "gp_predict_batch": 459}
    rows = [{"name": name, "route": "cuda",
             "source": f"gpmpc_tpu_torch/csrc/{name}.cu",
             "replaces": f"gpmpc_tpu/ops/pallas_kernels.py:{line}",
             "launches": path_launches[name], "max_abs_err": errs[name],
             "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
             "device_ms": times[name]["device_ms"],
             "bound_ms": times[name]["bound"][0],
             "bound_by": times[name]["bound"][1],
             "library_ms": times[name]["library_ms"]}
            for name, line in sources.items()]
    # the car paths' instantiations: K1 at (6, 2) from the car loop, the K2
    # Car functor at B=200 from the car validation
    for name, kernel, launched in (
            ("riccati_sweep[6,2]", "riccati_sweep",
             car_launches["riccati_sweep"]),
            ("rk4_substeps[car]", "rk4_substeps",
             car_val_launches["rk4_substeps"])):
        r = car_times[name]
        rows.append({"name": name, "route": "cuda",
                     "source": f"gpmpc_tpu_torch/csrc/{kernel}.cu",
                     "replaces": f"gpmpc_tpu/ops/pallas_kernels.py:"
                                 f"{sources[kernel]}",
                     "launches": launched, "max_abs_err": CAR_ERRS[kernel],
                     "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "device_ms": r["dev"][0], "bound_ms": r["bound"][0],
                     "bound_by": r["bound"][1], "library_ms": None})
    rows += study_kernel_rows(ck, dev, card, study_launches, study_res,
                              sources)
    print(card_line(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
