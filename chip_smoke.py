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
     kernels and device time per step, the device's busy share);
  7. K4 (SE-ARD Gram), K5 (Cholesky) and K3 (batched GP predict) against
     their plain versions on the card at the JAX package's kernel-test
     shapes, plus K5's NaN on a matrix that is not positive definite;
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
 11. kernel, plain-version and library-call times of all five kernels at
     their paths' shapes beside each one's bound, with the card's name and
     power limit.
The last three lines are the card's name and power limit (nvidia-smi), a
JSON object with the kernels' rows, and {"ok": true, "device": {...}}.

``python3 chip_smoke.py --panel [--steps 140]`` instead measures the
quality gate: the realized-cost ratio RTI / converged over each initial
state of ``benchmarks.bench_spec.X0_PANEL`` (one process per state, all on
the one card), and its median, which must be <= 1.01.
``python3 chip_smoke.py --large-fit`` times the fixture's fit recipe at
N = 500 and 1000 training points through K5 and through cuSOLVER;
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
RTI = dict(al_iters=2, max_iters=2, ls_steps=8, penalty_init=1e3,
           fused_kkt=True)
CONVERGED = dict(al_iters=4, max_iters=20, fused_kkt=True)
#: the f32-safe GP recipe of benchmarks/make_bench_fixture.py
GP_OPTS = dict(jitter=1e-5, min_noise=1e-4)
#: one H100 SXM: HBM bytes/s and f32 (non-tensor-core) FLOP/s, published
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


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


def large_fit(ns=(500, 1000)):
    """The fixture's recipe at larger training sets, where K5 leaves shared
    memory and factors in place: for each N, four-tank training data from
    the fused plant (TRAIN_* bounds, noise, generator seed 2), then
    ``GP(X, Y)`` on the card twice, once through K5 and once with K5's
    plain version (cuSOLVER through ``cholesky_ex``) in its place, plus
    both factors' times at P=4 (one evaluation's Cholesky).  Prints wall
    seconds, batched evaluations and ms per evaluation of each fit."""
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
        log(f"[large] N={n}, P=4: K5 {cuda_time_ms(lambda: k5(a), 5):.3f} "
            f"ms, cholesky_ex "
            f"{cuda_time_ms(lambda: torch.linalg.cholesky_ex(a), 5):.3f} ms "
            f"on {card}")
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
                f"{1e3 * wall / gp.n_evals:.3f} ms per evaluation; K5 "
                f"launches {ck.LAUNCHES['cholesky']} on {card}")
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
    for n, d in [(40, 6), (100, 6), (200, 12), (130, 3)]:
        err = gc.check_se_ard_gram(*gc.gram_inputs(n, d, 8, n + d,
                                                   device=dev), 1e-6)
        log(f"[K4] (P,N,D)=(8,{n},{d}) max|err| {err:.3e} (rtol, atol 2e-5)")
        if (n, d) == (100, 6):
            errs["se_ard_gram"] = err
    for n, p in [(16, 8), (100, 8), (128, 8), (200, 8), (1024, 1)]:
        err = gc.check_cholesky(gc.spd_inputs(n, p, n, device=dev))
        log(f"[K5] (P,N)=({p},{n}) max|err| against the plain version in "
            f"f64 {err:.3e} (atol 2e-4 max|L|)")
        if n == 100:
            errs["cholesky"] = err
    a = gc.spd_inputs(100, 2, 1, device=dev)
    a[1, 40, 40] = -1e4
    gc.check_cholesky_not_pd(a[1:])
    log("[K5] not positive definite -> NaN lower triangle: ok")
    for n, d, b in [(90, 6, 33), (100, 6, 100)]:
        err = gc.check_gp_predict_batch(*gc.predict_inputs(n, d, b, 4, b,
                                                           device=dev))
        log(f"[K3] (N,D,B,Ny)=({n},{d},{b},4) max|err| k* {err:.3e} (k* 2e-5,"
            f" mu 2e-4)")
        if b == 100:
            errs["gp_predict_batch"] = err
    torch.cuda.synchronize()
    return errs


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


def kernel_times(ck, gc, four_tank_ode, dev, card):
    """Phase 11: each kernel's time beside its plain version's, the library
    call's (K5) and its bound, at the paths' shapes.  Returns rows keyed by
    kernel name."""
    from benchmarks.bench_spec import DT
    t = {}
    q1 = ck.stage_qp_inputs(20, 4, 2, 0, device=dev)
    reg = torch.tensor(1e-6, device=dev)
    out = ck.riccati_sweep(*q1, reg)
    t["riccati_sweep"] = dict(
        ms=cuda_time_ms(lambda: ck.riccati_sweep(*q1, reg), reps=200),
        plain_ms=cuda_time_ms(lambda: ck.riccati_sweep_reference(*q1, reg),
                              reps=20),
        library_ms=None, shape="Nt=20, nx=4, nu=2",
        bound=bound(nbytes(*q1, reg, *out), riccati_flops(20, 4, 2)))
    x1 = torch.tensor([8.0, 10.0, 1.0, 1.5], device=dev)
    u1 = torch.tensor([3.0, 3.0], device=dev)
    # per substep 4 ODE evaluations (~22 operations each) and ~52 for the
    # stage combinations
    t["rk4_substeps"] = dict(
        ms=cuda_time_ms(lambda: ck.rk4_substeps(four_tank_ode, x1, u1,
                                                DT / 10, 10), reps=200),
        plain_ms=cuda_time_ms(lambda: ck.rk4_substeps_reference(
            four_tank_ode, x1, u1, DT / 10, 10), reps=20),
        library_ms=None, shape="nx=4, nu=2, n_sub=10",
        bound=bound(nbytes(x1, u1, x1), 10 * (4 * 22 + 52)))
    g = gc.gram_inputs(100, 6, 8, 106, device=dev)
    k = gc.se_ard_gram(*g, 1e-5)
    t["se_ard_gram"] = dict(
        ms=cuda_time_ms(lambda: gc.se_ard_gram(*g, 1e-5), reps=200),
        plain_ms=cuda_time_ms(lambda: gc.se_ard_gram_reference(*g, 1e-5),
                              reps=50),
        library_ms=None, shape="P=8, N=100, D=6",
        bound=bound(nbytes(*g, k), 8 * 100 * 100 * (3 * 6 + 3)))
    t["cholesky"] = dict(
        ms=cuda_time_ms(lambda: gc.cholesky(k), reps=200),
        plain_ms=cuda_time_ms(lambda: gc.cholesky_reference(k), reps=50),
        library_ms=cuda_time_ms(lambda: torch.linalg.cholesky_ex(k),
                                reps=50),
        shape="P=8, N=100", bound=cholesky_bound(8, 100))
    big = gc.spd_inputs(1024, 1, 7, device=dev)
    big_ms = cuda_time_ms(lambda: gc.cholesky(big), reps=10)
    big_plain = cuda_time_ms(lambda: gc.cholesky_reference(big), reps=10)
    big_lib = cuda_time_ms(lambda: torch.linalg.cholesky_ex(big), reps=10)
    big_bound = cholesky_bound(1, 1024)
    p3 = gc.predict_inputs(100, 6, 100, 4, 100, device=dev)
    mu, ks = gc.gp_predict_batch(*p3)
    t["gp_predict_batch"] = dict(
        ms=cuda_time_ms(lambda: gc.gp_predict_batch(*p3), reps=200),
        plain_ms=cuda_time_ms(lambda: gc.gp_predict_batch_reference(*p3),
                              reps=50),
        library_ms=None, shape="Ny=4, B=100, N=100, D=6",
        bound=bound(nbytes(*p3, mu, ks), 4 * 100 * 100 * (3 * 6 + 5)))
    for name, r in t.items():
        lib = "none" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms"
        log(f"[time] {name} ({r['shape']}): kernel {r['ms']:.4f} ms, plain "
            f"torch on the card {r['plain_ms']:.4f} ms, library call {lib}, "
            f"bound {r['bound'][0]:.3e} ms ({r['bound'][1]}) on {card}")
    log(f"[time] cholesky (P=1, N=1024): kernel {big_ms:.4f} ms, plain "
        f"{big_plain:.4f} ms, library call {big_lib:.4f} ms, bound "
        f"{big_bound[0]:.3e} ms ({big_bound[1]}) on {card}")
    return t


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

    # 11. kernel times beside their bounds
    times = kernel_times(ck, gc, four_tank_ode, dev, card)
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
             "bound_ms": times[name]["bound"][0],
             "bound_by": times[name]["bound"][1],
             "library_ms": times[name]["library_ms"]}
            for name, line in sources.items()]
    print(card_line(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
