"""Deployment walkthrough: export the controller, serve the artifact.

Counterpart of ``examples/deploy.py``.  The complete RTI solve step
(covariance refresh + AL-SQP + the KKT sweeps, K1 on the card + the GP
posterior) serializes to one ``torch.export`` artifact:

  build (this script)  ->  build/solve_step.pt2  ->  serving process
                                                     (torch and the port's
                                                      operators; no MPC, no
                                                      GP, no construction
                                                      code)

The script checks itself: the reloaded artifact must reproduce the live
controller's first solve, u0 and the predicted states (within 1e-10 in
f64 on the CPU; on the card the difference is printed and held to 1e-5),
then it drives a receding-horizon loop against the plant
(``model.integrate``; K2 on the card) with only the artifact computing
controls, threading its warm solver state, and the loop must bring the
tank levels within 1.0 of the setpoint.

On the card the controller is f32 with ``fused_kkt=True`` (K1 four times a
step) and the fused plant; ``--cpu`` builds it in f64 on the CPU.  The
step exported is the RTI budget (al2 x mi2): the artifact unrolls every
inner step, so a converged budget would make a graph of ~10^5 nodes.
``--cpu-built`` (on the card) also builds the controller on the CPU in
f32 with the card's GP and exports it for ``"cuda"`` (the port's form of
the JAX example's cross-platform lowering): its first solve on the card
must launch K1 four times and hold u0 and the predicted states within
1e-3 (relative) of the card-built artifact's.

Usage: python3 -m gpmpc_tpu_torch.examples.deploy [--quick] [--cpu]
                                                  [--cpu-built]
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

from gpmpc_tpu_torch import GP, MPC, Model
from gpmpc_tpu_torch.ops import cuda_kernels as ck
from gpmpc_tpu_torch.systems import four_tank_ode
from gpmpc_tpu_torch.utils.export import (EXPORT_INFO, _example_args,
                                          export_solve_step, load_solve_step)

DT = 3.0
X0 = np.array([8.0, 10.0, 1.0, 1.5])
XSP = np.array([12.4, 12.7, 1.8, 1.4])
#: the f32-safe GP recipe (benchmarks/make_bench_fixture.py)
F32_GP_OPTS = dict(jitter=1e-5, min_noise=1e-4)


def build_mpc(model, gp, dtype, device, fused):
    rti = dict(al_iters=2, max_iters=2, ls_steps=8, penalty_init=1e3,
               fused_kkt=fused)
    return MPC(horizon=5 * DT, model=model, gp=gp, gp_method="TA",
               discrete_method="gp", Q=np.diag([20.0, 20.0, 0.1, 0.1]),
               R=0.05 * np.eye(2), ulb=[0.0, 0.0], uub=[8.0, 8.0],
               xlb=[0.5, 0.5, 0.1, 0.1], xub=[16.0, 16.0, 8.0, 8.0],
               percentile=0.95, feedback=True, cov_updates=1,
               solver_opts=rti, dtype=dtype, device=device)


def build_model(dtype, device, fused):
    return Model(Nx=4, Nu=2, ode=four_tank_ode, dt=DT, R=np.diag([1e-3] * 4),
                 clip_negative=True, integrator_substeps=10,
                 fused_integrator=fused, dtype=dtype, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="smaller sizes")
    ap.add_argument("--cpu", action="store_true",
                    help="f64 on the CPU (default: f32 on the card)")
    ap.add_argument("--cpu-built", action="store_true",
                    help="also export the controller built on the CPU for "
                         "the card")
    args = ap.parse_args(argv)
    on_card = not args.cpu
    if on_card and not torch.cuda.is_available():
        print("deploy: no CUDA device; run with --cpu", file=sys.stderr)
        return 2
    device = torch.device("cuda" if on_card else "cpu")
    dtype = torch.float32 if on_card else torch.float64

    # ------------------------------------------------------------ build side
    n_train = 30 if args.quick else 80
    model = build_model(dtype, device, on_card)
    X, Y = model.generate_training_data(
        n_train, uub=[6.0, 6.0], ulb=[0.0, 0.0],
        xub=[20.0, 20.0, 6.0, 6.0], xlb=[1.0, 1.0, 0.5, 0.5],
        generator=torch.Generator(device=device).manual_seed(2))
    gp = GP(X, Y, mean_func="zero", gp_method="TA", multistart=1,
            max_iters=80 if args.quick else 150, seed=1, device=device,
            dtype=dtype, optimizer_opts=F32_GP_OPTS if on_card else None)
    mpc = build_mpc(model, gp, dtype, device, on_card)

    out_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "build")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "solve_step.pt2")
    t0 = time.perf_counter()
    blob = export_solve_step(mpc, path)
    info = EXPORT_INFO
    print(f"exported solve step: {len(blob) / 2**20:.1f} MiB, "
          f"{info['nodes']} nodes, "
          f"{info['ops'].get('gpmpc::riccati_sweep', 0)} K1 nodes, in "
          f"{time.perf_counter() - t0:.1f} s (trace {info['trace_s']:.1f}, "
          f"export {info['export_s']:.1f}, save {info['save_s']:.1f}) "
          f"on {device} -> {path}")

    # ------------------------------------------------------------ serve side
    # in production this half runs in another process with torch and the
    # port's operators; here the artifact is reloaded in-process and held
    # against the live MPC
    t0 = time.perf_counter()
    step = load_solve_step(path)
    print(f"loaded in {time.perf_counter() - t0:.1f} s")
    argv_ = _example_args(mpc, x0=X0, x_sp=XSP)
    ck.reset_launches()
    u0_art, warm_art, _ = step(*argv_)
    k1 = ck.LAUNCHES["riccati_sweep"]
    warm, x0, xsp_w, u_prev, sigma0, con_par, consts = argv_
    state_live, u0_live = mpc._solve_step(*argv_)[:2]
    u0_live = torch.clamp(u0_live, consts.ulb, consts.uub)
    du = float((u0_art - u0_live).abs().max())
    dx = float((warm_art.x - state_live.x).abs().max())
    tol = 1e-5 if on_card else 1e-10
    print(f"artifact vs live first solve: max |du| = {du:.3e}, predicted "
          f"states max |dx| = {dx:.3e} (<= {tol:g}); K1 launches in the "
          f"artifact's step: {k1}")
    assert max(du, dx) <= tol, \
        "deployed artifact diverged from the live controller"
    if on_card:
        assert k1 == 4, f"the artifact launched K1 {k1} times, not 4"

    if args.cpu_built:
        cpu = torch.device("cpu")
        gp_cpu = GP(X.cpu(), Y.cpu(), mean_func="zero", gp_method="TA",
                    hyper=type(gp.hyper)(*(t.cpu() for t in gp.hyper)),
                    train=False, device=cpu, dtype=dtype,
                    optimizer_opts=F32_GP_OPTS)
        mpc_cpu = build_mpc(build_model(dtype, cpu, False), gp_cpu, dtype,
                            cpu, True)
        t0 = time.perf_counter()
        moved = load_solve_step(export_solve_step(mpc_cpu, device="cuda"))
        ck.reset_launches()
        u0_moved, warm_moved, _ = moved(*argv_)
        k1 = ck.LAUNCHES["riccati_sweep"]
        rel = max(float(((a - b).abs() / (1.0 + b.abs())).max())
                  for a, b in ((u0_moved, u0_art), (warm_moved.x,
                                                    warm_art.x)))
        print(f"CPU-built artifact on the card ({time.perf_counter() - t0:.1f}"
              f" s to export, move and load): K1 launches {k1}, u0 "
              f"{u0_moved.tolist()} against the card-built "
              f"{u0_art.tolist()}, max relative difference of u0 and the "
              f"predicted states {rel:.3e} (<= 1e-3)")
        assert k1 == 4 and rel <= 1e-3, "the CPU-built artifact disagrees"

    # receding-horizon serving loop: only the artifact computes controls
    n_steps = 8 if args.quick else 15
    x, w, u_p = x0, warm_art, u0_art
    xs = [x.cpu().numpy()]
    for _ in range(n_steps):
        u0, w, _ = step(w, x, xsp_w, u_p, sigma0, con_par, consts)
        x = model.integrate(x, u0)          # the plant (external world)
        u_p = u0
        xs.append(x.cpu().numpy())
    xs = np.stack(xs)
    err = np.abs(xs[-1, :2] - XSP[:2]).max()
    print(f"deployed loop: {n_steps} steps, final level error {err:.3f} "
          f"(states finite: {np.isfinite(xs).all()})")
    assert np.isfinite(xs).all() and err < 1.0, \
        "deployed loop failed to regulate"
    print("deploy example OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
