"""Smoke test of the PyTorch/CUDA port (gpmpc_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (each ends in torch.cuda.synchronize(); any failure raises and the
script exits non-zero before its last line):
  1. the card: nvidia-smi name and power limit, torch's device name;
  2. build the CUDA kernels from gpmpc_tpu_torch/csrc/ (nvcc, sm_90a;
     K1's block path among them), and beside that phase 4's traced K2
     ODEs traced, lowered and built (one nvcc each, all at once; the
     seconds printed);
  3. K1 (Riccati sweep) against its plain PyTorch version on the card, at
     the three shapes of the JAX package's kernel test, at Nt=300 (across
     the kernel's shared-memory chunks) and at B=1024 (Nt=20, and the
     batched study's Nt=8), at the car's
     (nx, nu) = (6, 2) with Nt=20 at B=1 and 64 and Nt=300, at the
     four-tank MHE's (4, 4) with Nt=5, Nt=20 at B=64 and Nt=300 (the
     pre-built shapes, cuda_kernels.RICCATI_SHAPES), plus an indefinite
     and a zero H_uu pivot at the default shapes, at (6, 2) and at (4, 4)
     (non-finite gains);
  4. K2 (RK4 substeps) against its plain version: one rollout, eight (one
     of them also at n_sub=7, the run-time loop, with a drained tank on
     the 1e-6 clamp) and 1024; the Car functor at 1, 200 and 1024, with
     steering at +-0.5 rad and headings past +-pi; then K2 traced for any
     ODE (ops/ode_trace.py): the four-tank plant as bench.py builds it (a
     lambda), the 1.3 kg quadrotor, the pendulum walkthrough's ODE and a
     closure over a CUDA tensor (built in phase 2), each held against its
     plain version over each rollout (the four-tank at 1, 8 with n_sub=7
     and a drained tank, and 1024, also against the hand-written
     FourTank; the quadrotor at 1, 64 and 1024; the others at 1 and 64);
  5. the main path at full width: the pinned four-tank GP (N=100, D=6,
     Ny=4), TA propagation with chance tightening, Nt=20, the RTI budget,
     the fused plant integrator, f32 on the card, an N_STEPS = 10-step
     closed loop from X0 to XSP; launch counts exact, values finite, the
     tracked tanks at their setpoint; each control step of the loop against the
     same step on the CPU (replay_against_cpu); realized cost over the
     first ANCHOR_STEPS = 1 step against the converged (al4 x mi20)
     budget's (cut from 30 steps to make room for the later phases; the
     loop itself 15 steps since phase 18, 10 since phase 20, every depth
     cut listed by its constant);
  6. per-step time, a torch.profiler trace of MAIN_PROFILED = 1 control
     step (three until phase 21 came; device kernels and device time per
     step, the device's busy share);
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
 10. the card-trained GP in an 8-step RTI loop from X0: finite, at the
     setpoint, realized cost within 10% of phase 5's over the same steps;
 11. kernel, device (torch.profiler), plain-version and library-call
     times of all five kernels at their paths' shapes beside each one's
     bound, K5 also at N = 500 to 2048, with the card's name and power
     limit; K1 also at B = 64 and 1024 and at Nt = 300, its device time
     over 20 and over 200 calls; K4 at (P, N) = (8, 100), (4, 500),
     (4, 1000) and (1, 2048) beside a fill_ of the same output (the
     practical write floor); K3 at (Ny, B, N, D) = (4, 100, 100, 6),
     (4, 1000, 500, 6) and (4, 1000, 1000, 6) beside a fill_ of the same
     k*; K2 at B = 1, 64 and 1024, and the SM cycles
     of its dependent chain (one thread between two clock64() reads); the
     traced K2 of phase 4's four-tank and quadrotor at B = 1, 64 and 1024
     (after FourTank's lines) and of the pendulum, the closure and phase
     22's network at B = 1, and the chain cycles of the traced four-tank
     and quadrotor; each beside the launch floor (a one-element add_) and
     nvidia-smi's SM clock and power draw over its window; the car's instantiations, K1
     at (6, 2) (Nt=20, B=1) and K2 Car at B = 1 and 200, and K3, K4, K5 at
     the car GP's shapes.  A profiler window that shows no device event is
     run once more, and the line says so;
 12. the car (bench config 4, bench.py:266-330) at full width: the pinned
     car fixture GP (N=80, D=6, Ny=4), EM propagation, the hybrid
     discretization, the delta-u penalty, two ellipse obstacles as user
     constraints with per-solve parameters, Nt=20, the RTI preset, f32; a
     30-step closed loop from x0 through MPC.solve: launch counts exact,
     values finite, px past the second obstacle, the clearance (min
     ellipse metric, floor 0.9; bench.py's 0.995 reported), ten steps
     replayed on the CPU (the first four and the three nearest each
     obstacle), ms per control step by CUDA events, a torch.profiler
     trace of one step (device activity only);
 13. the car's validation: 200 held-out points in its training box,
     targets integrate - rk4 through the fused plant (one K2 Car launch),
     the fixture GP's validate (one K3 launch), SMSE within 1.5x of the
     port's f64 validation on the CPU; K2 Car and K3 (k*, mean, and the
     variance formed from k*) against their plain versions on the
     validation's own inputs.  Phases 12-13 are a child process
     (``--phase-child car``) started after phase 6 that runs beside
     phases 7-18 and is checked after phase 18;
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
 15. slice F, part 1, at the main path's full width (the fixture GP,
     Nt=20, percentile 0.95, feedback, cov_updates=1, RTI, the fused
     plant, f32): (a) UT and (b) GH at order 3 (the 729-point tensor
     grid), each a 6-step closed loop from X0: launch counts exact (K3
     once per stage per covariance pass, K1 4 and K2 1 a step), finite,
     at the setpoint, the first four steps replayed on the CPU, the last
     step's stage 5 propagated on the card with no host sync and held
     against the CPU, K3 on its sigma points against its plain version,
     ms per step by CUDA events and a three-step profile beside the TA
     step's; (c) cubature5 at D = 8 (numpy-seeded GP, N = 100, Ny = 6) on
     the card with no host sync against the CPU in f64, Sigma_y PSD; (d)
     the Matérn-5/2 and -3/2 fits with the fixture's recipe: one K5 and no
     K4 per evaluation, three K5 per posterior, each dim's NLL (f64, CPU)
     within 0.1 of the port's f64 CPU fit; (e) a 6-step Matérn-5/2 TA
     loop with the card-fitted GP; (f) a 6-step loop with soft state
     boxes, lam with the terminal constraint (an empty terminal block) and
     an (M, Nx) ramp reference, every step replayed on the CPU.  Phase 15
     is a child process (``--phase-child slice_f``; its TA step from a
     3-step loop of its own) started after phase 14 that runs beside
     phases 16-18 and is checked after phase 18.
 16. slice F, part 2a, in f32 on the card: (a) the output-feedback
     golden's configuration (tests/golden_configs.py, run_mhe_golden) on
     the fixture GP: simulate_output_feedback for 6 steps with the
     golden's noise, the MHE (window 4, two levels measured, GP
     dynamics, the filtered arrival cost; al2 x mi5) through K1 at (4, 4),
     the TA MPC (Nt = 5, RTI after a fused al2 x mi10 cold start) through
     K1 at (4, 2), the fused plant through K2: launch counts exact by
     shape, states and estimates finite, every step's MHE window and MPC
     solve replayed on the CPU, one more MHE step with no host sync, the
     estimate error per step, ms per MHE and per MPC step; (b) K1 built at
     its first launch at (3, 3): the linear MHE of tests/test_mhe.py
     filtering 12 measurements (exact launches, against the CPU), K1 at
     (3, 3) and (4, 4) against the plain version at B = 1 and under vmap
     at B = 64, a zero and an indefinite pivot at both, the pairs just
     past the warp kernel's lane limits, (31, 2) and (4, 33), launching
     once on K1's block path, the build's seconds; (c) the
     quadrotor golden's configuration (run_quad_golden): its residual GP
     fitted on the card on 40 points drawn in its box (exact K4 and K5
     launches; in the whole smoke phase 21 (b)'s fit, the same recipe on
     the same draws through the fused plant, stands in), validated on 200
     fresh points (one K3; SMSE per dim), 6
     hybrid solve_steps on the 1.3 kg plant through K1 at (6, 2) (exact
     launches, every step replayed on the CPU), the same loop with the
     nominal model alone, the final position errors and each model's
     one-step prediction error on the heavy plant's transitions.
 17. slice F, part 3, at the main path's full width: (a) MPC.solve_mc,
     64 lanes x 6 steps (a fused al2 x mi10 cold start) through
     chance_calibration: K1 once per inner SQP step and K2 once per
     control step for all lanes, finite, lanes 0 and 63 replayed on the
     CPU, ms per ensemble step beside 64 x the single loop's step; (b) UT
     under solve_mc (16 lanes x 4 steps, K3 through its vmap rule with the
     lanes folded into B) and with per-lane online posteriors (2 steps, K3
     with a problem dim over the lanes), K3 vmapped against its plain
     version; (c) the adaptive DOPRI5 plant against the host integrator
     (a 20-step f64 sim, a 10-step f32 loop, the poisoning case) and the
     DAE network; (d) GP(inducing=32) with the fixture's recipe (K5 under
     both VFE Choleskys, exact launches), its bound per dim (f64, CPU)
     within 0.5 of the same f32 fit on the CPU (a child process), a
     10-step TA loop with it.
 18. slice G, the deployable solve step, at the main path's full width
     (the fixture GP, TA, Nt=20, RTI al2 x mi2 x ls8, fused_kkt, f32,
     the fused plant): (a) utils.export.export_solve_step on the card in
     a child process (``--export-artifact``; trace, export and save
     seconds, nodes, bytes; exactly 4 gpmpc::riccati_sweep nodes and no
     call of a Python function), 10 warm steps from X0 through the
     reloaded artifact and the fused plant beside the eager solve_step
     loop (K1 4 and K2 1 a step in each, the two within 1e-5; bitwise
     expected); (b) a fresh process
     (``--serve-artifact``) that builds only the plant loads the saved
     artifact and reproduces (a)'s trajectory; (c) ``python3 -m
     gpmpc_tpu_torch.examples.deploy --quick --cpu-built`` exits 0 (the
     artifact against the live first solve within 1e-5, the loop at the
     setpoint, the CPU-built artifact moved to the card launching K1 4
     times with u0 within 1e-3 of the card-built one's); (d) the exported
     step against the eager step by profiling.time_fn in turns, and a
     profiling.trace of three exported steps (kernels and device ms a
     step, busy share; the eager step's are phase 6's); K1 as the
     artifact calls it (through its operator) timed beside its bound.
     (a)'s export and (c) are child processes started before phase 17,
     and run beside it.
 19. the data-parallel surfaces over a torch.distributed mesh
     (parallel/distributed.py), in child processes (``--mesh-rank``)
     started after phase 8 that run beside phases 9-14, checked after
     phase 14: (a) one NCCL rank on the card (initialize_multihost with a
     file:// rendezvous, make_study_mesh's ("dp",) of size 1): phase 14
     (b)'s study at B=1024 for MESH_STUDY_STEPS steps through
     BatchedStudy(mesh=) (K1 3 launches a step and K2 1, each at
     B=1024), GP(tank_X, tank_Y, mesh=) with phase 8's example recipe
     (one K4 and one K5 an evaluation at P=8) and phase 17 (a)'s solve_mc
     at 64 lanes for MESH_MC_STEPS steps, each bitwise the run without a
     mesh (the fit: phase 8's); (b) two gloo ranks both on the card (NCCL
     refuses two ranks on one device): the same three at 512 rollouts,
     P=4 and 32 lanes a rank, every rank's gathered result against (a)'s
     (the loops within the replay bounds, the fit's NLL per dim within
     MESH_FIT_RTOL); the study's ms per step at each layout, the fit's
     wall, each rank's launches; K1, K2, K4 and K5 against their plain
     versions and timed at (b)'s block sizes.  ``--mesh`` on a machine of
     four cards runs (c) in place of (b): four NCCL ranks, one a card,
     held against (a) as (b) is.
 20. the walkthroughs gpmpc_tpu_torch/examples/pendulum.py (hybrid TA, the
     sat cost, al2 x mi8, 60 steps, its residual GP fitted at P = 4, N =
     120, D = 3) and batched_study.py (B = 1024 rollouts, 20 steps, the
     prior GP at P = 4, N = 50, D = 6) at their full settings, each
     ``main(quick=False, device="cuda")`` in a child process
     (``--example-child``) started after phase 6 that runs beside
     phases 7-18, checked after phase 18: each exits 0 (its own asserts),
     its self-check readings hold (the pendulum upright within 0.1 rad,
     |u| <= 5; the study finite, its checkpoint read back bitwise), its
     K4 and K5 launches are its fit's evaluations + 1 and + 3 and it
     launches no K1, K2 or K3; their wall, ms per control step and
     readings are printed, and K4 and K5 timed at the two fits' shapes.
 21. K2 traced on the main path and the quadrotor's, after phase 6: (a)
     the main path as the JAX package builds it (bench.py:457-480, its
     plant Model(ode=lambda x, u: four_tank_ode(x, u),
     fused_integrator=True, integrator_substeps=10)), N_STEPS RTI steps
     through MPC.solve: K1 4 and the traced K2 1 a step exactly, each next
     state within phase 5's replay bounds of phase 5's trajectory (the
     hand-written FourTank's); (b) phase 16 (c)'s quadrotor with its
     plant fused (the lambda over the 1.3 kg parameters traced): the
     residual data through vmap(plant.integrate) (one K2 launch), the
     fit (exact K4, K5), QUAD_STEPS hybrid steps (one K2 launch a step),
     every step replayed on the CPU under phase 16 (c)'s bounds.  Phase
     21 is a child process (``--phase-child traced_k2``) on phase 5's
     trajectory, started after phase 6, that runs beside phases 7-14 and
     is checked after phase 14; its fitted GP goes to phase 16 (c).
 22. K1 at any (nx, nu): a child process (``--phase-child network``)
     started after phase 6 that runs beside phases 7-18, checked
     after phase 18: (a) NET_UNITS = 10 four-tank units side by side
     (nx = 40, nu = 20; the plant's ODE a lambda of slices and a cat,
     traced into K2, 10 substeps; its unit built at its first launch and
     held against its plain version at 1 and 64 rollouts), each unit
     phase 16 (a)'s configuration with numpy-seeded offsets, under
     output feedback in f32 for NET_STEPS = 6 steps: the MHE (window 4,
     each unit's two lower levels measured, rk4, the filtered arrival cost;
     al2 x mi5) through K1 at (40, 40), the rk4 MPC (no GP, Nt = 20, a
     dense off-block state weight; RTI after a fused al2 x mi10 cold start)
     through K1 at (40, 20), both on K1's block path
     (csrc/riccati_sweep_block.cu), the traced K2 once a step: launch
     counts exact, finite, every step replayed on the CPU (phase 16 (a)'s
     bounds), the estimate error per step, ms per MHE and per MPC step; (b)
     K1's block path against its plain version at (nx, nu) = (31, 2), (4,
     33), (40, 20), (40, 40) and (96, 48) (its working set in a workspace
     in device memory), B = 1 and 64 (through the vmap rule), Nt = 3, 20
     and 33, one launch each, an indefinite and a zero pivot at each pair,
     and the kernel's layout against the wrapper's mirror at 301 pairs.
Phases 12-22 run before phase 11, whose JSON rows carry their launch
counts (K1 at (1024, 8, 4, 2) and K2 at B=1024 get rows of their own, as
do K3 at the UT and GH sigma points, K5 under the Matérn-5/2 fit, and K1
at (4, 4) under the MHE, at (3, 3) built on demand and at (6, 2) under the
quadrotor, K1, K2, K4 and K5 at phase 19's two-rank block sizes, K4
and K5 at phase 20's two fits, the traced K2 of phase 21 (a) and (b) and
of phase 22's network, and K1's block path at phase 22's (40, 20) and
(40, 40); its lines at (40, 20) with B = 64 and at (96, 48) are logged).
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
``python3 chip_smoke.py --compare {k1,k1block,k2,k3,k4} OTHER_SRC``
builds OTHER_SRC (another version of that kernel's source with the same
C interface, e.g. the parent commit's, written out with ``git show``)
into its own library, checks it against the plain version, and times it
in turns with the repository's kernel (other, repo, repo, other) at
phase 11's shapes (for k1 also each pre-built (nx, nu) of both builds,
bitwise; for k1block, K1's block path, first both builds' time by
section as ``--k1`` takes it, the other's where its source carries
GPMPC_RICCATI_STAMPS, then phase 11's block rows and (96, 48) at Nt =
20, the other build's workspace sized by its own layout); for
k2 it also writes both builds' SASS (cuobjdump) under the build
directory, counts the K2 kernels' instructions by opcode and reads the
repository K2's chain in SM cycles;
``python3 chip_smoke.py --k1 [OTHER_SRC]`` runs phase 3's K1 and K2 checks,
phase 22 (b)'s block-path checks with the tile and panel edges
(K1_EDGE_SHAPES), the block path's time by section (its source built
with GPMPC_RICCATI_STAMPS into a library of its own: SM cycles of the
stage copy, products, Cholesky, solves, value update and rollout, beside
the SM clock) and phase 11's K1 lines and block-path rows alone, and
with OTHER_SRC is ``--compare k1``;
``python3 chip_smoke.py --study`` runs phases 1-2 and 14 and the study's
kernel rows alone; ``--network`` phases 1-2, phase 22 and its block-path
rows; ``--traced-k2`` phases 1-2, phase 4's traced K2,
phase 5's loop, phase 21 and phase 11's traced K2 lines and rows;
``python3 chip_smoke.py --slice-f`` phases 1-2 and 15 and their kernel
rows; ``python3 chip_smoke.py --slice-f2`` phases 1-2
and 16 and their kernel rows; ``--slice-f3`` phases 1-2 and 17, and
``--slice-g`` phases 1-2 and 18, and ``--mesh`` phases 1-2, phase 8's
example fit and phase 19, each with their kernel rows;
``python3 chip_smoke.py --examples [NAME ...] [--full] [--steps N]`` runs
the named walkthroughs (all nine without a name) on the card, ``--quick``
sizes unless ``--full``, each in a child process, all at once, and prints
each one's wall, ms per control step, readings and launches; with
``--steps N`` (four_tank, car, dae_network, whose loops outlast a call on
the card) it times each of their controllers' cold step and N warm steps
instead;
``python3 chip_smoke.py --build-times`` times the kernels' build, one
``nvcc`` over all sources against one per source at once.
The script imports no JAX.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
#: steps of phase 5's closed loop, each replayed on the CPU (the main path
#: is within 0.01 of its setpoint by step 10; 30 until phase 18 came, 15
#: until phase 20 came)
N_STEPS = 10
#: steps of phase 5's converged (al4 x mi20) anchor, compared with the
#: first ANCHOR_STEPS of the RTI loop: cut from N_STEPS to make room for
#: the car's phases within the smoke's time (3 until phase 16 came, 2
#: until phase 18 came)
ANCHOR_STEPS = 1
#: steps of phase 10's loop with the card-trained GP (30 until the smoke
#: passed 900 s with phase 16, 20 until phase 18 came, 12 until phase 20
#: came)
TRAINED_STEPS = 8
RTI = dict(al_iters=2, max_iters=2, ls_steps=8, penalty_init=1e3,
           fused_kkt=True)
CONVERGED = dict(al_iters=4, max_iters=20, fused_kkt=True)
#: RTI steps under torch.profiler in phase 6 (3 until phase 21 came: the
#: CPU ops' trace of a step takes ~10 s to read back)
MAIN_PROFILED = 1
#: the f32-safe GP recipe of benchmarks/make_bench_fixture.py
GP_OPTS = dict(jitter=1e-5, min_noise=1e-4)
#: one H100 SXM: HBM bytes/s and f32 (non-tensor-core) FLOP/s, published
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
#: streaming multiprocessors of an H100 SXM
H100_SMS = 132
#: the car bench (bench config 4): control period, the closed loop's steps
#: (the second obstacle's far edge, px = 13.5, is passed by step ~25; 40
#: until the smoke passed 900 s with phase 16), the steps replayed on the
#: CPU nearest each obstacle besides the first ones, and the clearance
#: floor of this smoke
#: (below the JAX package's own f64 reading, 0.946, far above a loop that
#: drives through an obstacle, ~0.1-0.5); bench.py's gate is 0.995
CAR_DT = 0.1
CAR_STEPS = 30
CAR_NEAREST = 3
#: car steps under torch.profiler (three until the smoke passed 900 s:
#: ~20 s of wall a profiled car step)
CAR_PROFILED = 1
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
    # the four-tank MHE's (4, 4) (its NLP's input slot carries the 4
    # process noises): its window's Nt=5, a batch, a horizon across the
    # chunks
    for nt, batch in [(5, None), (20, 64), (300, None)]:
        err = ck.check_riccati_sweep(
            ck.stage_qp_inputs(nt, 4, 4, nt + 4, batch, device=dev),
            torch.full(() if batch is None else (batch,), 1e-6, device=dev))
        log(f"[K1] B={batch or 1}, (Nt,nx,nu)=({nt},4,4) max|err| {err:.3e}")
    # bad pivots without regularization: non-finite gains, so ok=False
    # upstream
    for kind in ("indefinite", "zero"):
        for shape in (None, (20, 6, 2), (5, 4, 4)):
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


def build_slice(dev, solver_opts, gp=None, gp_method="TA", model=None,
                **mpc_kw):
    """The main path's controller, with the pinned fixture GP unless ``gp``
    is given and the fused plant unless ``model`` is, propagating by
    ``gp_method``; ``mpc_kw`` adds MPC options (phase 15's soft and
    terminal constraints, phase 17's cold-start budget)."""
    from benchmarks.bench_spec import NT, Q_W, R_W, ULB, UUB, XLB, XSP, XUB
    from gpmpc_tpu_torch import MPC
    from gpmpc_tpu_torch.models.convert import gp_from_fixture

    model = build_plant(dev) if model is None else model
    if gp is None:
        gp = gp_from_fixture(device=dev, dtype=torch.float32,
                             gp_method=gp_method, optimizer_opts=GP_OPTS)
    return MPC(horizon=NT * model.dt, model=model, gp=gp,
               gp_method=gp_method, discrete_method="gp", Q=Q_W, R=R_W,
               ulb=ULB, uub=UUB, xlb=XLB, xub=XUB, percentile=0.95,
               feedback=True, cov_updates=1, op_x=XSP,
               op_u=np.array([3.0, 3.0]), solver_opts=solver_opts,
               device=dev, **mpc_kw)


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


def fixture_nll_f64(hyper, kernel="se"):
    """NLL per dim of the log hypers ``(log_ell, log_sf2, log_sn2)`` of the
    ``kernel`` family on the fixture's normalized training set, in f64 on
    the CPU through the plain versions."""
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
                             GPConfig(kernel=kernel, **GP_OPTS),
                             "zero").numpy()


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


def trained_loop(dev, gp, xs_np, us_np):
    """Phase 10: the card-trained GP in a TRAINED_STEPS-step RTI loop from
    X0, against phase 5's loop ``xs_np``, ``us_np`` over the same steps."""
    from benchmarks.bench_spec import DT, X0, XSP, closed_loop_cost

    t0 = time.perf_counter()
    xs_t, us_t = build_slice(dev, RTI, gp=gp).solve(X0, TRAINED_STEPS * DT,
                                                    XSP, noise=False)
    xs_t, us_t = xs_t.cpu().numpy(), us_t.cpu().numpy()
    if not (np.all(np.isfinite(xs_t)) and np.all(np.isfinite(us_t))):
        raise AssertionError("non-finite loop with the card-trained GP")
    miss = float(np.abs(xs_t[-1, :2] - XSP[:2]).max())
    cost_t = closed_loop_cost(xs_t, us_t, XSP)
    cost_f = closed_loop_cost(xs_np[:TRAINED_STEPS + 1],
                              us_np[:TRAINED_STEPS], XSP)
    log(f"[trained] {TRAINED_STEPS}-step RTI loop with the card-trained GP "
        f"({time.perf_counter() - t0:.1f} s): ends {miss:.4f} from the "
        f"setpoint of the tracked tanks (<= 0.5), realized cost "
        f"{cost_t:.4f} against {cost_f:.4f} over the same steps with the "
        f"fixture GP (ratio {cost_t / cost_f:.5f}, <= 1.1)")
    if miss > 0.5 or cost_t > 1.1 * cost_f:
        raise AssertionError("the card-trained GP's closed loop misses")


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
    parameters; its reference window in ``refs``), the last step's output
    state, and a CUDA event at the start of each step.  The cold-start
    preparation (which passes ``cfg``) is not recorded."""

    def __init__(self, mpc):
        self.calls, self.refs, self.events, self.last = [], [], [], None
        inner = mpc._solve_step

        def solve_step(warm, x0, x_sp, u_prev, sigma0, con_par, consts,
                       cfg=None):
            if cfg is None:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                self.events.append(ev)
                self.calls.append((warm, x0, u_prev, con_par))
                self.refs.append(x_sp)
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
    torch.profiler trace of CAR_PROFILED steps (device activity only: with the
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

    prof = profile_steps(step, n=CAR_PROFILED, cpu_ops=False)
    log(f"[profile] per car control step: {prof['kernels_per_step']:.0f} "
        f"device kernels, {prof['device_ms_per_step']:.3f} ms device time, "
        f"{prof['wall_ms_per_step']:.3f} ms wall under the profiler; device "
        f"busy {100 * prof['busy_share']:.2f}% on {card}")
    for name, count, us_ in prof["top"]:
        log(f"[profile]   {name:60s} {count:6d} launches/{CAR_PROFILED} "
            f"step(s) {us_:9.1f} us/step")
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


def build_study(dev, fused, mesh=None):
    """The batched study as bench.py builds it (bench config 5) on ``dev``,
    f32: the pinned fixture GP, capacity 128, saturate, Nt=8, the al1 x mi3
    x ls4 budget, the plant with clip_negative; with ``fused`` the KKT
    sweep kernel (K1) and the fused plant (K2); sharded over ``mesh``."""
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
                        solver_opts=opts, mesh=mesh)


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


# ------------------------------------------------------------------ phase 15

#: phase 15 (slice F, part 1): the steps of the UT, GH and Matérn closed
#: loops and how many of the first are replayed on the CPU, the soft and
#: terminal constraints' loop (every step replayed), the stage of the last
#: step whose propagation is held card against CPU, and the cubature5 GP
#: (numpy-seeded, the quadrotor's hybrid input and output widths D = 8,
#: Ny = 6 at the fixture's N = 100); the loops were 12 steps and the soft
#: loop 10 until phase 18 came, the loops 10 steps until phase 20 came
F_STEPS = 6
F_REPLAY = 4
F_SOFT_STEPS = 6
F_STAGE = 5
CUB_N, CUB_D, CUB_NY = 100, 8, 6
#: phase 15 (f)'s options: the state boxes and the terminal constraint
#: softened, ||x_N - x_ref||^2 <= 4 as a penalty (no terminal AL row)
F_SOFT = dict(lam_state=1e3, lam=100.0, terminal_constraint=4.0)
#: bounds of a propagation's outputs on the card against the same
#: propagation on the CPU, relative to each output's largest entry: mu_y
#: within K3's mean tolerance (2e-4); Sigma_y and C within 1e-2, since
#: they are weighted sums of the points' deviations mus - mu_y, ~0.1 of
#: mus, which carry K3's errors ~10x (first reading 1.1e-3 and 1.8e-3 at
#: a UT stage, H100 80GB HBM3 at 700 W; a wrong point, weight or root is
#: off by O(1))
F_PROP_TOL = (2e-4, 1e-2, 1e-2)


def replay_steps(mpc, rec, xs, steps, build):
    """Per-step check of a loop on the card against the CPU, as
    :func:`replay_against_cpu` bounds it: at each of ``steps``, solve the
    step on the CPU (``build(cpu)``'s controller with the card's constants)
    from the card's recorded state, warm start, last input and reference
    window, step the CPU plant, and hold the card's next state within
    rtol 1e-2 in the transient (the first TRANSIENT_STEPS) and 1e-3
    after.  Returns the worst (transient, tracking) differences."""
    from gpmpc_tpu_torch.solvers.al_sqp import SolverState
    cpu = build(torch.device("cpu"))
    cpu.consts = to_cpu(mpc.consts)
    worst = [0.0, 0.0]
    for k in steps:
        warm, x, u_prev, _ = rec.calls[k]
        u_c, _, _, _ = cpu.solve_step(
            x.cpu(), rec.refs[k].cpu(),
            warm=SolverState(*(t.cpu() for t in warm)), u_prev=u_prev.cpu())
        x_c = cpu.model.integrate(x.cpu(), u_c).clamp(min=0.0)
        rel = float((torch.as_tensor(xs[k + 1]) - x_c).abs().div(
            x_c.abs()).max())
        phase = int(k >= TRANSIENT_STEPS)
        worst[phase] = max(worst[phase], rel)
    if worst[0] > 1e-2 or worst[1] > 1e-3:
        raise AssertionError(f"card and CPU steps disagree: {worst}")
    return worst


def rti_step_fn(mpc, x, u, warm):
    """One RTI control step of ``mpc`` (solve_step + plant step) from
    state ``x``, last input ``u`` and warm start ``warm``; each call
    advances them."""
    from benchmarks.bench_spec import XSP
    dev = mpc.device
    state = {"x": torch.as_tensor(x, device=dev), "warm": warm,
             "u": torch.as_tensor(u, device=dev)}

    def step():
        u_, w, _, _ = mpc.solve_step(state["x"], XSP, warm=state["warm"],
                                     u_prev=state["u"])
        state.update(u=u_, warm=w, x=mpc.model.integrate(state["x"], u_))

    return step


def step_numbers(step, card, tag):
    """ms per control step by CUDA events over 10 steps after 3 of warm-up
    (as phase 6 times the TA step), and a torch.profiler trace of three
    steps, device activity only (the same for every scheme compared)."""
    ms = cuda_time_ms(step, reps=10)
    prof = profile_steps(step, cpu_ops=False)
    log(f"[slice F] {tag} RTI control step: {ms:.3f} ms/step (CUDA events,"
        f" 10 steps after 3); profile (device activity only): "
        f"{prof['kernels_per_step']:.0f} device kernels, "
        f"{prof['device_ms_per_step']:.3f} ms device time, "
        f"{prof['wall_ms_per_step']:.3f} ms wall a step; device busy "
        f"{100 * prof['busy_share']:.2f}% on {card}")
    return ms, prof


def k3_row(gc, args, launches, err, card, name):
    """K3's JSON row at ``args``: event ms over 200 calls, device ms per
    launch, the plain version's ms and the bound."""
    ny, b, n, d = (args[2].shape[0], args[0].shape[0], args[1].shape[0],
                   args[0].shape[1])
    mu, ks = gc.gp_predict_batch(*args)
    ms = cuda_time_ms(lambda: gc.gp_predict_batch(*args), reps=200)
    dev_ms, _, note = device_time_ms(lambda: gc.gp_predict_batch(*args))
    plain = cuda_time_ms(lambda: gc.gp_predict_batch_reference(*args),
                         reps=50)
    bd = bound(nbytes(*args, mu, ks), ny * b * n * (3 * d + 5))
    log(f"[time] gp_predict_batch[{name}] (Ny,B,N,D)=({ny},{b},{n},{d}) on "
        f"the loop's sigma points: kernel {ms:.4f} ms, device "
        f"{fmt_ms(dev_ms)}{note} per launch, plain torch on the card "
        f"{plain:.4f} ms, bound {bd[0]:.3e} ms ({bd[1]}); {launches} "
        f"launches in the loop; max|err| k* {err:.3e} on {card}")
    return {"name": f"gp_predict_batch[{name}]", "route": "cuda",
            "source": "gpmpc_tpu_torch/csrc/gp_predict_batch.cu",
            "replaces": "gpmpc_tpu/ops/pallas_kernels.py:459",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain, "device_ms": dev_ms, "bound_ms": bd[0],
            "bound_by": bd[1], "library_ms": None}


def sigma_point_loop(ck, gc, dev, card, method):
    """Phase 15 (a) UT and (b) GH (order 3: the 3^6 = 729-point tensor
    grid): the main path with ``method`` propagation, an F_STEPS-step
    closed loop from X0 through MPC.solve.  Exact launch counts (K1
    al_iters x max_iters and K2 once a step, K3 once per stage per
    covariance pass of every solve, the cold start's included); finite,
    the tracked tanks at their setpoint; the first F_REPLAY steps replayed
    on the CPU; the last step's stage F_STAGE propagated on the card (no
    host sync, under torch.cuda.set_sync_debug_mode("error")) and on the
    CPU from the same inputs, within F_PROP_TOL; K3 on that stage's sigma
    points against its plain version.  Returns the K3 row, ms per step and
    the profile."""
    from benchmarks.bench_spec import DT, X0, XSP
    mpc = build_slice(dev, RTI, gp_method=method)
    rec = StepRecorder(mpc)
    props = []
    inner = mpc._propagator

    def prop(post, norm, cfg, z, sigma_z):
        props.append((z, sigma_z))
        return inner(post, norm, cfg, z, sigma_z)

    mpc._propagator = prop
    ck.reset_launches()
    t0 = time.perf_counter()
    xs, us = mpc.solve(X0, F_STEPS * DT, XSP, noise=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mpc._propagator = inner
    launches = dict(ck.LAUNCHES)
    cfg, init = mpc.sqp_cfg, mpc.init_sqp_cfg
    per_solve = max(mpc.cov_updates, 1) * mpc.Nt      # K3: once a stage
    solves = F_STEPS + int(init != cfg)               # + the cold start
    expect = {"riccati_sweep": F_STEPS * cfg.al_iters * cfg.max_iters
              + (init.al_iters * init.max_iters if init.fused_kkt and
                 init != cfg else 0),
              "rk4_substeps": F_STEPS, "se_ard_gram": 0, "cholesky": 0,
              "gp_predict_batch": solves * per_solve}
    log(f"[slice F] ({method}) {F_STEPS}-step closed loop (fixture GP, "
        f"{method}, Nt={mpc.Nt}, RTI, fused plant, f32): {wall:.3f} s "
        f"(cold start included); launches {launches}, expected {expect} "
        f"(K3 {per_solve} per control step: {mpc.Nt} stages x "
        f"{max(mpc.cov_updates, 1)} covariance pass; {solves} solves)")
    if launches != expect:
        raise AssertionError(f"{method} launch counts {launches} != "
                             f"{expect}")
    if len(props) != solves * per_solve:
        raise AssertionError(f"{len(props)} propagations, expected "
                             f"{solves * per_solve}")
    xs, us = xs.cpu().numpy(), us.cpu().numpy()
    if not (np.all(np.isfinite(xs)) and np.all(np.isfinite(us))
            and np.all(np.isfinite(mpc.last_run["sigmas"]))):
        raise AssertionError(f"non-finite {method} closed loop")
    miss = float(np.abs(xs[-1, :2] - XSP[:2]).max())
    ev = rec.events
    step_ms = [ev[k].elapsed_time(ev[k + 1]) for k in range(4, len(ev) - 1)]
    log(f"[slice F] ({method}) final state {xs[-1].tolist()}, "
        f"{miss:.4f} from the setpoint of the tracked tanks (<= 0.5); "
        f"converged {int(mpc.last_run['converged'].sum())}/{F_STEPS}; loop "
        f"step by CUDA events between step starts 4..{len(ev) - 1}: mean "
        f"{np.mean(step_ms):.3f} ms, median {np.median(step_ms):.3f} ms on "
        f"{card}")
    if miss > 0.5:
        raise AssertionError(f"the {method} loop misses the setpoint")
    t0 = time.perf_counter()
    worst = replay_steps(mpc, rec, xs, range(F_REPLAY),
                         lambda d: build_slice(d, RTI, gp_method=method))
    log(f"[slice F] ({method}) steps 0-{F_REPLAY - 1} replayed on the CPU "
        f"({time.perf_counter() - t0:.1f} s): max relative next-state "
        f"difference {worst[0]:.3e} (rtol 1e-2, the transient)")
    # the last step's stage F_STAGE: card (no host sync) against the CPU
    z, sigma_z = props[-per_solve + F_STAGE]
    c0 = mpc.consts
    k3_args = []
    kernel = gc.gp_predict_batch

    def recorded(*args):
        k3_args.append(args)
        return kernel(*args)

    gc.gp_predict_batch = recorded
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = inner(c0.post, c0.norm, mpc._gp_cfg, z, sigma_z)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        gc.gp_predict_batch = kernel
    torch.cuda.synchronize()
    ref = inner(to_cpu(c0.post), to_cpu(c0.norm), mpc._gp_cfg, z.cpu(),
                sigma_z.cpu())
    gaps = [float((o.cpu() - r).abs().max() / r.abs().max())
            for o, r in zip(out, ref)]
    log(f"[slice F] ({method}) stage {F_STAGE} of the last step, propagated"
        f" on the card with no host sync (set_sync_debug_mode('error')) and"
        f" on the CPU: max |diff| / max |ref| mu {gaps[0]:.3e}, Sigma_y "
        f"{gaps[1]:.3e}, C {gaps[2]:.3e} (<= {F_PROP_TOL}); K3 launches in "
        f"it {len(k3_args)}")
    if len(k3_args) != 1 or any(g > t for g, t in zip(gaps, F_PROP_TOL)):
        raise AssertionError(f"the {method} propagation on the card is off "
                             f"the CPU's")
    err = gc.check_gp_predict_batch(*k3_args[0])
    row = k3_row(gc, k3_args[0], launches["gp_predict_batch"], err, card,
                 method.lower())
    ms, prof = step_numbers(rti_step_fn(mpc, xs[-1], us[-1], rec.last), card,
                            method)
    return row, ms, prof


def cubature5_check(ck, dev, card):
    """Phase 15 (c): propagate_gh with the cubature5 rule at D = 8 on a GP
    made by gp_from_numpy from numpy-seeded data (N = 100, Ny = 6), on the
    card under torch.cuda.set_sync_debug_mode("error") (its PSD floor is
    fixed Jacobi sweeps: no host sync), one K3 launch, against the port in
    f64 on the CPU within F_PROP_TOL, Sigma_y PSD.  For information, how
    many host syncs torch.linalg.eigh makes on the same Sigma_y (the JAX
    package floors with eigh)."""
    import warnings
    from gpmpc_tpu_torch.models.convert import gp_from_numpy
    from gpmpc_tpu_torch.models.propagate import propagate_gh

    rng = np.random.default_rng(15)
    x = rng.uniform(-2, 2, (CUB_N, CUB_D))
    y = np.stack([np.sin(x[:, i]) * x[:, (i + 3) % CUB_D] + 0.1 * x[:, i - 1]
                  for i in range(CUB_NY)], axis=1)
    hyp = dict(log_ell=0.3 * rng.standard_normal((CUB_NY, CUB_D)) + 0.5,
               log_sf2=0.2 * rng.standard_normal(CUB_NY),
               log_sn2=np.full(CUB_NY, -6.0))
    g = gp_from_numpy(x, y, **hyp, device=dev, dtype=torch.float32,
                      optimizer_opts=GP_OPTS)
    g64 = gp_from_numpy(x, y, **hyp, device="cpu", dtype=torch.float64,
                        optimizer_opts=GP_OPTS)
    a = 0.3 * rng.standard_normal((CUB_D, CUB_D))
    mu, cov = rng.uniform(-1, 1, CUB_D), a @ a.T
    args = [torch.tensor(v, dtype=torch.float32, device=dev)
            for v in (mu, cov)]

    def run():
        return propagate_gh(g.post, g.norm, g.cfg, *args, grid="cubature5")

    run()                       # the rule's and the sweeps' index tensors
    torch.cuda.synchronize()
    ck.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    ref = propagate_gh(g64.post, g64.norm, g64.cfg, torch.tensor(mu),
                       torch.tensor(cov), grid="cubature5")
    gaps = [float((o.cpu().double() - r).abs().max() / r.abs().max())
            for o, r in zip(out, ref)]
    ev = float(torch.linalg.eigvalsh(out[1].cpu().double()).min())
    scale = float(out[1].abs().max())
    ms = cuda_time_ms(run, reps=20)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            torch.linalg.eigh(out[1])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    log(f"[slice F] (cubature5) D={CUB_D}, Ny={CUB_NY}, N={CUB_N}, "
        f"{2 * CUB_D * CUB_D + 1} points: no host sync on the card; "
        f"launches {launches}; card f32 against CPU f64: max |diff| / max "
        f"|ref| mu {gaps[0]:.3e}, Sigma_y {gaps[1]:.3e}, C {gaps[2]:.3e} (<= "
        f"{F_PROP_TOL}); min eigenvalue of Sigma_y {ev:.3e} (scale "
        f"{scale:.3e}); {ms:.3f} ms a propagation (CUDA events, 20 calls); "
        f"torch.linalg.eigh on the same Sigma_y: {syncs} host sync "
        f"warning(s) (information) on {card}")
    if launches["gp_predict_batch"] != 1 or ev < -1e-6 * scale or any(
            g > t for g, t in zip(gaps, F_PROP_TOL)):
        raise AssertionError("cubature5 on the card is off the CPU's")


def matern_fit(ck, dev, card, kernel):
    """Phase 15 (d): GP(tank_X, tank_Y, kernel=kernel) trained on the card
    with the fixture's recipe (multistart=1, max_iters=100, GP_OPTS):
    exact launch counts (one K5 and no K4 per objective evaluation, three
    K5 for the posterior); each dim's NLL re-evaluated in f64 on the CPU
    at the card's hypers within 0.1 of the port's f64 CPU fit with the
    same recipe.  Returns the GP and its launches."""
    from gpmpc_tpu_torch import GP
    from gpmpc_tpu_torch.models import gp_core
    from gpmpc_tpu_torch.models.convert import FIXTURE
    from gpmpc_tpu_torch.utils.config import GPConfig

    f = np.load(FIXTURE)
    recipe = dict(multistart=1, max_iters=100)
    ck.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gp = GP(f["tank_X"], f["tank_Y"], kernel=kernel, mean_func="zero",
            gp_method="TA", optimizer_opts=GP_OPTS, device=dev,
            dtype=torch.float32, **recipe)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    expect = {"riccati_sweep": 0, "rk4_substeps": 0, "se_ard_gram": 0,
              "cholesky": gp.n_evals + 3, "gp_predict_batch": 0}
    log(f"[slice F] ({kernel} fit) fixture recipe {recipe} on the card: "
        f"{wall:.3f} s wall, {gp.n_evals} batched objective evaluations "
        f"({1e3 * wall / gp.n_evals:.3f} ms each); launches {launches}")
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")
    nll = fixture_nll_f64(gp.hyper[:3], kernel)
    f64 = dict(dtype=torch.float64)
    x, y = (torch.tensor(f[k], **f64) for k in ("tank_X", "tank_Y"))
    t0 = time.perf_counter()
    _, ref, _ = gp_core.fit((x - x.mean(0)) / x.std(0, correction=0),
                            (y - y.mean(0)) / y.std(0, correction=0),
                            GPConfig(kernel=kernel, **recipe, **GP_OPTS),
                            torch.Generator().manual_seed(0))
    ref = ref.numpy()
    gap = np.abs(nll - ref)
    log(f"[slice F] ({kernel} fit) NLL per dim (f64 on the CPU at the "
        f"card's hypers) {nll.tolist()}, the port's f64 CPU fit "
        f"{ref.tolist()} ({time.perf_counter() - t0:.1f} s), max gap "
        f"{gap.max():.4f} (<= 0.1)")
    if not (np.all(np.isfinite(nll)) and gap.max() <= 0.1):
        raise AssertionError(f"the {kernel} fit on the card is off the "
                             f"CPU's")
    return gp, launches


def k5_matern_row(gc, gp, launches, card):
    """K5's JSON row at the Matérn fit's shape, on the Gram of the card's
    fitted hypers: held against its plain version, event ms over 200
    calls, device ms per launch, plain and cholesky_ex ms, the bound."""
    from gpmpc_tpu_torch.models import gp_core
    from gpmpc_tpu_torch.ops.kernels import kernel_gram
    h, cfg = gp.hyper, gp.cfg
    k = kernel_gram(cfg.kernel, gp.Xn, torch.exp(h.log_ell),
                    torch.exp(h.log_sf2), gp_core._noise_var(h.log_sn2, cfg),
                    jitter=gp_core._jitter_floor(cfg, gp.Xn.dtype))
    p, n = k.shape[0], k.shape[-1]
    err = gc.check_cholesky(k)
    ms = cuda_time_ms(lambda: gc.cholesky(k), reps=200)
    dev_ms, _, note = device_time_ms(lambda: gc.cholesky(k))
    plain = cuda_time_ms(lambda: gc.cholesky_reference(k), reps=50)
    lib = cuda_time_ms(lambda: torch.linalg.cholesky_ex(k), reps=50)
    bd = cholesky_bound(p, n)
    log(f"[time] cholesky[{cfg.kernel}] (P={p}, N={n}) on the fit's Gram: "
        f"kernel {ms:.4f} ms, device {fmt_ms(dev_ms)}{note} per launch, "
        f"plain {plain:.4f} ms, cholesky_ex {lib:.4f} ms, bound "
        f"{bd[0]:.3e} ms ({bd[1]}); {launches['cholesky']} launches in the "
        f"fit; max|err| {err:.3e} on {card}")
    return {"name": f"cholesky[{cfg.kernel}]", "route": "cuda",
            "source": "gpmpc_tpu_torch/csrc/cholesky.cu",
            "replaces": "gpmpc_tpu/ops/pallas_kernels.py:206",
            "launches": launches["cholesky"], "max_abs_err": err, "ms": ms,
            "plain_ms": plain, "device_ms": dev_ms, "bound_ms": bd[0],
            "bound_by": bd[1], "library_ms": lib}


def plain_loop(ck, mpc, n_steps, x_sp, tag):
    """A closed loop through MPC.solve with exact K1 and K2 counts (no
    other kernel) and finite values; returns its states and inputs."""
    from benchmarks.bench_spec import DT, X0
    cfg = mpc.sqp_cfg
    ck.reset_launches()
    t0 = time.perf_counter()
    xs, us = mpc.solve(X0, n_steps * DT, x_sp, noise=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    expect = {"riccati_sweep": n_steps * cfg.al_iters * cfg.max_iters,
              "rk4_substeps": n_steps, "se_ard_gram": 0, "cholesky": 0,
              "gp_predict_batch": 0}
    xs, us = xs.cpu().numpy(), us.cpu().numpy()
    log(f"[slice F] ({tag}) {n_steps}-step closed loop: {wall:.3f} s (cold "
        f"start included); launches {launches}, expected {expect}; final "
        f"state {xs[-1].tolist()}")
    if launches != expect:
        raise AssertionError(f"{tag} launch counts {launches} != {expect}")
    if not (np.all(np.isfinite(xs)) and np.all(np.isfinite(us))):
        raise AssertionError(f"non-finite {tag} closed loop")
    return xs, us


def soft_reference(n_rows):
    """Phase 15 (f)'s reference trajectory: a ramp from X0 to XSP over 8
    steps, held there."""
    from benchmarks.bench_spec import X0, XSP
    s = np.clip(np.arange(n_rows) / 8.0, 0.0, 1.0)[:, None]
    return X0 + s * (XSP - X0)


def slice_f_phase(ck, gc, dev, card, ta_step=None):
    """Phase 15: (a) UT, (b) GH, (c) cubature5, (d) the Matérn fits, (e) a
    Matérn-5/2 TA loop, (f) soft and terminal constraints with a reference
    trajectory.  ``ta_step`` is phase 6's TA control step, timed and
    profiled here as UT's and GH's are; without it (``--slice-f``) a
    3-step TA loop makes one.  Returns phase 11's rows of slice F."""
    from benchmarks.bench_spec import DT, X0, XSP
    t_phase = time.perf_counter()
    rows, steps = [], {}
    for method in ("UT", "GH"):
        row, ms, prof = sigma_point_loop(ck, gc, dev, card, method)
        rows.append(row)
        steps[method] = (ms, prof)
    if ta_step is None:
        mpc = build_slice(dev, RTI)
        rec = StepRecorder(mpc)
        xs, us = plain_loop(ck, mpc, 3, XSP, "TA, for the step's time")
        ta_step = rti_step_fn(mpc, xs[-1], us[-1], rec.last)
    steps["TA"] = ta = step_numbers(ta_step, card, "TA")
    log("[slice F] RTI control step, ms (CUDA events) / device kernels / "
        "busy share: " + "; ".join(
            f"{m} {v[0]:.3f} / {v[1]['kernels_per_step']:.0f} / "
            f"{100 * v[1]['busy_share']:.2f}%" for m, v in steps.items())
        + f"; UT/TA {steps['UT'][0] / ta[0]:.3f}, GH/TA "
        f"{steps['GH'][0] / ta[0]:.3f} on {card}")
    cubature5_check(ck, dev, card)
    gps = {}
    for kernel in ("matern52", "matern32"):
        gps[kernel], launches = matern_fit(ck, dev, card, kernel)
        if kernel == "matern52":
            rows.append(k5_matern_row(gc, gps[kernel], launches, card))
    xs, _ = plain_loop(ck, build_slice(dev, RTI, gp=gps["matern52"]),
                       F_STEPS, XSP, "Matérn-5/2 TA, the card-fitted GP")
    miss = float(np.abs(xs[-1, :2] - XSP[:2]).max())
    log(f"[slice F] (Matérn-5/2 TA) {miss:.4f} from the setpoint of the "
        f"tracked tanks (<= 0.5)")
    if miss > 0.5:
        raise AssertionError("the Matérn-5/2 loop misses the setpoint")
    ref = soft_reference(F_SOFT_STEPS + 20)
    mpc = build_slice(dev, RTI, **F_SOFT)
    if (mpc.problem.n_ineq, mpc.problem.n_term_ineq) != (4, 0):
        raise AssertionError("soft boxes and terminal constraint: rows "
                             f"{mpc.problem.n_ineq}, "
                             f"{mpc.problem.n_term_ineq}")
    rec = StepRecorder(mpc)
    xs, us = plain_loop(ck, mpc, F_SOFT_STEPS, ref,
                        f"soft boxes and terminal constraint {F_SOFT}, "
                        f"a ramp reference ({ref.shape[0]}, 4)")
    t0 = time.perf_counter()
    worst = replay_steps(mpc, rec, xs, range(F_SOFT_STEPS),
                         lambda d: build_slice(d, RTI, **F_SOFT))
    log(f"[slice F] (soft) every step replayed on the CPU from its "
        f"(Nt+1, Nx) window ({time.perf_counter() - t0:.1f} s): max "
        f"relative next-state difference {worst[0]:.3e} in the transient "
        f"(rtol 1e-2), {worst[1]:.3e} after it (rtol 1e-3); tracking error "
        f"at the end {np.abs(xs[-1, :2] - ref[F_SOFT_STEPS, :2]).max():.4f}")
    log(f"[slice F] phase 15: {time.perf_counter() - t_phase:.1f} s")
    return rows


def slice_f_alone():
    """Phases 1-2 and 15, and phase 15's kernel rows, alone."""
    from gpmpc_tpu_torch.ops import cuda_kernels as ck
    from gpmpc_tpu_torch.ops import gp_cuda as gc
    card = card_line()
    dev = torch.device("cuda")
    log(f"[card] nvidia-smi: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    ck.build_library()
    log(f"[build] {time.perf_counter() - t0:.2f} s")
    rows = slice_f_phase(ck, gc, dev, card)
    print(card_line(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    return 0


# ------------------------------------------------------------ phase 16

#: phase 16 (a): tests/golden_configs.py's output-feedback configuration
#: (run_mhe_golden) at its widths on the fixture GP, f32 on the card, with
#: budgets that fit the smoke (the golden runs the converged defaults in
#: f64): the MHE window al2 x mi5, the MPC the main path's RTI budget
#: after a fused al2 x mi10 cold start; the golden's start, prior,
#: setpoint and noise (numpy, seed 23); 8 steps until phase 20 came
OFB_STEPS = 6
OFB_X0 = np.array([8.0, 9.0, 1.0, 1.0])
OFB_XBAR = OFB_X0 + np.array([0.5, -0.5, 0.2, 0.2])
OFB_XSP = np.array([12.4, 12.7, 1.8, 1.4])
OFB_MHE_OPTS = dict(al_iters=2, max_iters=5, fused_kkt=True)
OFB_MPC_INIT = dict(al_iters=2, max_iters=10, fused_kkt=True)
#: phase 16 (b): the linear 3-state MHE of tests/test_mhe.py (its NLP is
#: K1 at (3, 3), built at first use): window 2, LIN_STEPS measurements
LIN_STEPS = 12
LIN_MHE_OPTS = dict(al_iters=1, max_iters=3, fused_kkt=True)
#: phase 16 (c): tests/golden_configs.py's quadrotor (run_quad_golden):
#: control period, steps, the training box, start and setpoint; the
#: in-loop budget is the "rti" preset cut to 6 inner steps (the golden
#: runs the converged defaults in f64; at the preset's 12, 10 steps of
#: both loops took 56 s on an H100 80GB HBM3 at 700 W; 10 steps until
#: phase 18 came)
QUAD_DT = 0.05
QUAD_OPTS = dict(al_iters=2, max_iters=6, penalty_init=100.0,
                 penalty_mult=30.0, merit_viol=10.0, fused_kkt=True)
QUAD_STEPS = 6
QUAD_X_LO = np.array([-2.0, 0.0, -0.4, -1.5, -1.5, -1.0])
QUAD_X_HI = np.array([3.0, 3.0, 0.4, 1.5, 1.5, 1.0])
QUAD_X0 = np.array([0.0, 1.0, 0.0, 0.0, 0.0, 0.0])
QUAD_XSP = np.array([1.5, 2.0, 0.0, 0.0, 0.0, 0.0])


def build_tank_ofb(dev, gp=None):
    """Phase 16 (a)'s plant, estimator and controller on ``dev``: the
    fused four-tank plant (R = 1e-3 I), the fixture GP (or ``gp``), the
    MHE (window 4, the lower two levels measured, GP dynamics, the
    filtered arrival cost, estimates >= 0) and the TA MPC with tightening
    and feedback at Nt = 5, both with fused_kkt."""
    from gpmpc_tpu_torch import MHE, MPC, Model
    from gpmpc_tpu_torch.models.convert import gp_from_fixture
    from gpmpc_tpu_torch.systems import four_tank_ode

    model = Model(Nx=4, Nu=2, ode=four_tank_ode, dt=3.0,
                  R=np.diag([1e-3] * 4), clip_negative=True,
                  integrator_substeps=10, fused_integrator=True, device=dev,
                  dtype=torch.float32)
    if gp is None:
        gp = gp_from_fixture(device=dev, dtype=torch.float32,
                             gp_method="TA", optimizer_opts=GP_OPTS)
    c = torch.tensor([[1.0, 0, 0, 0], [0, 1.0, 0, 0]], device=dev)
    mhe = MHE(model, gp, window=4, Q_noise=model.R,
              R_meas=np.diag([2.5e-3, 2.5e-3]), P_arrival=np.diag([0.5] * 4),
              h=lambda x: c @ x, xlb=[0.0] * 4, discrete_method="gp",
              arrival_update=True, solver_opts=OFB_MHE_OPTS)
    mpc = MPC(horizon=5 * 3.0, model=model, gp=gp, gp_method="TA",
              discrete_method="gp", Q=np.diag([10.0, 10.0, 0.1, 0.1]),
              R=0.01 * np.eye(2), ulb=[0.0, 0.0], uub=[8.0, 8.0],
              xlb=[0.5, 0.5, 0.1, 0.1], xub=[14.0, 25.0, 8.0, 8.0],
              percentile=0.95, feedback=True, cov_updates=2,
              solver_opts=RTI, init_solver_opts=OFB_MPC_INIT, device=dev)
    return mhe, mpc


class CallRecorder:
    """Wraps ``obj.<name>`` while a loop runs: keeps each call's arguments
    and result, and CUDA events around it (``.ms()``: ms per call)."""

    def __init__(self, obj, name):
        self.calls, self.outs, self.events = [], [], []
        inner = getattr(obj, name)

        def call(*args, **kw):
            if kw.get("cfg") is not None:       # a cold start: not a step
                return inner(*args, **kw)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = inner(*args, **kw)
            ev[1].record()
            self.calls.append(args)
            self.outs.append(out)
            self.events.append(ev)
            return out

        setattr(obj, name, call)

    def ms(self):
        return [a.elapsed_time(b) for a, b in self.events]


def ofb_loop(ck, dev, card):
    """Phase 16 (a): simulate_output_feedback of the tank on the card,
    OFB_STEPS steps: exact launch counts (K1 at (4, 4) al x mi a MHE step,
    K1 at (4, 2) cov_updates x al x mi a control step and in the cold
    start, K2 once a step), finite states and estimates, every step's MHE
    window and MPC solve replayed on the CPU in f32 from the card's
    inputs (estimate and next state within rtol 1e-2 over the first
    TRANSIENT_STEPS steps, 1e-3 after), one more MHE step with no host
    sync, the estimate error per step, ms per MHE and per MPC step by
    CUDA events.  Returns K1 (4, 4)'s launches."""
    from gpmpc_tpu_torch import simulate_output_feedback
    mhe, mpc = build_tank_ofb(dev)
    mrec = CallRecorder(mhe, "_step")
    prec = CallRecorder(mpc, "_solve_step")
    rng = np.random.default_rng(23)
    noise_w = 0.01 * rng.standard_normal((OFB_STEPS, 4))
    noise_v = 0.05 * rng.standard_normal((OFB_STEPS, 2))
    ck.reset_launches()
    t0 = time.perf_counter()
    res = simulate_output_feedback(mpc, mhe, OFB_X0, OFB_XBAR,
                                   OFB_STEPS * mpc.dt, OFB_XSP,
                                   noise_w=noise_w, noise_v=noise_v)
    wall = time.perf_counter() - t0
    launches, by_shape = dict(ck.LAUNCHES), dict(ck.RICCATI_LAUNCHES)
    m_cfg, cfg, init = mhe.sqp_cfg, mpc.sqp_cfg, mpc.init_sqp_cfg
    passes = max(mpc.cov_updates, 1)
    expect = {(4, 4): OFB_STEPS * m_cfg.al_iters * m_cfg.max_iters,
              (4, 2): passes * (init.al_iters * init.max_iters
                                + OFB_STEPS * cfg.al_iters * cfg.max_iters)}
    expect_all = {"riccati_sweep": sum(expect.values()),
                  "rk4_substeps": OFB_STEPS, "se_ard_gram": 0, "cholesky": 0,
                  "gp_predict_batch": 0}
    log(f"[slice F2] (a) output-feedback loop, {OFB_STEPS} steps (fixture "
        f"GP, MHE window {mhe.M} al{m_cfg.al_iters} x mi{m_cfg.max_iters}, "
        f"MPC Nt={mpc.Nt} RTI x {passes} covariance passes after an "
        f"al{init.al_iters} x mi{init.max_iters} cold start, fused plant, "
        f"f32): {wall:.3f} s; K1 launches by (nx, nu) {by_shape}, expected "
        f"{expect}; all launches {launches}, expected {expect_all}")
    if by_shape != expect or launches != expect_all:
        raise AssertionError("output-feedback launch counts are off")
    if not all(np.all(np.isfinite(v)) for v in (res.x_true, res.x_hat,
                                                  res.u)):
        raise AssertionError("non-finite output-feedback loop")
    err = np.linalg.norm(res.x_hat - res.x_true[:-1], axis=1)
    m_ms, p_ms = mrec.ms(), prec.ms()
    log(f"[slice F2] (a) |x_hat - x| per step {np.round(err, 5).tolist()}; "
        f"final state {res.x_true[-1].tolist()}, setpoint "
        f"{OFB_XSP.tolist()}; MHE converged {int(res.mhe_converged.sum())}"
        f"/{OFB_STEPS}, MPC {int(res.mpc_converged.sum())}/{OFB_STEPS}; "
        f"ms per MHE step (CUDA events) mean {np.mean(m_ms):.3f}, median "
        f"{np.median(m_ms):.3f}; per MPC step mean {np.mean(p_ms):.3f}, "
        f"median {np.median(p_ms):.3f} on {card}")
    t0 = time.perf_counter()
    cpu_mhe, cpu_mpc = build_tank_ofb(torch.device("cpu"),
                                      gp=to_cpu_gp(mpc.gp))
    cpu_mhe.consts, cpu_mpc.consts = to_cpu(mhe.consts), to_cpu(mpc.consts)
    sigma0 = torch.zeros(4, 4)
    worst = [[0.0, 0.0], [0.0, 0.0]]          # [estimate, next state]
    for k in range(OFB_STEPS):
        state, y, u_prev = mrec.calls[k]
        _, (x_hat_c, _) = cpu_mhe._step(to_cpu(state), y.cpu(),
                                        u_prev.cpu())
        rel_hat = float(((mrec.outs[k][1][0].cpu() - x_hat_c).abs()
                         / x_hat_c.abs()).max())
        warm, x_hat, x_sp, u_prev, _, con_par, _ = prec.calls[k]
        _, u_c, _, _ = cpu_mpc._solve_step(
            to_cpu(warm), x_hat.cpu(), x_sp.cpu(), u_prev.cpu(), sigma0,
            con_par.cpu(), cpu_mpc.consts)
        u_c = cpu_mpc._saturate(u_c, u_prev.cpu(), cpu_mpc.consts)
        x_c = torch.clamp(cpu_mpc.model.integrate(
            torch.tensor(res.x_true[k]), u_c)
            + torch.tensor(noise_w[k], dtype=torch.float32), min=0.0)
        rel = float((torch.tensor(res.x_true[k + 1]) - x_c).abs().div(
            x_c.abs()).max())
        phase = int(k >= TRANSIENT_STEPS)
        worst[phase] = [max(worst[phase][0], rel_hat),
                        max(worst[phase][1], rel)]
    log(f"[slice F2] (a) every step replayed on the CPU in f32 from the "
        f"card's inputs ({time.perf_counter() - t0:.1f} s): max relative "
        f"difference of the estimate / the next state {worst[0][0]:.3e} / "
        f"{worst[0][1]:.3e} in the first {TRANSIENT_STEPS} steps (rtol "
        f"1e-2), {worst[1][0]:.3e} / {worst[1][1]:.3e} after (rtol 1e-3)")
    if max(worst[0]) > 1e-2 or max(worst[1]) > 1e-3:
        raise AssertionError("card and CPU output-feedback steps disagree")
    # one more MHE step, with no host sync
    state, y, u_prev = mrec.calls[-1]
    torch.cuda.synchronize()
    ck.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = mhe._step(state, y, u_prev)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    k1 = dict(ck.RICCATI_LAUNCHES)
    log(f"[slice F2] (a) one MHE step under set_sync_debug_mode('error'): "
        f"no host sync; K1 launches {k1}")
    if k1 != {(4, 4): m_cfg.al_iters * m_cfg.max_iters} or not bool(
            torch.all(torch.isfinite(out[1][0]))):
        raise AssertionError("the MHE step without host sync is off")
    return expect[(4, 4)]


def to_cpu_gp(gp):
    """A CPU GP of ``gp``'s training set, hypers and options (its posterior
    recomputed on the CPU: callers replace the constants they compare
    with the card's)."""
    from gpmpc_tpu_torch.models.convert import gp_from_numpy, \
        hypers_to_numpy
    return gp_from_numpy(gp.X_raw.cpu().numpy(), gp.Y_raw.cpu().numpy(),
                         **hypers_to_numpy(gp.hyper), device="cpu",
                         dtype=gp.dtype, gp_method=gp.gp_method,
                         optimizer_opts=GP_OPTS)


def linear_mhe(dev):
    """Phase 16 (b)'s estimator: tests/test_mhe.py's stable linear 3-state
    system (dt = 0.1, R = 1e-4 I), the first two states measured, window
    2, rk4, fused_kkt: its NLP's KKT solve is K1 at (3, 3)."""
    from gpmpc_tpu_torch import MHE, Model
    a = torch.tensor([[-0.6, 0.3, 0.0], [0.0, -0.4, 0.2], [0.1, 0.0, -0.5]],
                     device=dev)
    b = torch.tensor([[0.5], [0.0], [0.3]], device=dev)
    c = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], device=dev)
    model = Model(Nx=3, Nu=1, ode=lambda x, u: a @ x + b @ u, dt=0.1,
                  R=np.eye(3) * 1e-4, device=dev, dtype=torch.float32)
    return MHE(model, window=2, Q_noise=1e-3 * np.eye(3),
               R_meas=np.diag([4e-2, 1e-2]), P_arrival=0.5 * np.eye(3),
               h=lambda x: c @ x, solver_opts=LIN_MHE_OPTS)


def linear_record(n, seed=16):
    """``n`` measurements of phase 16 (b)'s system from numpy draws (the
    plant stepped by the model's RK4 map in f64 on the CPU, process noise
    1e-3 I, measurement noise diag(4e-2, 1e-2)): x_true (n, 3), us (n-1,
    1), ys (n, 2)."""
    rng = np.random.default_rng(seed)
    mhe = linear_mhe(torch.device("cpu"))
    x = np.array([0.3, -0.2, 0.25])
    xs, us = [x], rng.uniform(-1.0, 1.0, (n - 1, 1))
    for k in range(n - 1):
        x = mhe.model.rk4(torch.tensor(x, dtype=torch.float32),
                          torch.tensor(us[k], dtype=torch.float32))
        x = x.double().numpy() + rng.multivariate_normal(np.zeros(3),
                                                         1e-3 * np.eye(3))
        xs.append(x)
    xs = np.stack(xs)
    ys = xs[:, :2] + rng.multivariate_normal(np.zeros(2),
                                             np.diag([4e-2, 1e-2]), size=n)
    return xs, us, ys


def k1_on_demand(ck, dev, card):
    """Phase 16 (b): K1 at pairs not pre-built and at (4, 4): the linear
    MHE filtering LIN_STEPS measurements on the card through K1 at (3, 3),
    built at its first launch (exact launches; against the same filter on
    the CPU within 1e-3 of 1 + |x|); K1 at (3, 3) and (4, 4) against the
    plain version at B = 1 and under vmap at B = 64; a zero and an
    indefinite H_uu pivot at both (non-finite gains); pairs past the warp
    kernel's lane limits launching once on the block path.  Returns (3,
    3)'s path launches, its build seconds and the max abs errors by
    pair."""
    built_before = (3, 3) in ck.RICCATI_BUILDS
    xs, us, ys = linear_record(LIN_STEPS)
    mhe = linear_mhe(dev)
    ck.reset_launches()
    t0 = time.perf_counter()
    x_hat = mhe.run(np.zeros(3), ys, us)
    wall = time.perf_counter() - t0
    by_shape = dict(ck.RICCATI_LAUNCHES)
    cfg = mhe.sqp_cfg
    expect = {(3, 3): LIN_STEPS * cfg.al_iters * cfg.max_iters}
    build = ck.RICCATI_BUILDS[(3, 3)]
    ref = linear_mhe(torch.device("cpu")).run(np.zeros(3), ys, us)
    gap = float(((x_hat.cpu() - ref).abs() / (1.0 + ref.abs())).max())
    log(f"[slice F2] (b) linear MHE, {LIN_STEPS} measurements, window "
        f"{mhe.M}, al{cfg.al_iters} x mi{cfg.max_iters}, f32: {wall:.3f} s "
        f"(K1 at (3, 3) built at its first launch "
        f"{'before this phase' if built_before else 'here'} in "
        f"{build['seconds']:.2f} s -> {build['path']}); K1 launches "
        f"{by_shape}, expected {expect}; against the CPU max |diff| / "
        f"(1 + |x|) {gap:.3e} (<= 1e-3); RMS error against the truth "
        f"{float(np.sqrt(np.mean((x_hat.cpu().numpy() - xs) ** 2))):.4f}")
    for line in build["log"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build (3, 3)] {line.strip()}")
    if by_shape != expect or gap > 1e-3:
        raise AssertionError("the linear MHE through K1 at (3, 3) is off")
    errs = {}
    for nx, nu, nt in [(3, 3, 3), (4, 4, 5)]:
        for batch in (None, 64):
            args = ck.stage_qp_inputs(nt, nx, nu, nt + batch if batch else
                                      nt, batch, device=dev)
            reg = torch.full(() if batch is None else (batch,), 1e-6,
                             device=dev)
            before = ck.RICCATI_LAUNCHES.get((nx, nu), 0)
            err = ck.check_riccati_sweep(args, reg, vmapped=batch is not None)
            torch.cuda.synchronize()
            if ck.RICCATI_LAUNCHES[(nx, nu)] != before + 1:
                raise AssertionError("K1's check did not launch once")
            log(f"[slice F2] (b) K1 ({nx}, {nu}) "
                f"{'B=1' if batch is None else f'vmapped B={batch}'}, "
                f"Nt={nt}: max|err| {err:.3e} against the plain version "
                f"(one launch), layout {ck.riccati_layout(nx, nu)} (chunk, "
                f"bytes a warp, warps a block)")
            errs.setdefault((nx, nu), err)
        for kind in ("zero", "indefinite"):
            ck.check_riccati_sweep_bad_pivot(kind, device=dev,
                                             shape=(8, nx, nu))
            torch.cuda.synchronize()
        log(f"[slice F2] (b) K1 ({nx}, {nu}): a zero and an indefinite H_uu "
            f"pivot -> non-finite gains: ok")
    for nx, nu in [(31, 2), (4, 33)]:
        before = ck.LAUNCHES["riccati_sweep"]
        err = ck.check_riccati_sweep(
            ck.stage_qp_inputs(4, nx, nu, 0, device=dev),
            torch.tensor(1e-6, device=dev))
        torch.cuda.synchronize()
        log(f"[slice F2] (b) K1 ({nx}, {nu}), past the warp kernel's lane "
            f"limits: path {ck.riccati_path(nx, nu)}, one launch, max|err| "
            f"{err:.3e} against the plain version")
        if (ck.LAUNCHES["riccati_sweep"] != before + 1
                or ck.riccati_path(nx, nu) != "block"
                or (nx, nu) in ck.RICCATI_BUILDS):
            raise AssertionError(f"K1 ({nx}, {nu}) did not launch once on "
                                 f"the block path")
    return expect[(3, 3)], build["seconds"], errs


def quad_models(dev, fused=False):
    """The quadrotor golden's nominal model (QUAD_PARAMS) and true plant
    (m = 1.3), f32; the plant through K2 with ``fused`` (its ODE traced
    into a functor of its own on the card: phase 21 (b)), else unfused
    (phase 16 (c))."""
    from gpmpc_tpu_torch import Model
    from gpmpc_tpu_torch.systems import QUAD_PARAMS, planar_quadrotor_ode
    heavy = dict(QUAD_PARAMS, m=1.3)
    kw = dict(Nx=6, Nu=2, dt=QUAD_DT, R=np.diag([1e-8] * 6),
              integrator_substeps=4, device=dev, dtype=torch.float32)
    return (Model(ode=planar_quadrotor_ode, **kw),
            Model(ode=lambda x, u: planar_quadrotor_ode(x, u, heavy),
                  fused_integrator=fused, **kw))


def build_quad(dev, gp, method):
    """The quadrotor golden's controller on ``dev``: Nt = 8, TA, no
    tightening or feedback, ``method`` 'hybrid' (the nominal model plus
    ``gp``'s residual) or 'rk4' (the nominal model alone), QUAD_OPTS
    after a "robust" cold start (K1 at (6, 2))."""
    from gpmpc_tpu_torch import MPC
    nominal, _ = quad_models(dev)
    return MPC(horizon=8 * QUAD_DT, model=nominal,
               gp=gp if method == "hybrid" else None, gp_method="TA",
               discrete_method=method,
               Q=np.diag([10.0, 30.0, 2.0, 1.0, 1.0, 0.2]),
               R=0.02 * np.eye(2), ulb=[0.0, 0.0], uub=[10.0, 10.0],
               xlb=[-5.0, 0.2, -1.0, -5.0, -5.0, -6.0],
               xub=[5.0, 5.0, 1.0, 5.0, 5.0, 6.0], feedback=False,
               percentile=None, cov_updates=1, solver_opts=QUAD_OPTS,
               init_solver_opts="robust", device=dev)


def quad_data(dev, n, seed, fused=False):
    """``n`` points uniform in the quadrotor golden's box (thrusts in
    [2, 9]) from a generator on ``dev`` seeded ``seed``, and their
    residual targets plant step - nominal RK4 step; with ``fused`` the
    plant steps go through ``vmap(plant.integrate)``, as
    examples/quadrotor.py draws them (one K2 launch by its vmap rule)."""
    nominal, plant = quad_models(dev, fused)
    g = torch.Generator(device=dev).manual_seed(seed)
    kw = dict(dtype=torch.float32, device=dev)
    lo, hi = (torch.tensor(v, **kw) for v in (QUAD_X_LO, QUAD_X_HI))
    x = lo + (hi - lo) * torch.rand((n, 6), generator=g, **kw)
    u = 2.0 + 7.0 * torch.rand((n, 2), generator=g, **kw)
    step = torch.func.vmap(plant.integrate) if fused else plant.integrate
    return torch.cat([x, u], dim=1), step(x, u) - nominal.rk4(x, u)


def quad_loop(ck, mpc, dev, tag, fused=False):
    """QUAD_STEPS solve_steps of ``mpc`` on the true plant from hover at
    QUAD_X0: exact K1 (6, 2) launches (the cold start's al x mi, then the
    RTI budget's a step) and K2 (one traced launch a step with ``fused``,
    else none), finite; returns the states, the inputs and each step's
    (state, warm start, last input)."""
    _, plant = quad_models(dev, fused)
    init, cfg = mpc.init_sqp_cfg, mpc.sqp_cfg
    ck.reset_launches()
    x = torch.as_tensor(QUAD_X0, dtype=torch.float32, device=dev)
    warm, u_prev, rec = None, None, []
    xs, us = [x], []
    t0 = time.perf_counter()
    for _ in range(QUAD_STEPS):
        rec.append((x, warm, u_prev))
        u_prev, warm, _, _ = mpc.solve_step(x, QUAD_XSP, warm=warm,
                                            u_prev=u_prev)
        x = plant.integrate(x, u_prev)
        xs.append(x)
        us.append(u_prev)
    xs = torch.stack(xs).cpu().numpy()
    wall = time.perf_counter() - t0
    by_shape = dict(ck.RICCATI_LAUNCHES)
    expect = {(6, 2): init.al_iters * init.max_iters
              + (QUAD_STEPS - 1) * cfg.al_iters * cfg.max_iters}
    head = "[traced K2] (b)" if fused else "[slice F2] (c)"
    log(f"{head} quadrotor, {tag}: {QUAD_STEPS} solve_steps "
        f"({wall:.3f} s, cold start al{init.al_iters} x mi{init.max_iters}, "
        f"then al{cfg.al_iters} x mi{cfg.max_iters}); K1 launches "
        f"{by_shape}, expected {expect}; final state {xs[-1].tolist()}")
    k2 = {k2_id(plant): QUAD_STEPS} if fused else {}
    log(f"{head} quadrotor, {tag}: K2 launches by functor "
        f"{dict(ck.K2_LAUNCHES)}, expected {k2}")
    if by_shape != expect or ck.K2_LAUNCHES != k2:
        raise AssertionError(f"quadrotor ({tag}) launch counts are off")
    if not np.all(np.isfinite(xs)):
        raise AssertionError(f"non-finite quadrotor loop ({tag})")
    return xs, torch.stack(us).cpu().numpy(), rec, expect[(6, 2)]


def quad_phase(ck, dev, card, fused=False, gp=None):
    """Phase 16 (c): the quadrotor's hybrid mismatch on the card: the
    residual GP fitted on 40 points drawn in the golden's box (exact K4
    and K5 launches), validated on 200 fresh points (one K3 launch, SMSE
    per dim), QUAD_STEPS hybrid solve_steps on the 1.3 kg plant with every
    step replayed on the CPU in f32 (next state within 1e-2 of 1 + |x| in
    the first TRANSIENT_STEPS steps, 1e-3 after), and the same loop with
    the nominal model alone ('rk4'); the final position error of both.
    ``gp``, a GP already fitted with this recipe on the same 40 draws
    (phase 21 (b)'s, whose plant steps are the fused plant's), stands in
    for the fit.  With ``fused`` (phase 21 (b)) the plant is fused, its
    ODE traced into K2: the data's plant steps are one batched K2 launch
    and the hybrid loop launches K2 once a step; no validation or nominal
    loop.  Returns K1 (6, 2)'s launches in the hybrid loop, the K2
    launches (data, loop) and the GP."""
    from gpmpc_tpu_torch import GP
    tag = "[traced K2] (b)" if fused else "[slice F2] (c)"
    data_k2 = {}
    if gp is None:
        ck.reset_launches()
        x, y = quad_data(dev, 40, 0, fused)
        data_k2 = dict(ck.K2_LAUNCHES)
        if fused:
            expect_data = {k2_id(quad_models(dev, True)[1]): 1}
            log(f"{tag} residual data on 40 points through "
                f"vmap(plant.integrate): K2 launches by functor {data_k2}, "
                f"expected {expect_data}")
            if data_k2 != expect_data:
                raise AssertionError("the quadrotor data's K2 launches are "
                                     "off")
        ck.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gp = GP(x, y, mean_func="zero", gp_method="TA", multistart=2,
                max_iters=150, seed=1, optimizer_opts=GP_OPTS, device=dev,
                dtype=torch.float32)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ck.LAUNCHES)
        expect = {"riccati_sweep": 0, "rk4_substeps": 0,
                  "se_ard_gram": gp.n_evals + 1, "cholesky": gp.n_evals + 3,
                  "gp_predict_batch": 0}
        log(f"{tag} residual GP (40 points, D=8, Ny=6) fitted on the "
            f"card: {wall:.3f} s, {gp.n_evals} batched evaluations; "
            f"launches {launches}, expected {expect}")
        if launches != expect:
            raise AssertionError("quadrotor GP fit launch counts are off")
    else:
        log(f"{tag} residual GP: phase 21 (b)'s fit with this recipe on "
            f"the same 40 draws ({gp.n_evals} batched evaluations, its "
            f"launches checked there; its posterior recomputed here from "
            f"its training set and hypers)")
    if not fused:
        xt, yt = quad_data(dev, 200, 1)
        ck.reset_launches()
        smse, _, _ = gp.validate(xt, yt, verbose=False)
        log(f"{tag} residual GP SMSE per output dim on 200 fresh "
            f"points {np.round(smse, 5).tolist()}; K3 launches "
            f"{ck.LAUNCHES['gp_predict_batch']} (expected 1)")
        if ck.LAUNCHES["gp_predict_batch"] != 1 or not np.all(
                np.isfinite(smse)):
            raise AssertionError("quadrotor GP validation is off")
    mpc = build_quad(dev, gp, "hybrid")
    xs, us, rec, k1 = quad_loop(ck, mpc, dev, "hybrid, the fitted residual"
                                + (", the plant fused" if fused else ""),
                                fused)
    xs_n = None if fused else quad_loop(
        ck, build_quad(dev, None, "rk4"), dev,
        "rk4, the nominal model alone")[0]
    t0 = time.perf_counter()
    cpu = build_quad(torch.device("cpu"), to_cpu_gp(gp), "hybrid")
    cpu.consts = to_cpu(mpc.consts)
    _, plant = quad_models(torch.device("cpu"))
    worst = [0.0, 0.0]
    for k, (x_k, warm, u_prev) in enumerate(rec):
        u_c, _, _, _ = cpu.solve_step(x_k.cpu(), QUAD_XSP,
                                      warm=to_cpu(warm),
                                      u_prev=to_cpu(u_prev))
        x_c = plant.integrate(x_k.cpu(), u_c).numpy()
        rel = float(np.max(np.abs(xs[k + 1] - x_c) / (1.0 + np.abs(x_c))))
        phase = int(k >= TRANSIENT_STEPS)
        worst[phase] = max(worst[phase], rel)
    log(f"{tag} hybrid steps replayed on the CPU in f32 "
        f"({time.perf_counter() - t0:.1f} s): max |diff| / (1 + |x|) of the "
        f"next state {worst[0]:.3e} in the first {TRANSIENT_STEPS} steps "
        f"(<= 1e-2), {worst[1]:.3e} after (<= 1e-3)")
    if fused:
        miss = float(np.linalg.norm(xs[-1, :2] - QUAD_XSP[:2]))
        log(f"{tag} position error |(px, pz) - x_sp| after {QUAD_STEPS} "
            f"steps: {miss:.5f} (from {QUAD_X0[:2].tolist()}, towards "
            f"{QUAD_XSP[:2].tolist()}) on {card}")
    else:
        miss = [float(np.linalg.norm(v[-1, :2] - QUAD_XSP[:2]))
                for v in (xs, xs_n)]
        # how well each model predicts the heavy plant's realized
        # transitions
        kw = dict(dtype=torch.float32, device=dev)
        pred = [max(float((f(torch.tensor(xs[k], **kw),
                             torch.tensor(us[k], **kw))
                           - torch.tensor(xs[k + 1], **kw)).abs().max())
                    for k in range(QUAD_STEPS))
                for f in (lambda a, b: mpc._mean_dynamics(a, b, mpc.consts),
                          mpc.model.rk4)]
        log(f"{tag} position error |(px, pz) - x_sp| after "
            f"{QUAD_STEPS} steps: hybrid {miss[0]:.5f}, nominal rk4 "
            f"{miss[1]:.5f}; px hybrid {xs[-1, 0]:.5f}, rk4 "
            f"{xs_n[-1, 0]:.5f}; pz hybrid {xs[-1, 1]:.5f}, rk4 "
            f"{xs_n[-1, 1]:.5f} (from {QUAD_X0[:2].tolist()}, towards "
            f"{QUAD_XSP[:2].tolist()}); one-step prediction of the 1.3 kg "
            f"plant's realized transitions, max |error|: hybrid model "
            f"{pred[0]:.3e}, nominal model {pred[1]:.3e} on {card}")
    if worst[0] > 1e-2 or worst[1] > 1e-3:
        raise AssertionError("card and CPU quadrotor steps disagree")
    return k1, (sum(data_k2.values()), QUAD_STEPS if fused else 0), gp


def k1_row(ck, name, nt, nx, nu, launches, err, card, **extra):
    """K1's JSON row at (Nt, nx, nu), one problem: event ms over 200
    calls, device ms per launch over 200, the plain version's ms and the
    bound."""
    q = ck.stage_qp_inputs(nt, nx, nu, nt + nx, device=torch.device("cuda"))
    reg = torch.tensor(1e-6, device=q[0].device)
    out = ck.riccati_sweep(*q, reg)
    ms = cuda_time_ms(lambda: ck.riccati_sweep(*q, reg), reps=200)
    dev_ms, _, note = device_time_ms(lambda: ck.riccati_sweep(*q, reg))
    plain = cuda_time_ms(lambda: ck.riccati_sweep_reference(*q, reg),
                         reps=20)
    bd = bound(nbytes(*q, reg, *out), riccati_flops(nt, nx, nu))
    log(f"[time] riccati_sweep ({nx}, {nu}) at Nt={nt}, B=1: kernel "
        f"{ms:.4f} ms, device {fmt_ms(dev_ms)}{note} per launch, plain "
        f"{plain:.4f} ms, bound {bd[0]:.3e} ms ({bd[1]}); {launches} "
        f"launches on its path; max|err| {err:.3e} on {card}")
    return {"name": name, "route": "cuda",
            "source": "gpmpc_tpu_torch/csrc/riccati_sweep.cu",
            "replaces": "gpmpc_tpu/ops/pallas_kernels.py:394",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain, "device_ms": dev_ms, "bound_ms": bd[0],
            "bound_by": bd[1], "library_ms": None, **extra}


def slice_f2_phase(ck, dev, card, quad_gp=None):
    """Phase 16: (a) the tank's output-feedback loop (MHE + MPC, K1 at (4,
    4) and (4, 2), K2), (b) K1 built on demand, (c) the quadrotor's hybrid
    mismatch (with ``quad_gp``, phase 21 (b)'s fit, in place of its own).
    Returns its JSON rows."""
    t_phase = time.perf_counter()
    n44 = ofb_loop(ck, dev, card)
    n33, build_s, errs = k1_on_demand(ck, dev, card)
    n62, _, _ = quad_phase(ck, dev, card, gp=quad_gp)
    err62 = ck.check_riccati_sweep(ck.stage_qp_inputs(8, 6, 2, 14,
                                                      device=dev),
                                   torch.tensor(1e-6, device=dev))
    rows = [k1_row(ck, "riccati_sweep[4,4,mhe]", 5, 4, 4, n44,
                   errs[(4, 4)], card),
            k1_row(ck, "riccati_sweep[3,3,on_demand]", 3, 3, 3, n33,
                   errs[(3, 3)], card, build_s=build_s),
            k1_row(ck, "riccati_sweep[6,2,quadrotor]", 8, 6, 2, n62, err62,
                   card)]
    log(f"[slice F2] phase 16: {time.perf_counter() - t_phase:.1f} s")
    return rows


def slice_f2_alone():
    """Phases 1-2 and 16, and phase 16's kernel rows, alone."""
    from gpmpc_tpu_torch.ops import cuda_kernels as ck
    card = card_line()
    dev = torch.device("cuda")
    log(f"[card] nvidia-smi: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    ck.build_library()
    log(f"[build] {time.perf_counter() - t0:.2f} s")
    rows = slice_f2_phase(ck, dev, card)
    print(card_line(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    return 0


# ------------------------------------------------------------ phase 17

#: phase 17 (slice F, part 3) (a): MPC.solve_mc on the main path, its
#: lanes and steps, the short run its per-step time is a slope against,
#: the lanes replayed on the CPU, and the fused cold-start budget of the
#: phase's controllers (phase 16's; the default al6 x mi30 runs masked on
#: the card, ~180 inner steps); 10 steps until phase 20 came
MC_LANES = 64
MC_STEPS = 6
MC_SHORT = 2
MC_REPLAY = (0, MC_LANES - 1)
MC_INIT = dict(al_iters=2, max_iters=10, fused_kkt=True)
#: (b): UT under solve_mc, and the per-lane online posteriors (UT with
#: online_capacity: K3 with a problem dim over the lanes)
MC_UT_LANES, MC_UT_STEPS = 16, 4
MC_ONLINE_STEPS, MC_ONLINE_CAPACITY = 2, 128
#: (c): the adaptive plant's 20-step sim against the host integrator
#: (f64, tolerances of tests/test_torch_adaptive.py), and its f32
#: tolerances in the 10-step closed loop (rtol 1e-6 is ~8 ulps of a level
#: in f32: the error estimate would be rounding)
ADAPTIVE_SIM_STEPS = 20
ADAPTIVE_LOOP_STEPS = 10
ADAPTIVE_F32 = dict(rtol=1e-4, atol=1e-6)
#: (d): the sparse GP's inducing points and its closed loop's steps; the
#: bound of the card fit's VFE per dim (re-evaluated in f64) against the
#: same f32 fit on the CPU.  An f32 fit does not reach the f64 fit's
#: optimum: K_MM's jitter floor is ~800 ulps of sf2 (1e-4 in f32, the JAX
#: package's rule), which moves the f32 optimum, in the JAX package's own
#: f32 fit too; the phase prints the gap to the f64 fit
SPARSE_M = 32
SPARSE_RECIPE = dict(multistart=1, max_iters=100)
SPARSE_LOOP_STEPS = 10
SPARSE_BOUND_TOL = 0.5


def sparse_bound_f64(gp, f):
    """The VFE bound per dim of ``gp``'s hypers and inducing set (by index)
    on the fixture's training set, in f64 on the CPU."""
    from gpmpc_tpu_torch.models import sparse
    from gpmpc_tpu_torch.utils.config import GPConfig
    f64 = dict(dtype=torch.float64)
    x, y = (torch.tensor(f[k], **f64) for k in ("tank_X", "tank_Y"))
    xn = (x - x.mean(0)) / x.std(0, correction=0)
    yn = (y - y.mean(0)) / y.std(0, correction=0)
    h = [torch.as_tensor(v.detach().cpu(), **f64) for v in gp.hyper]
    z = xn[gp.z_idx.cpu().long()]
    return sparse.vfe_nll_batch(*h, z, xn, yn.mT, GPConfig(**GP_OPTS),
                                "zero").detach().numpy()


def mc_noise(mpc, n_mc, n_steps, seed):
    """Process noise for ``n_mc`` lanes as ``solve_mc`` draws it: normals
    from a generator on the controller's device seeded with ``seed``,
    times chol(R)'."""
    g = torch.Generator(device=mpc.device).manual_seed(seed)
    eps = torch.randn((n_mc, n_steps, mpc.Nx), generator=g,
                      dtype=mpc.dtype, device=mpc.device)
    return eps @ mpc._noise_chol().T


def expect_launches(k1=0, k2=0, k4=0, k5=0, k3=0):
    return {"riccati_sweep": k1, "rk4_substeps": k2, "se_ard_gram": k4,
            "cholesky": k5, "gp_predict_batch": k3}


def check_launches(ck, expect, what):
    launches = dict(ck.LAUNCHES)
    if launches != expect:
        raise AssertionError(f"{what}: launch counts {launches} != {expect}")
    return launches


def mc_replay(mpc, xs, us, w, lanes):
    """Per-step replay of ensemble lanes on the CPU: from the lane's state
    on the card at each step (and the card's last input), the CPU solves
    the step with its own warm-start chain (a cold start first, as the
    ensemble's) and the card's constants, steps its plant and adds the
    lane's noise row; the next states within rtol 1e-2 in the transient
    (the first TRANSIENT_STEPS) and 1e-3 after, as the main path's replay
    bounds them.  Returns the worst (transient, tracking) differences."""
    from benchmarks.bench_spec import XSP
    cpu = build_slice(torch.device("cpu"), RTI, init_solver_opts=MC_INIT)
    cpu.consts = to_cpu(mpc.consts)
    xs, us, w = (torch.as_tensor(np.asarray(v)).cpu() for v in (xs, us, w))
    worst = [0.0, 0.0]
    for lane in lanes:
        _, warm, _, _ = cpu.solve_step(xs[lane, 0], XSP)
        u_prev = torch.zeros(cpu.Nu)
        for k in range(us.shape[1]):
            u_c, warm, _, _ = cpu.solve_step(xs[lane, k], XSP, warm=warm,
                                             u_prev=u_prev)
            x_c = (cpu.model.integrate(xs[lane, k], u_c)
                   + w[lane, k]).clamp(min=0.0)
            rel = float(((xs[lane, k + 1] - x_c).abs() / x_c.abs()).max())
            phase = int(k >= TRANSIENT_STEPS)
            worst[phase] = max(worst[phase], rel)
            u_prev = us[lane, k]
    if worst[0] > 1e-2 or worst[1] > 1e-3:
        raise AssertionError(f"ensemble lanes, card and CPU disagree: "
                             f"{worst}")
    return worst


def mc_ensemble(ck, dev, card, ta_step_ms):
    """Phase 17 (a): MPC.solve_mc on the main path (the fixture GP, TA,
    0.95, feedback, Nt=20, RTI, the fused plant, f32), MC_LANES lanes over
    MC_STEPS steps from X0 through chance_calibration: K1 once per inner
    SQP step and K2 once per control step, each for every lane; finite;
    lanes MC_REPLAY replayed on the CPU; the calibration's rates; ms per
    ensemble step (CUDA events, the slope against an MC_SHORT-step run)
    beside MC_LANES x the single loop's step.  Returns the launches and
    the ensemble's last states and inputs (for K2's row)."""
    from benchmarks.bench_spec import DT, X0, XSP
    from gpmpc_tpu_torch.utils import chance_calibration

    mpc = build_slice(dev, RTI, init_solver_opts=MC_INIT)
    per_solve = RTI["al_iters"] * RTI["max_iters"]
    cold = MC_INIT["al_iters"] * MC_INIT["max_iters"]

    def timed(n_steps, seed, audit=False):
        w = mc_noise(mpc, MC_LANES, n_steps, seed)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        ck.reset_launches()
        start.record()
        if audit:
            report = chance_calibration(mpc, X0, n_steps * DT, XSP,
                                        n_mc=MC_LANES, noise_ws=w)
        else:
            report = None
            mpc.solve_mc(X0, n_steps * DT, XSP, MC_LANES, noise_ws=w)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end), w, report

    short_ms, _, _ = timed(MC_SHORT, 1)
    full_ms, w, report = timed(MC_STEPS, 0, audit=True)
    launches = check_launches(
        ck, expect_launches(k1=cold + MC_STEPS * per_solve, k2=MC_STEPS),
        "solve_mc")
    rec = mpc.last_mc
    xs, us = rec["x_sim"], rec["u_sim"]
    if xs.shape != (MC_LANES, MC_STEPS + 1, 4) or \
            us.shape != (MC_LANES, MC_STEPS, 2):
        raise AssertionError(f"solve_mc shapes {xs.shape}, {us.shape}")
    if not (np.all(np.isfinite(xs)) and np.all(np.isfinite(us))):
        raise AssertionError("non-finite ensemble")
    spread = float(xs[:, -1, 0].std())
    miss = float(np.median(np.abs(xs[:, -1, :2] - XSP[:2])))
    ms_step = (full_ms - short_ms) / (MC_STEPS - MC_SHORT)
    log(f"[mc] solve_mc, {MC_LANES} lanes x {MC_STEPS} steps (TA, RTI, "
        f"fused plant, f32): {full_ms:.1f} ms by CUDA events ({MC_SHORT} "
        f"steps: {short_ms:.1f} ms); {ms_step:.3f} ms per ensemble step, "
        f"{MC_LANES / ms_step * 1e3:.1f} lane-steps/s, against "
        f"{MC_LANES} x the single loop's {ta_step_ms:.3f} ms = "
        f"{MC_LANES * ta_step_ms:.1f} ms; launches {launches}; final h1 "
        f"spread {spread:.4f}, median miss of the tracked tanks {miss:.4f};"
        f" converged {int(rec['converged'].sum())}/{rec['converged'].size} "
        f"on {card}")
    if spread <= 1e-4 or miss > 0.5:
        raise AssertionError("the ensemble's lanes do not spread or miss "
                             "the setpoint")
    log(f"[mc] chance_calibration: alpha {report['alpha']:.3f}, bound "
        f"{report['bound']:.4f}, pooled rates {report['rate'].tolist()}, "
        f"worst-step rates {report['worst_step_rate'].tolist()}, active "
        f"{report['active'].tolist()}, calibrated {report['calibrated']}")
    t0 = time.perf_counter()
    worst = mc_replay(mpc, xs, us, w.cpu(), MC_REPLAY)
    log(f"[mc] lanes {list(MC_REPLAY)} replayed per step on the CPU "
        f"({time.perf_counter() - t0:.1f} s): max relative next-state "
        f"difference {worst[0]:.3e} in the transient (1e-2), {worst[1]:.3e}"
        f" after it (1e-3)")
    x_last = torch.as_tensor(xs[:, -2], device=dev).contiguous()
    u_last = torch.as_tensor(us[:, -1], device=dev).contiguous()
    return launches, x_last, u_last, ms_step


def k3_vmap_check(gc, dev, lanes, n, seed, per_lane):
    """K3 under torch.func.vmap on the card, one launch per call, against
    its plain version lane by lane (k* 2e-5, mu 2e-4): the lanes' 13
    sigma points each against one posterior of ``n`` points, or with
    ``per_lane`` against a posterior of each lane's own.  Returns the
    call, its inputs and the largest k* difference."""
    from torch.func import vmap
    z, x, ell, sf2, alpha = gc.predict_inputs(n, 6, 13 * lanes, 4, seed,
                                              device=dev)
    z = z.reshape(lanes, 13, 6)
    if per_lane:
        g = torch.Generator(device=dev).manual_seed(seed)
        x = x + 0.1 * torch.randn((lanes, n, 6), generator=g, device=dev)
        ell = ell * torch.exp(0.1 * torch.randn((lanes, 4, 6), generator=g,
                                                device=dev))
        sf2 = sf2 * torch.ones((lanes, 4), device=dev)
        alpha = alpha + 0.1 * torch.randn((lanes, 4, n), generator=g,
                                          device=dev)
        args = (z, x.contiguous(), ell.contiguous(), sf2, alpha.contiguous())
        call = (lambda: vmap(gc.gp_predict_batch)(*args))
    else:
        args = (z, x, ell, sf2, alpha)
        call = (lambda: vmap(lambda zz: gc.gp_predict_batch(
            zz, x, ell, sf2, alpha))(z))
    mu, ks = call()
    err_k = err_m = 0.0
    for i in range(lanes):
        one = [a[i] if per_lane or j == 0 else a
               for j, a in enumerate(args)]
        mu_r, ks_r = gc.gp_predict_batch_reference(*one)
        if not (bool(torch.all((ks[i] - ks_r).abs()
                               <= gc.KS_TOL + gc.KS_TOL * ks_r.abs()))
                and bool(torch.all((mu[i] - mu_r).abs()
                                   <= gc.MU_TOL + gc.MU_TOL * mu_r.abs()))):
            raise AssertionError(f"K3 under vmap disagrees with its plain "
                                 f"version at lane {i} (per_lane="
                                 f"{per_lane})")
        err_k = max(err_k, float((ks[i] - ks_r).abs().max()))
        err_m = max(err_m, float((mu[i] - mu_r).abs().max()))
    return call, args, err_k


def mc_ut(ck, gc, dev, card):
    """Phase 17 (b): UT under solve_mc (MC_UT_LANES lanes, MC_UT_STEPS
    steps): K3 exactly Nt launches a solve, one per vmapped call for all
    lanes; then UT with per-lane online posteriors (MC_ONLINE_STEPS steps,
    capacity MC_ONLINE_CAPACITY): Nt a solve, the lanes on K3's problem
    dim from the second step on.  K3 vmapped both ways against its plain
    version.  Returns the launches of both and the checked calls."""
    from benchmarks.bench_spec import DT, X0, XSP
    per_solve = RTI["al_iters"] * RTI["max_iters"]
    cold = MC_INIT["al_iters"] * MC_INIT["max_iters"]
    out = {}
    for tag, lanes, steps, kw in (
            ("ut", MC_UT_LANES, MC_UT_STEPS, {}),
            ("online", MC_UT_LANES, MC_ONLINE_STEPS,
             dict(online_capacity=MC_ONLINE_CAPACITY))):
        mpc = build_slice(dev, RTI, gp_method="UT", init_solver_opts=MC_INIT,
                          **kw)
        w = mc_noise(mpc, lanes, steps, 2)
        torch.cuda.synchronize()
        ck.reset_launches()
        t0 = time.perf_counter()
        xs, us = mpc.solve_mc(X0, steps * DT, XSP, lanes, noise_ws=w)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = check_launches(
            ck, expect_launches(k1=cold + steps * per_solve, k2=steps,
                                k3=mpc.Nt * (1 + steps)), f"UT solve_mc {tag}")
        if not (bool(torch.all(torch.isfinite(xs)))
                and bool(torch.all(torch.isfinite(us)))):
            raise AssertionError(f"non-finite UT ensemble ({tag})")
        log(f"[mc] UT solve_mc {tag}: {lanes} lanes x {steps} steps in "
            f"{wall:.1f} s (cold start included); launches {launches} (K3 "
            f"{mpc.Nt} a solve, each for all {lanes} lanes); final h1 "
            f"{xs[:, -1, 0].double().cpu().numpy().round(3).tolist()}")
        out[tag] = launches
    checks = {}
    for tag, n, per_lane in (("ut", 100, False),
                             ("online", MC_ONLINE_CAPACITY, True)):
        before = ck.LAUNCHES["gp_predict_batch"]
        call, args, err = k3_vmap_check(gc, dev, MC_UT_LANES, n, 31,
                                        per_lane)
        torch.cuda.synchronize()
        if ck.LAUNCHES["gp_predict_batch"] != before + 1:
            raise AssertionError("a vmapped K3 call made more than one "
                                 "launch")
        log(f"[mc] K3 under vmap ({tag}: {MC_UT_LANES} lanes x 13 points, "
            f"N={n}{', a posterior per lane' if per_lane else ''}): one "
            f"launch, max|err| k* {err:.3e} against the plain version")
        checks[tag] = (call, args, err)
    return out, checks


def adaptive_phase(ck, dev, card):
    """Phase 17 (c): the adaptive plant.  A 20-step sim of the four-tank
    ODE with Model(integrator='adaptive') in f64 on the card against the
    port's host integrator (native.sim, the same DOPRI5 pair in C++)
    within 1e-8; the poisoning case (a stiff decay at max_adaptive_steps
    = 50) NaN; a 10-step MPC.solve of the main path with the adaptive
    plant in f32 (K1 as ever, no K2) and its host reads per plant step;
    the DAE network of examples/dae_network.py (Nx=2, Nu=1) on the card
    against the port on the CPU (f64): its Newton elimination, adaptive
    map and the RK4 map's linearization within 1e-10.  Returns the
    loop's launches."""
    from benchmarks.bench_spec import DT, MODEL_R, X0, XSP
    from gpmpc_tpu_torch import Model, native
    from gpmpc_tpu_torch.systems import four_tank_ode

    f64 = torch.float64
    tank = dict(Nx=4, Nu=2, ode=four_tank_ode, dt=DT, R=MODEL_R,
                clip_negative=True, integrator="adaptive")
    m = Model(rtol=1e-10, atol=1e-12, device=dev, dtype=f64, **tank)
    useq = np.random.default_rng(17).uniform(0.0, 6.0,
                                             (ADAPTIVE_SIM_STEPS, 2))
    t0 = time.perf_counter()
    xs = m.sim(X0, useq).cpu().numpy()
    wall = time.perf_counter() - t0
    host = native.sim(X0, useq, DT, system="four_tank",
                      params=native.tank_params(), rtol=1e-10, atol=1e-12,
                      clip_negative=True)
    err = float(np.abs(xs - host).max())
    log(f"[adaptive] {ADAPTIVE_SIM_STEPS}-step sim, f64 on the card "
        f"(rtol 1e-10): {wall:.2f} s, {m.adaptive_host_reads} host reads "
        f"({m.adaptive_host_reads / ADAPTIVE_SIM_STEPS:.1f} a plant step); "
        f"max |x - host integrator| {err:.3e} (<= 1e-8)")
    if not err <= 1e-8:
        raise AssertionError("the adaptive plant on the card is off the "
                             "host integrator")
    stiff = Model(Nx=1, Nu=1, ode=lambda x, u: -1e9 * x, dt=1.0,
                  integrator="adaptive", rtol=1e-10, atol=1e-12,
                  max_adaptive_steps=50, device=dev, dtype=f64)
    poisoned = stiff.integrate(torch.ones(1, dtype=f64, device=dev),
                               torch.zeros(1, dtype=f64, device=dev))
    if not bool(torch.all(torch.isnan(poisoned))):
        raise AssertionError("the adaptive integrator did not poison a "
                             "budget that ran out")
    log("[adaptive] poisoning: a stiff decay at max_adaptive_steps=50 "
        "gives NaN on the card")

    plant = Model(device=dev, dtype=torch.float32, **ADAPTIVE_F32, **tank)
    mpc = build_slice(dev, RTI, model=plant, init_solver_opts=MC_INIT)
    ck.reset_launches()
    t0 = time.perf_counter()
    xs, us = mpc.solve(X0, ADAPTIVE_LOOP_STEPS * DT, XSP, noise=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cold = MC_INIT["al_iters"] * MC_INIT["max_iters"]
    launches = check_launches(ck, expect_launches(
        k1=cold + ADAPTIVE_LOOP_STEPS * RTI["al_iters"] * RTI["max_iters"]),
        "adaptive-plant loop")
    xs = xs.cpu().numpy()
    miss = float(np.abs(xs[-1, :2] - XSP[:2]).max())
    log(f"[adaptive] {ADAPTIVE_LOOP_STEPS}-step MPC.solve with the adaptive "
        f"plant (f32, {ADAPTIVE_F32}): {wall:.1f} s; "
        f"{plant.adaptive_host_reads} host reads, "
        f"{plant.adaptive_host_reads / ADAPTIVE_LOOP_STEPS:.1f} a plant "
        f"step; launches {launches}; ends {miss:.4f} from the setpoint of "
        f"the tracked tanks (<= 0.5)")
    if not (np.all(np.isfinite(xs)) and miss <= 0.5):
        raise AssertionError("the adaptive-plant loop misses")

    worst = dae_check(dev)
    log(f"[adaptive] DAE network (examples/dae_network.py), f64 card vs "
        f"CPU: max difference {worst:.3e} (<= 1e-10; the adaptive map, the "
        f"Newton elimination, the RK4 map's linearization)")
    return launches


#: the junction network of examples/dae_network.py: tank areas and flow
#: coefficients
DAE_A = (2.0, 3.0)
DAE_C = (1.2, 1.0, 0.25, 0.6)


def dae_network():
    """``(ode(x, z, u), alg(x, z, u))`` of examples/dae_network.py in
    torch: two tanks through a junction whose head z solves the node's
    flow balance."""
    (a1, a2), (c1, c2, c3, c4) = DAE_A, DAE_C

    def sq(v):
        return torch.sqrt(torch.clamp(v, min=1e-9))

    def ode(x, z, u):
        return torch.stack([(u[0] - c1 * sq(x[0] - z[0])) / a1,
                            (c2 * sq(z[0] - x[1]) - c4 * sq(x[1])) / a2])

    def alg(x, z, u):
        return torch.stack([c1 * sq(x[0] - z[0]) - c2 * sq(z[0] - x[1])
                            - c3 * sq(z[0])])

    return ode, alg


def dae_check(dev):
    """The DAE network's maps on ``dev`` against the CPU in f64: the
    adaptive integrator on 2 points at once, and the Newton elimination
    and the RK4 map's linearization at one.  Returns the largest
    difference; raises past 1e-10."""
    from gpmpc_tpu_torch import Model
    ode, alg = dae_network()
    rng = np.random.default_rng(19)
    xs = np.stack([rng.uniform(4.0, 8.0, 2), rng.uniform(0.5, 3.0, 2)], 1)
    us = rng.uniform(0.0, 4.0, (2, 1))
    sides = []
    for d in (dev, torch.device("cpu")):
        m = Model(Nx=2, Nu=1, ode=ode, alg=alg, Nz=1, dt=2.0,
                  z_guess=lambda x, u: 0.5 * (x[:1] + x[1:]),
                  clip_negative=True, integrator="adaptive", device=d,
                  dtype=torch.float64)
        x, u = (torch.tensor(v, dtype=torch.float64, device=d)
                for v in (xs, us))
        sides.append([m.integrate(x, u), m.solve_alg(x[0], u[0]),
                      *m.discrete_linearize(x[0], u[0])])
    worst = max(float((a.cpu() - b).abs().max()) for a, b in zip(*sides))
    if not worst <= 1e-10:
        raise AssertionError(f"the DAE network on the card is off the CPU: "
                             f"{worst}")
    return worst


def sparse_reference(path):
    """The CPU's sparse fits of phase 17 (d), f32 and f64 with the
    fixture's recipe, each's bound per dim re-evaluated in f64, its
    inducing indices and wall time, written as JSON to ``path`` (run as
    ``chip_smoke.py --sparse-reference PATH`` in a process of its own)."""
    from gpmpc_tpu_torch import GP
    from gpmpc_tpu_torch.models.convert import FIXTURE
    torch.set_num_threads(1)
    f = np.load(FIXTURE)
    out = {}
    for tag, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        t0 = time.perf_counter()
        gp = GP(f["tank_X"], f["tank_Y"], mean_func="zero", gp_method="TA",
                inducing=SPARSE_M, optimizer_opts=GP_OPTS, device="cpu",
                dtype=dtype, **SPARSE_RECIPE)
        out[tag] = {"bound": sparse_bound_f64(gp, f).tolist(),
                    "z_idx": gp.z_idx.tolist(),
                    "seconds": time.perf_counter() - t0}
    with open(path, "w") as fh:
        json.dump(out, fh)
    return 0


class SparseReference:
    """:func:`sparse_reference` in a child process started at once (so
    that it runs beside the card's work), its result read by
    :meth:`result`; :meth:`stop` ends it if it still runs."""

    def __init__(self):
        os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
        self.path = os.path.join(HERE, "build",
                                 f"sparse_reference_{os.getpid()}.json")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--sparse-reference",
             self.path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)

    def result(self, timeout=900):
        out, _ = self.proc.communicate(timeout=timeout)
        if self.proc.returncode != 0:
            raise RuntimeError(f"the CPU's sparse reference fit failed "
                               f"({self.proc.returncode}):\n{out}")
        with open(self.path) as fh:
            res = json.load(fh)
        os.remove(self.path)
        return res

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()
        if os.path.exists(self.path):
            os.remove(self.path)


def sparse_phase(ck, gc, dev, card, ref_proc):
    """Phase 17 (d): GP(tank_X, tank_Y, inducing=SPARSE_M) trained on the
    card with the fixture's recipe: exact launches (the exact subset fit's
    K4 and K5 an evaluation, two K5 a VFE evaluation, two for the
    posterior); each dim's bound, the card's hypers re-evaluated in f64
    on the CPU, within SPARSE_BOUND_TOL of the CPU's f32 fit's (and its
    gap to the f64 fit's); validate (one K3) with
    SMSE within 2x the full fixture GP's; a SPARSE_LOOP_STEPS-step TA loop
    with the sparse GP at the setpoint.  Returns the fit's launches and
    the GP."""
    from benchmarks.bench_spec import DT, TRAIN_ULB, TRAIN_UUB, TRAIN_XLB, \
        TRAIN_XUB, X0, XSP
    from gpmpc_tpu_torch import GP
    from gpmpc_tpu_torch.models.convert import FIXTURE, gp_from_fixture

    f = np.load(FIXTURE)
    recipe = SPARSE_RECIPE
    torch.cuda.synchronize()
    ck.reset_launches()
    t0 = time.perf_counter()
    gp = GP(f["tank_X"], f["tank_Y"], mean_func="zero", gp_method="TA",
            inducing=SPARSE_M, optimizer_opts=GP_OPTS, device=dev,
            dtype=torch.float32, **recipe)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ev = gp.fit_evals
    launches = check_launches(ck, expect_launches(
        k4=ev["exact"], k5=ev["exact"] + 2 * ev["vfe"] + 2), "sparse fit")
    log(f"[sparse] GP(inducing={SPARSE_M}) fixture recipe {recipe} on the "
        f"card: {wall:.3f} s wall (the full fit: phase 8), evaluations "
        f"{ev}; launches {launches}")
    bounds = ref_proc.result()
    card_bound = sparse_bound_f64(gp, f)
    ref = np.array(bounds["f32"]["bound"])
    gap64 = np.abs(card_bound - np.array(bounds["f64"]["bound"]))
    gap = np.abs(card_bound - ref)
    same_z = bounds["f32"]["z_idx"] == gp.z_idx.cpu().tolist()
    log(f"[sparse] bound per dim in f64 on the CPU: the card's fit "
        f"{card_bound.tolist()}, the CPU's f32 fit {ref.tolist()} "
        f"({bounds['f32']['seconds']:.1f} s in its own process, beside "
        f"phases (a)-(c); inducing set {'equal' if same_z else 'differs'})"
        f": max gap "
        f"{gap.max():.4f} (<= {SPARSE_BOUND_TOL}); the CPU's f64 fit "
        f"{bounds['f64']['bound']} ({bounds['f64']['seconds']:.1f} s): gaps "
        f"{gap64.round(4).tolist()} (information: an f32 fit's optimum "
        f"sits at the f32 K_MM jitter floor)")
    if not (np.all(np.isfinite(card_bound)) and gap.max() <= SPARSE_BOUND_TOL):
        raise AssertionError("the card's sparse fit is off the CPU's")

    ck.reset_launches()
    xt, yt = build_plant(dev).generate_training_data(
        100, uub=TRAIN_UUB, ulb=TRAIN_ULB, xub=TRAIN_XUB, xlb=TRAIN_XLB,
        noise=False, generator=torch.Generator(device=dev).manual_seed(9))
    full = gp_from_fixture(device=dev, dtype=torch.float32, gp_method="TA",
                           optimizer_opts=GP_OPTS)
    ck.reset_launches()
    smse, mnlp, _ = gp.validate(xt, yt, verbose=False)
    torch.cuda.synchronize()
    check_launches(ck, expect_launches(k3=1), "sparse validate")
    smse_f, _, _ = full.validate(xt, yt, verbose=False)
    log(f"[sparse] validate: one K3 launch; SMSE {smse.tolist()} against "
        f"the full GP's {smse_f.tolist()} (<= 2x); MNLP {mnlp.tolist()}")
    if not (np.all(np.isfinite(mnlp)) and np.all(smse <= 2.0 * smse_f)):
        raise AssertionError("the sparse GP validates worse than 2x the "
                             "full GP")

    mpc = build_slice(dev, RTI, gp=gp, init_solver_opts=MC_INIT)
    ck.reset_launches()
    t0 = time.perf_counter()
    xs, us = mpc.solve(X0, SPARSE_LOOP_STEPS * DT, XSP, noise=False)
    torch.cuda.synchronize()
    cold = MC_INIT["al_iters"] * MC_INIT["max_iters"]
    loop = check_launches(ck, expect_launches(
        k1=cold + SPARSE_LOOP_STEPS * RTI["al_iters"] * RTI["max_iters"],
        k2=SPARSE_LOOP_STEPS), "sparse TA loop")
    xs = xs.cpu().numpy()
    miss = float(np.abs(xs[-1, :2] - XSP[:2]).max())
    log(f"[sparse] {SPARSE_LOOP_STEPS}-step TA loop with the sparse GP "
        f"({time.perf_counter() - t0:.1f} s): launches {loop}; ends "
        f"{miss:.4f} from the setpoint of the tracked tanks (<= 0.5)")
    if not (np.all(np.isfinite(xs)) and miss <= 0.5):
        raise AssertionError("the sparse GP's loop misses the setpoint")
    return launches, gp, wall


def timed_row(name, kernel, line, fn, plain, bd, launches, err, card,
              what, library=None):
    """A JSON row: event ms over 200 calls of ``fn``, device ms per call,
    the plain version's ms (and ``library``'s) and the bound ``bd``."""
    ms = cuda_time_ms(fn, reps=200)
    dev_ms, _, note = device_time_ms(fn)
    plain_ms = cuda_time_ms(plain, reps=20)
    lib_ms = cuda_time_ms(library, reps=50) if library else None
    log(f"[time] {name} ({what}): kernel {ms:.4f} ms, device "
        f"{fmt_ms(dev_ms)}{note} per launch, plain torch on the card "
        f"{plain_ms:.4f} ms"
        f"{'' if lib_ms is None else f', library {lib_ms:.4f} ms'}, bound "
        f"{bd[0]:.3e} ms ({bd[1]}); {launches} launches on its path; "
        f"max|err| {err:.3e} on {card}")
    return {"name": name, "route": "cuda",
            "source": f"gpmpc_tpu_torch/csrc/{kernel}.cu",
            "replaces": f"gpmpc_tpu/ops/pallas_kernels.py:{line}",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "device_ms": dev_ms, "bound_ms": bd[0],
            "bound_by": bd[1], "library_ms": lib_ms}


def slice_f3_rows(ck, gc, dev, card, mc, ut, checks, fit, gp):
    """Phase 17's JSON rows: K1 and K2 at the ensemble's batch (B =
    MC_LANES; K2 on its last states and inputs), K3 vmapped both ways,
    K5 at the sparse VFE fit's shape (P = 2 starts x 4 dims, M = 32, on
    the K_MM of the card's hypers)."""
    from benchmarks.bench_spec import DT
    from gpmpc_tpu_torch.systems import four_tank_ode
    launches, x, u, _ = mc
    rows = []
    q = ck.stage_qp_inputs(20, 4, 2, 24, MC_LANES, device=dev)
    reg = torch.full((MC_LANES,), 1e-6, device=dev)
    err1 = ck.check_riccati_sweep(q, reg)
    out = ck.riccati_sweep(*q, reg)
    rows.append(timed_row(
        "riccati_sweep[solve_mc]", "riccati_sweep", 394,
        lambda: ck.riccati_sweep(*q, reg),
        lambda: ck.riccati_sweep_reference(*q, reg),
        bound(nbytes(*q, reg, *out), MC_LANES * riccati_flops(20, 4, 2)),
        launches["riccati_sweep"], err1, card,
        f"B={MC_LANES}, Nt=20, nx=4, nu=2"))
    err2 = ck.check_rk4_substeps(four_tank_ode, x, u, DT / 10, 10)
    y = ck.rk4_substeps(four_tank_ode, x, u, DT / 10, 10)
    rows.append(timed_row(
        "rk4_substeps[solve_mc]", "rk4_substeps", 233,
        lambda: ck.rk4_substeps(four_tank_ode, x, u, DT / 10, 10),
        lambda: ck.rk4_substeps_reference(four_tank_ode, x, u, DT / 10, 10),
        bound(nbytes(x, u, y), MC_LANES * 10 * (4 * 22 + 52)),
        launches["rk4_substeps"], err2, card,
        f"B={MC_LANES} on the ensemble's last states"))
    for tag in ("ut", "online"):
        call, args, err = checks[tag]
        mu, ks = call()
        lanes, b, d = args[0].shape
        n, ny = args[1].shape[-2], args[2].shape[-2]
        if tag == "ut":
            def plain(args=args):
                return gc.gp_predict_batch_reference(
                    args[0].reshape(-1, d), *args[1:])
        else:
            def plain(args=args):
                return gc.gp_predict_batch_reference(*args)
        rows.append(timed_row(
            f"gp_predict_batch[vmap_{tag}]", "gp_predict_batch", 459, call,
            plain, bound(nbytes(*args, mu, ks),
                         lanes * ny * b * n * (3 * d + 5)),
            ut[tag]["gp_predict_batch"], err, card,
            f"vmap over {lanes} lanes, (Ny,B,N,D)=({ny},{b},{n},{d})"
            f"{', a posterior per lane' if tag == 'online' else ''}"))
    from gpmpc_tpu_torch.models import gp_core
    from gpmpc_tpu_torch.ops.kernels import kernel_cross
    h = gp.hyper
    ell = torch.exp(h.log_ell).repeat(2, 1)[:, None, :]
    sf2 = torch.exp(h.log_sf2).repeat(2)
    z = gp.Zn
    eye = torch.eye(z.shape[0], device=dev)
    jit = max(gp_core._jitter_floor(gp.cfg, z.dtype),
              800.0 * float(torch.finfo(z.dtype).eps))
    k = (kernel_cross("se", z, z, ell, sf2[:, None, None]) * (1.0 - eye)
         + (sf2 + jit * sf2)[:, None, None] * eye).contiguous()
    err5 = gc.check_cholesky(k)
    p, m = k.shape[0], k.shape[-1]
    rows.append(timed_row(
        "cholesky[sparse]", "cholesky", 206, lambda: gc.cholesky(k),
        lambda: gc.cholesky_reference(k), cholesky_bound(p, m),
        fit["cholesky"], err5, card, f"P={p}, M={m}: K_MM of the VFE fit",
        library=lambda: torch.linalg.cholesky_ex(k)))
    return rows


def slice_f3_phase(ck, gc, dev, card, ta_step_ms):
    """Phase 17: (a) solve_mc and the chance calibration, (b) UT under
    solve_mc and K3 under vmap, (c) the adaptive plant and the DAE, (d)
    the sparse GP.  Returns its JSON rows."""
    t_phase = time.perf_counter()
    ref_proc = SparseReference()
    try:
        mc = mc_ensemble(ck, dev, card, ta_step_ms)
        ut, checks = mc_ut(ck, gc, dev, card)
        adaptive_phase(ck, dev, card)
        fit, gp, _ = sparse_phase(ck, gc, dev, card, ref_proc)
    finally:
        ref_proc.stop()
    rows = slice_f3_rows(ck, gc, dev, card, mc, ut, checks, fit, gp)
    log(f"[slice F3] phase 17: {time.perf_counter() - t_phase:.1f} s")
    return rows


def slice_f3_alone():
    """Phases 1-2 and 17, and phase 17's kernel rows, alone (the single
    loop's step for the comparison timed here over 5 steps)."""
    from benchmarks.bench_spec import X0, XSP
    from gpmpc_tpu_torch.ops import cuda_kernels as ck
    from gpmpc_tpu_torch.ops import gp_cuda as gc
    card = card_line()
    dev = torch.device("cuda")
    log(f"[card] nvidia-smi: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    ck.build_library()
    log(f"[build] {time.perf_counter() - t0:.2f} s")
    mpc = build_slice(dev, RTI)
    x0 = X0.astype(np.float32)
    u0, warm, _, _ = mpc.solve_step(torch.as_tensor(x0, device=dev), XSP)
    ta_ms = cuda_time_ms(rti_step_fn(mpc, x0, u0, warm), reps=5, warmup=1)
    log(f"[time] RTI control step (single loop): {ta_ms:.3f} ms/step")
    rows = slice_f3_phase(ck, gc, dev, card, ta_ms)
    print(card_line(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    return 0


# ------------------------------------------------------------ phase 18

#: phase 18: warm steps of the exported and the eager loop from X0, and
#: steps of each timed in turns (after one of warm-up)
G_STEPS = 10
G_TIMED = 5
#: bound of the exported loop against the eager loop on the card (and of
#: a fresh process serving the artifact against the first): bitwise is
#: expected, as on the CPU (tests/test_torch_export.py)
G_TOL = 1e-5


def artifact_loop(step, plant, args, n):
    """``n`` receding steps from the step arguments ``args`` through a
    loaded artifact: each u0 to the plant, the warm start threaded.
    Returns the states (n + 1, 4) and inputs (n, 2) on the card."""
    warm, x, x_sp, u, sigma0, con_par, consts = args
    xs, us = [x], []
    for _ in range(n):
        u, warm, _ = step(warm, x, x_sp, u, sigma0, con_par, consts)
        x = plant.integrate(x, u)
        xs.append(x)
        us.append(u)
    return torch.stack(xs), torch.stack(us)


def serve_artifact(blob_path, args_path, out_path):
    """Phase 18 (b)'s child process: load the artifact and the step
    arguments, build only the plant Model, run G_STEPS steps, save the
    trajectory."""
    from gpmpc_tpu_torch.utils.export import load_solve_step
    t0 = time.perf_counter()
    step = load_solve_step(blob_path)
    load_s = time.perf_counter() - t0
    args = torch.load(args_path, weights_only=False)
    xs, us = artifact_loop(step, build_plant(torch.device("cuda")), args,
                           G_STEPS)
    torch.cuda.synchronize()
    torch.save(dict(xs=xs.cpu(), us=us.cpu(), load_s=load_s), out_path)
    return 0


def trace_summary(prof, n, wall):
    """Device kernels and device ms per step, and the device's busy share
    of the wall, from a torch.profiler run of ``n`` steps taking ``wall``
    seconds (as profile_steps reads them)."""
    device = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    dev_us = sum(e.self_device_time_total for e in device)
    if dev_us <= 0:
        raise AssertionError("the profiler saw no device time")
    kernels = sum(e.count for e in device if e.self_device_time_total > 0)
    return dict(kernels_per_step=kernels / n, device_ms_per_step=dev_us / n
                / 1e3, wall_ms_per_step=wall / n * 1e3,
                busy_share=dev_us / 1e6 / wall)


def export_artifact(out_dir):
    """Phase 18 (a)'s child process: build the main path's MPC on the card,
    export its RTI step into ``out_dir``, save the step's arguments and
    what the export did (seconds, nodes, bytes, calls by operator)."""
    from benchmarks.bench_spec import X0, XSP
    from gpmpc_tpu_torch.utils import export as ex
    dev = torch.device("cuda")
    mpc = build_slice(dev, RTI)
    torch.save(ex._example_args(mpc, X0, XSP),
               os.path.join(out_dir, "args.pt"))
    ex.export_solve_step(mpc, os.path.join(out_dir, "solve_step.pt2"))
    with open(os.path.join(out_dir, "export.json"), "w") as fh:
        json.dump(dict(ex.EXPORT_INFO, ops=dict(ex.EXPORT_INFO["ops"])), fh)
    return 0


class SliceGChildren:
    """Phase 18's child processes: (a)'s export of the main path's step
    (``--export-artifact``) and (c)'s deploy walkthrough, started before
    phase 17 in the whole smoke so that they run beside it (each is one
    host thread on a machine of eight cores; the card is idle >90% of any
    step), and (b)'s fresh serving process, started once the artifact is
    saved.  ``stop`` ends any still running."""

    def __init__(self):
        self.out_dir = os.path.join(HERE, "build", "slice_g")
        os.makedirs(self.out_dir, exist_ok=True)
        self.t0 = time.perf_counter()
        self.procs = {}
        self.deploy_log = os.path.join(self.out_dir, "deploy.log")
        with open(self.deploy_log, "w") as fh:
            self.procs["deploy"] = subprocess.Popen(
                [sys.executable, "-m", "gpmpc_tpu_torch.examples.deploy",
                 "--quick", "--cpu-built"], cwd=HERE, stdout=fh,
                stderr=subprocess.STDOUT)
        self.procs["export"] = self.child("--export-artifact", self.out_dir)

    def child(self, *argv):
        return subprocess.Popen([sys.executable,
                                 os.path.join(HERE, "chip_smoke.py"), *argv],
                                cwd=HERE)

    def stop(self):
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


def slice_g_phase(ck, dev, card, children, eager_trace=True):
    """Phase 18: the deployable RTI solve step on the main path at full
    width.  (a) exported on the card by a child process (K1 four
    gpmpc::riccati_sweep nodes), reloaded here, G_STEPS warm steps through
    it beside the eager loop; (b) a fresh process serving the saved
    artifact; (c) the deploy walkthrough with the CPU-built artifact moved
    to the card; (d) the exported step timed against the eager one in
    turns (profiling.time_fn) and traced (profiling.trace; the eager step
    too with ``eager_trace``, which the whole smoke leaves to phase 6).
    ``children`` is the SliceGChildren started before.  Returns the
    artifact's K1 row."""
    t_phase = time.perf_counter()
    try:
        step, mpc, args, launches = export_and_serve(ck, dev, children)
        deploy_check(children.procs["deploy"], children.deploy_log,
                     children.t0)
        step_times(mpc, step, args, children.out_dir, card, eager_trace)
        row = artifact_k1_row(ck, dev, card, launches)
    finally:
        children.stop()
    log(f"[slice G] phase 18: {time.perf_counter() - t_phase:.1f} s (its "
        f"child processes started {t_phase - children.t0:.1f} s before)")
    return [row]


def export_and_serve(ck, dev, children):
    """Phase 18 (a) and (b): the export child's artifact checked and
    reloaded, G_STEPS steps through it beside the eager loop, and a fresh
    process serving the saved artifact.  Returns the loaded step, the MPC,
    the step's arguments and the artifact loop's launches."""
    from benchmarks.bench_spec import XSP
    from gpmpc_tpu_torch.utils import export as ex

    out_dir = children.out_dir
    blob_path = os.path.join(out_dir, "solve_step.pt2")
    args_path = os.path.join(out_dir, "args.pt")
    out_path = os.path.join(out_dir, "served.pt")
    if children.procs["export"].wait(timeout=900) != 0:
        raise AssertionError(f"the export child exited "
                             f"{children.procs['export'].returncode}")
    with open(os.path.join(out_dir, "export.json")) as fh:
        info = json.load(fh)
    t_serve = time.perf_counter()
    children.procs["serve"] = serve = children.child(
        "--serve-artifact", blob_path, args_path, out_path)
    ops = info["ops"]
    stray = sorted(k for k in ops
                   if not k.startswith(("aten::", "gpmpc::"))
                   and k != "getitem")
    log(f"[slice G] (a) the main path's RTI step exported on the card (a "
        f"child process, done {t_serve - children.t0:.1f} s after it "
        f"started): trace {info['trace_s']:.1f} s, export "
        f"{info['export_s']:.1f} s, save {info['save_s']:.1f} s, "
        f"{info['nodes']} nodes, {info['bytes']} bytes; gpmpc ops "
        f"{({k: v for k, v in ops.items() if 'gpmpc' in k})}; calls of "
        f"Python functions {stray}")
    if ops.get("gpmpc::riccati_sweep") != 4 or stray:
        raise AssertionError(f"the card-built artifact holds "
                             f"{ops.get('gpmpc::riccati_sweep')} K1 nodes "
                             f"(not 4) or calls Python functions {stray}")

    # (a) the reloaded artifact's loop beside the eager loop
    t0 = time.perf_counter()
    step = ex.load_solve_step(blob_path)
    load_s = time.perf_counter() - t0
    if ex.op_counts(step.module.graph)["gpmpc::riccati_sweep"] != 4:
        raise AssertionError("the reloaded artifact lost its K1 nodes")
    args = torch.load(args_path, weights_only=False)
    mpc = build_slice(dev, RTI)
    plant = mpc.model
    ck.reset_launches()
    t0 = time.perf_counter()
    xs_a, us_a = artifact_loop(step, plant, args, G_STEPS)
    torch.cuda.synchronize()
    wall_a = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    expect = dict(riccati_sweep=4 * G_STEPS, rk4_substeps=G_STEPS,
                  se_ard_gram=0, cholesky=0, gp_predict_batch=0)
    if launches != expect:
        raise AssertionError(f"the artifact's loop launched {launches}, not "
                             f"{expect}")
    ck.reset_launches()
    warm, x, _, u = args[:4]
    xs_e, us_e = [x], []
    t0 = time.perf_counter()
    for _ in range(G_STEPS):
        u, warm, _, _ = mpc.solve_step(x, XSP, warm=warm, u_prev=u)
        x = plant.integrate(x, u)
        xs_e.append(x)
        us_e.append(u)
    torch.cuda.synchronize()
    wall_e = time.perf_counter() - t0
    if dict(ck.LAUNCHES) != expect:
        raise AssertionError(f"the eager loop launched {ck.LAUNCHES}")
    xs_e, us_e = torch.stack(xs_e), torch.stack(us_e)
    du = float((us_a - us_e).abs().max())
    dx = float((xs_a - xs_e).abs().max())
    bitwise = torch.equal(us_a, us_e) and torch.equal(xs_a, xs_e)
    log(f"[slice G] (a) loaded in {load_s:.1f} s; {G_STEPS} warm steps from "
        f"X0 through the artifact ({wall_a:.2f} s) and eager solve_step "
        f"({wall_e:.2f} s), beside the child processes: max |du| "
        f"{du:.3e}, max |dx| {dx:.3e} (bitwise {bitwise}; <= {G_TOL:g}); "
        f"K1 4 and K2 1 a step in each; final state {xs_a[-1].tolist()}")
    if not (np.isfinite(xs_a.cpu().numpy()).all() and du <= G_TOL
            and dx <= G_TOL):
        raise AssertionError("the artifact's loop departs from the eager "
                             "loop")

    # (b) the fresh process's trajectory
    if serve.wait(timeout=600) != 0:
        raise AssertionError(f"the serving process exited "
                             f"{serve.returncode}")
    served = torch.load(out_path)
    ddx = float((served["xs"] - xs_a.cpu()).abs().max())
    ddu = float((served["us"] - us_a.cpu()).abs().max())
    log(f"[slice G] (b) a fresh process (plant Model only) loaded the "
        f"artifact in {served['load_s']:.1f} s and ran {G_STEPS} steps "
        f"(done {time.perf_counter() - t_serve:.1f} s after it started): "
        f"max |dx| {ddx:.3e}, max |du| {ddu:.3e} against (a) (bitwise "
        f"{ddx == 0.0 and ddu == 0.0}; <= {G_TOL:g})")
    if not (ddx <= G_TOL and ddu <= G_TOL):
        raise AssertionError("the served artifact does not reproduce (a)")
    return step, mpc, args, launches


def deploy_check(deploy, deploy_log, t_start):
    """Phase 18 (c): the deploy walkthrough's child exits 0 (its own
    checks: the artifact against the live first solve, the loop at the
    setpoint, the CPU-built artifact on the card); its output, from
    ``deploy_log``, goes to the log."""
    rc = deploy.wait(timeout=900)
    with open(deploy_log) as fh:
        out = fh.read()
    for line in out.splitlines():
        if "Warning" not in line and not line.startswith(" "):
            log(f"[slice G] (c) deploy: {line}")
    if rc != 0:
        raise AssertionError(f"the deploy example exited {rc}:\n"
                             f"{out[-4000:]}")
    log(f"[slice G] (c) deploy --quick --cpu-built exited 0, "
        f"{time.perf_counter() - t_start:.1f} s after it started")


def step_times(mpc, step, args, out_dir, card, eager_trace):
    """Phase 18 (d): the exported RTI control step (solve + plant) against
    the eager one by profiling.time_fn in turns (exported, eager, eager,
    exported), and profiling.trace of three exported steps (and three
    eager ones with ``eager_trace``): kernels and device ms a step, the
    device's busy share of the traced wall and of time_fn's median."""
    from benchmarks.bench_spec import XSP
    from gpmpc_tpu_torch.utils import profiling

    plant, state = mpc.model, {}

    def reset():
        state.update(x=args[1], warm=args[0], u=args[3])

    def exported():
        u_, w, _ = step(state["warm"], state["x"], args[2], state["u"],
                        *args[4:])
        state.update(u=u_, warm=w, x=plant.integrate(state["x"], u_))

    def eager():
        u_, w, _, _ = mpc.solve_step(state["x"], XSP, warm=state["warm"],
                                     u_prev=state["u"])
        state.update(u=u_, warm=w, x=plant.integrate(state["x"], u_))

    steps = {"exported": exported, "eager": eager}
    times = {"exported": [], "eager": []}
    for name in ("exported", "eager", "eager", "exported"):
        reset()
        times[name].append(profiling.time_fn(steps[name], reps=G_TIMED))
    for name, pairs in times.items():
        log(f"[slice G] (d) {name} RTI control step (solve + plant), "
            f"profiling.time_fn min/median ms: "
            f"{', '.join(f'{a * 1e3:.3f}/{b * 1e3:.3f}' for a, b in pairs)}"
            f" ({G_TIMED} steps after 1, two turns) on {card}")
    for name in ("exported", "eager") if eager_trace else ("exported",):
        reset()
        steps[name]()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profiling.trace(os.path.join(out_dir, f"trace_{name}")) as prof:
            for _ in range(3):
                steps[name]()
        s = trace_summary(prof, 3, time.perf_counter() - t0)
        median = float(np.median([b for _, b in times[name]]))
        log(f"[slice G] (d) profiling.trace of 3 {name} steps: "
            f"{s['kernels_per_step']:.0f} device kernels, "
            f"{s['device_ms_per_step']:.3f} ms device time, "
            f"{s['wall_ms_per_step']:.3f} ms wall a step under the profiler;"
            f" device busy {100 * s['busy_share']:.2f}% of it, "
            f"{100 * s['device_ms_per_step'] / 1e3 / median:.2f}% of "
            f"time_fn's median step on {card}")


def artifact_k1_row(ck, dev, card, launches):
    """The artifact's K1 row: K1 as the artifact calls it (through its
    operator) at the main path's stage-QP shape, against its plain
    version, timed beside its bound."""
    q1 = ck.stage_qp_inputs(20, 4, 2, 0, device=dev)
    reg = torch.tensor(1e-6, device=dev)
    out = ck.riccati_sweep_op(*q1, reg)
    ref = ck.riccati_sweep_reference(*q1, reg)
    err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
    ms = cuda_time_ms(lambda: ck.riccati_sweep_op(*q1, reg), reps=200)
    dev_ms, _, note = device_time_ms(lambda: ck.riccati_sweep_op(*q1, reg))
    plain = cuda_time_ms(lambda: ck.riccati_sweep_reference(*q1, reg),
                         reps=20)
    bd = bound(nbytes(*q1, reg, *out), riccati_flops(20, 4, 2))
    log(f"[time] riccati_sweep[artifact] (Nt=20, nx=4, nu=2, through "
        f"gpmpc::riccati_sweep): kernel {ms:.4f} ms, device "
        f"{fmt_ms(dev_ms)}{note} per launch, plain torch on the card "
        f"{plain:.4f} ms, bound {bd[0]:.3e} ms ({bd[1]}); "
        f"{launches['riccati_sweep']} launches in the artifact's loop; "
        f"max|err| {err:.3e} on {card}")
    return {"name": "riccati_sweep[artifact]", "route": "cuda",
            "source": "gpmpc_tpu_torch/csrc/riccati_sweep.cu",
            "replaces": "gpmpc_tpu/ops/pallas_kernels.py:394",
            "launches": launches["riccati_sweep"], "max_abs_err": err,
            "ms": ms, "plain_ms": plain, "device_ms": dev_ms,
            "bound_ms": bd[0], "bound_by": bd[1], "library_ms": None}


def slice_g_alone():
    """Phases 1-2 and 18, and phase 18's kernel row, alone."""
    from gpmpc_tpu_torch.ops import cuda_kernels as ck
    card = card_line()
    dev = torch.device("cuda")
    log(f"[card] nvidia-smi: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    ck.build_library()
    log(f"[build] {time.perf_counter() - t0:.2f} s")
    rows = slice_g_phase(ck, dev, card, SliceGChildren())
    print(card_line(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    return 0


# ------------------------------------------------------------ phase 19

#: phase 19: the data-parallel surfaces over a torch.distributed mesh, in
#: child processes of the smoke (``--mesh-rank``): (a) one NCCL rank, then
#: (b) two gloo ranks both on the one card (NCCL refuses two ranks on one
#: device); ``--mesh`` on a machine of four cards runs (c), four NCCL
#: ranks, one a card, in place of (b).  The study's steps (bench config 5
#: at B = 1024, phase 14 (b)'s configuration), the ensemble's steps (phase
#: 17 (a)'s at 64 lanes), the layouts run in turn (the first is the one
#: all others are held against), the seconds each layout's children may
#: take and the process group's collective timeout
MESH_STUDY_STEPS = 4
MESH_MC_STEPS = 2
MESH_LAYOUTS = (("nccl", 1), ("gloo", 2))
MESH_LAYOUTS_CARDS = (("nccl", 1), ("nccl", 4))
MESH_TIMEOUT = 420
MESH_GROUP_TIMEOUT = 300
#: phase 8's example recipe, fitted again through GP(mesh=)
MESH_FIT = dict(multistart=2, max_iters=200, seed=1)
#: bound of the two-rank fit's NLL per dim against the one-rank fit's,
#: relative (bitwise is expected; the f32 batched objective at P = 4
#: instead of 8 may round otherwise)
MESH_FIT_RTOL = 1e-5


class LaunchShapes:
    """The leading (batch or problem) dim of every launch of K1, K2, K4 and
    K5 in this process, by kernel: a spy over the wrappers' launch paths
    (the wrappers still count the launches)."""

    def __init__(self, ck, gc):
        self.seen = {}
        for mod, attr, name, lead in (
                (ck, "_riccati_sweep_launch", "riccati_sweep",
                 lambda a, *_: a.shape[0] if a.ndim == 4 else 1),
                (ck, "_rk4_substeps_launch", "rk4_substeps",
                 lambda spec, x, *_: x.shape[0] if x.ndim == 2 else 1),
                (gc, "se_ard_gram", "se_ard_gram",
                 lambda x, ell, *_: ell.shape[0]),
                (gc, "cholesky", "cholesky",
                 lambda a: a.numel() // a.shape[-1] ** 2)):
            self._wrap(mod, attr, name, lead)

    def _wrap(self, mod, attr, name, lead):
        orig = getattr(mod, attr)

        def spy(*args, **kw):
            self.seen.setdefault(name, set()).add(lead(*args))
            return orig(*args, **kw)

        setattr(mod, attr, spy)

    def take(self):
        seen = {k: sorted(v) for k, v in self.seen.items()}
        self.seen = {}
        return seen


def mesh_rank(rank, world, backend, out_dir, device):
    """Phase 19's child process: rank ``rank`` of ``world`` on ``device``
    (NCCL: card ``rank``; gloo: every rank on card 0) with ``backend`` (a
    ``file://`` rendezvous in ``out_dir``); the study, the fit and the
    ensemble through ``mesh=`` on make_study_mesh()'s 1-D mesh, each run's
    launch counts and launch shapes; a one-rank mesh also runs
    the study and the ensemble without the mesh and reads phase 8's fit of
    the recipe from ``example_fit.pt`` (bitwise expected).  Writes what it
    saw to ``{backend}{world}_rank{rank}.pt``."""
    from benchmarks.bench_spec import DT, X0, XSP
    from gpmpc_tpu_torch import GP
    from gpmpc_tpu_torch.models.convert import FIXTURE
    from gpmpc_tpu_torch.ops import cuda_kernels as ck
    from gpmpc_tpu_torch.ops import gp_cuda as gc
    from gpmpc_tpu_torch.parallel import distributed

    tag = f"{backend}{world}"
    if not distributed.initialize_multihost(
            coordinator_address=f"file://{out_dir}/rendezvous_{tag}",
            num_processes=world, process_id=rank, backend=backend,
            device=device, timeout=MESH_GROUP_TIMEOUT):
        raise RuntimeError("initialize_multihost joined no process group")
    dev = torch.device(device)
    if dev.type == "cuda":
        ck.build_library()
    mesh = distributed.make_study_mesh(dev.type)
    shapes = LaunchShapes(ck, gc)
    out = dict(rank=rank, world=world, backend=backend,
               mesh=(mesh.mesh_dim_names, mesh.size()), launches={},
               shapes={}, seconds={})

    def run(name, fn):
        torch.cuda.synchronize()
        ck.reset_launches()
        shapes.take()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out["seconds"][name] = time.perf_counter() - t0
        out["launches"][name] = dict(ck.LAUNCHES)
        out["shapes"][name] = shapes.take()
        return res

    # the study: a warm-up step, one step and MESH_STUDY_STEPS steps through
    # the mesh (ms per step from their slope)
    study = build_study(dev, fused=True, mesh=mesh)
    x0s, noise = study_inputs(study)
    n = MESH_STUDY_STEPS
    study.run(x0s, STUDY_XSP, 1, noise_ws=noise[:, :1])
    run("study_1", lambda: study.run(x0s, STUDY_XSP, 1,
                                     noise_ws=noise[:, :1]))
    res = run("study", lambda: study.run(x0s, STUDY_XSP, n,
                                         noise_ws=noise[:, :n]))
    out["study"] = {k: to_cpu(getattr(res, k)) for k in
                    ("x_traj", "u_traj", "cost", "mean_cost", "gp_points")}
    if world == 1:
        lstudy = build_study(dev, fused=True)
        local = run("study_local", lambda: lstudy.run(
            x0s, STUDY_XSP, n, noise_ws=noise[:, :n]))
        out["study_bitwise"] = all(
            torch.equal(getattr(res, k), getattr(local, k))
            for k in ("x_traj", "u_traj", "cost", "obj", "gp_points",
                      "mean_cost")) and all(
            torch.equal(a, b) for a, b in zip(res.post, local.post))

    # the fit: phase 8's example recipe through GP(mesh=)
    f = np.load(FIXTURE)
    gp = run("fit", lambda: GP(f["tank_X"], f["tank_Y"], mean_func="zero",
                               gp_method="TA", optimizer_opts=GP_OPTS,
                               device=dev, dtype=torch.float32, mesh=mesh,
                               **MESH_FIT))
    out["fit"] = fit_record(gp)
    if world == 1:
        ref = torch.load(os.path.join(out_dir, "example_fit.pt"))
        out["fit_ref"] = ref
        out["fit_bitwise"] = (
            ref["n_evals"] == gp.n_evals
            and torch.equal(ref["nll"], out["fit"]["nll"])
            and all(torch.equal(x, y) for x, y in zip(ref["hyper"],
                                                       out["fit"]["hyper"])))

    # the ensemble: phase 17 (a)'s solve_mc at MC_LANES lanes
    mpc = build_slice(dev, RTI, init_solver_opts=MC_INIT)
    w = mc_noise(mpc, MC_LANES, MESH_MC_STEPS, 0)

    def ensemble(m):
        xs, us = mpc.solve_mc(X0, MESH_MC_STEPS * DT, XSP, MC_LANES,
                              noise_ws=w, mesh=m)
        return xs, us, dict(mpc.last_mc)

    xs, us, rec = run("mc", lambda: ensemble(mesh))
    out["mc"] = dict(xs=to_cpu(xs), us=to_cpu(us),
                     converged=rec["converged"], sigmas=rec["sigmas"])
    if world == 1:
        xs_l, us_l, rec_l = run("mc_local", lambda: ensemble(None))
        out["mc_bitwise"] = (
            torch.equal(xs, xs_l) and torch.equal(us, us_l)
            and all(np.array_equal(rec[k], rec_l[k]) for k in rec))
    torch.save(out, os.path.join(out_dir, f"{tag}_rank{rank}.pt"))
    import torch.distributed as dist
    dist.destroy_process_group()
    return 0


class MeshChildren:
    """Phase 19's child processes, given phase 8's example fit
    ``fit_gp``: the ``layouts`` ((backend, ranks) pairs) one after the
    other (each layout's ranks at once, each rank with a timeout), in a
    thread of the smoke so that they run beside earlier phases.  ``join``
    waits for them and raises if any failed; ``stop`` kills any still
    running."""

    def __init__(self, fit_gp, layouts=MESH_LAYOUTS):
        self.out_dir = os.path.join(HERE, "build", "mesh")
        os.makedirs(self.out_dir, exist_ok=True)
        for name in os.listdir(self.out_dir):
            if name.startswith("rendezvous_") or name.endswith(".pt"):
                os.remove(os.path.join(self.out_dir, name))
        torch.save(fit_record(fit_gp),
                   os.path.join(self.out_dir, "example_fit.pt"))
        self.layouts = layouts
        self.t0 = time.perf_counter()
        self.procs, self.error, self.walls = [], None, {}
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        try:
            for backend, world in self.layouts:
                t0 = time.perf_counter()
                tag = f"{backend}{world}"
                procs = []
                for r in range(world):
                    with open(os.path.join(self.out_dir,
                                           f"{tag}_rank{r}.log"), "w") as fh:
                        procs.append(subprocess.Popen(
                            [sys.executable, os.path.join(HERE,
                                                          "chip_smoke.py"),
                             "--mesh-rank", str(r), str(world), backend,
                             self.out_dir], cwd=HERE, stdout=fh,
                            stderr=subprocess.STDOUT))
                self.procs += procs
                for r, p in enumerate(procs):
                    left = MESH_TIMEOUT - (time.perf_counter() - t0)
                    if p.wait(timeout=max(left, 1.0)) != 0:
                        raise RuntimeError(f"{tag} rank {r} exited "
                                           f"{p.returncode}")
                self.walls[tag] = time.perf_counter() - t0
        except Exception as e:                # re-raised by join
            self.error = e
            self.stop()

    def join(self):
        self.thread.join(timeout=len(self.layouts) * MESH_TIMEOUT + 60)
        if self.thread.is_alive():
            self.error = self.error or TimeoutError("phase 19's children")
        self.stop()
        if self.error is not None:
            for name in sorted(os.listdir(self.out_dir)):
                if name.endswith(".log"):
                    with open(os.path.join(self.out_dir, name)) as fh:
                        log(f"[mesh] {name}:\n{fh.read()[-3000:]}")
            raise AssertionError(f"phase 19's children failed: "
                                 f"{self.error!r}")

    def stop(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def rel_diff(a, b):
    """max |a - b| / (1 + |b|), and max |a - b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = np.abs(a - b)
    return float((d / (1.0 + np.abs(b))).max()), float(d.max())


def mesh_loop_diff(a, b):
    """Worst relative differences of two runs' states (n, steps + 1, Nx),
    in the transient (the first TRANSIENT_STEPS steps) and after it."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = np.abs(a - b) / (1.0 + np.abs(b))
    worst = d.max(axis=(0, 2))[1:]
    return (float(worst[:TRANSIENT_STEPS].max()),
            float(worst[TRANSIENT_STEPS:].max()) if worst.size >
            TRANSIENT_STEPS else 0.0)


def mesh_check_a(a, card):
    """(a): one NCCL rank's study, fit and ensemble bitwise the runs
    without a mesh (the fit: phase 8's), exact launch counts at the full
    batch (K4 and K5 also at P = 4 for the posterior)."""
    cfg_k1 = STUDY_BUDGET["al_iters"] * STUDY_BUDGET["max_iters"]
    n = MESH_STUDY_STEPS
    checks = {
        "study": (expect_launches(k1=n * cfg_k1, k2=n),
                  {"riccati_sweep": [STUDY_B], "rk4_substeps": [STUDY_B]}),
        "fit": (expect_launches(k4=a["fit"]["n_evals"] + 1,
                                k5=a["fit"]["n_evals"] + 3),
                {"se_ard_gram": [4, MESH_FIT["multistart"] * 4],
                 "cholesky": [4, MESH_FIT["multistart"] * 4]}),
        "mc": (expect_launches(
            k1=MC_INIT["al_iters"] * MC_INIT["max_iters"]
            + MESH_MC_STEPS * RTI["al_iters"] * RTI["max_iters"],
            k2=MESH_MC_STEPS),
            {"riccati_sweep": [MC_LANES], "rk4_substeps": [MC_LANES]})}
    for name, (expect, shapes) in checks.items():
        got, seen = a["launches"][name], a["shapes"][name]
        log(f"[mesh] (a) nccl, 1 rank: {name} launches {got}, launch "
            f"shapes {seen}, {a['seconds'][name]:.3f} s")
        if got != expect:
            raise AssertionError(f"(a) {name}: launches {got} != {expect}")
        if any(seen.get(k) != v for k, v in shapes.items()):
            raise AssertionError(f"(a) {name}: launched at {seen}, "
                                 f"expected {shapes}")
    log(f"[mesh] (a) bitwise against mesh=None: study {a['study_bitwise']},"
        f" ensemble {a['mc_bitwise']}, fit against phase 8's "
        f"{a['fit_bitwise']} ({a['fit']['n_evals']} against "
        f"{a['fit_ref']['n_evals']} evaluations; NLL "
        f"{a['fit']['nll'].tolist()}) on {card}")
    if not (a["study_bitwise"] and a["mc_bitwise"] and a["fit_bitwise"]):
        raise AssertionError("(a) one-rank mesh runs differ from the local "
                             "runs")


def mesh_check_b(b, a, card):
    """(b) (and (c)): each rank's gathered results against (a)'s: the
    loops within the replay bounds, the fit's NLL per dim within
    MESH_FIT_RTOL; launch counts at the rank's block (K4/K5: the most
    launches over the ranks is n_evals + 1 / + 3).  Returns the worst
    differences."""
    cfg_k1 = STUDY_BUDGET["al_iters"] * STUDY_BUDGET["max_iters"]
    n, world = MESH_STUDY_STEPS, len(b)
    p_fit = sorted({MESH_FIT["multistart"] * 4 // world, 4})
    tag = f"{b[0]['backend']} {world} ranks"
    for r in b:
        for name, k1, k2, lanes in (
                ("study", n * cfg_k1, n, STUDY_B // world),
                ("mc", MC_INIT["al_iters"] * MC_INIT["max_iters"]
                 + MESH_MC_STEPS * RTI["al_iters"] * RTI["max_iters"],
                 MESH_MC_STEPS, MC_LANES // world)):
            got, seen = r["launches"][name], r["shapes"][name]
            if got != expect_launches(k1=k1, k2=k2) or \
                    seen.get("riccati_sweep") != [lanes] or \
                    seen.get("rk4_substeps") != [lanes]:
                raise AssertionError(f"({tag}) rank {r['rank']} {name}: "
                                     f"launches {got} at {seen}")
        log(f"[mesh] ({tag}) rank {r['rank']}: launches "
            f"{ {k: r['launches'][k] for k in ('study', 'fit', 'mc')} }, "
            f"shapes { {k: r['shapes'][k] for k in ('study', 'fit', 'mc')} }")
    fit_l = [r["launches"]["fit"] for r in b]
    evals = b[0]["fit"]["n_evals"]
    if max(x["se_ard_gram"] for x in fit_l) != evals + 1 or \
            max(x["cholesky"] for x in fit_l) != evals + 3 or \
            any(x["cholesky"] - x["se_ard_gram"] != 2 for x in fit_l) or \
            any(r["shapes"]["fit"]["se_ard_gram"] != p_fit for r in b):
        raise AssertionError(f"({tag}) fit launches {fit_l} for {evals} "
                             f"evaluations")
    worst = {}
    for r in b:
        st = mesh_loop_diff(r["study"]["x_traj"], a["study"]["x_traj"])
        mc = mesh_loop_diff(r["mc"]["xs"], a["mc"]["xs"])
        nll_a = a["fit"]["nll"].double()
        fit = float(((r["fit"]["nll"].double() - nll_a).abs()
                     / nll_a.abs()).max())
        same = {s: all(torch.equal(r[s][k], a[s][k]) for k in keys)
                for s, keys in (("study", ("x_traj", "u_traj")),
                                ("fit", ("nll",)), ("mc", ("xs", "us")))}
        log(f"[mesh] ({tag}) rank {r['rank']}'s gathered results against "
            f"(a)'s:"
            f" bitwise {same}; study states worst relative difference "
            f"{st[0]:.3e} (transient, 1e-2), mean cost "
            f"{float(r['study']['mean_cost']):.6f} against "
            f"{float(a['study']['mean_cost']):.6f}; ensemble {mc[0]:.3e} "
            f"(1e-2); fit NLL per dim {r['fit']['nll'].tolist()} "
            f"({r['fit']['n_evals']} evaluations), relative {fit:.3e} "
            f"({MESH_FIT_RTOL}) on {card}")
        if st[0] > 1e-2 or st[1] > 1e-3 or mc[0] > 1e-2 or mc[1] > 1e-3 \
                or fit > MESH_FIT_RTOL:
            raise AssertionError(f"({tag}) rank {r['rank']} is off (a)")
        worst = dict(study=max(worst.get("study", 0), st[0]),
                     mc=max(worst.get("mc", 0), mc[0]),
                     fit=max(worst.get("fit", 0), fit))
    return worst


def mesh_rows(ck, gc, dev, card, b):
    """Phase 11's rows at the block sizes the two-rank mesh launched: K1
    at (512, 8, 4, 2) (the study) and (32, 20, 4, 2) (the ensemble), K2 at
    B = 512 and 32 on the gathered runs' states, K4 and K5 at P = 4, N =
    100 (the fit's block), each held against its plain version, with rank
    0's launches."""
    from benchmarks.bench_spec import DT
    from gpmpc_tpu_torch.systems import four_tank_ode
    r0 = b[0]
    world = len(b)
    rows = []
    for name, nt, lanes, run, xs, us in (
            ("study", STUDY_NT, STUDY_B // world, "study",
             r0["study"]["x_traj"], r0["study"]["u_traj"]),
            ("solve_mc", 20, MC_LANES // world, "mc", r0["mc"]["xs"],
             r0["mc"]["us"])):
        q = ck.stage_qp_inputs(nt, 4, 2, 31, lanes, device=dev)
        reg = torch.full((lanes,), 1e-6, device=dev)
        err1 = ck.check_riccati_sweep(q, reg)
        out = ck.riccati_sweep(*q, reg)
        rows.append(timed_row(
            f"riccati_sweep[mesh_{name}]", "riccati_sweep", 394,
            lambda q=q, reg=reg: ck.riccati_sweep(*q, reg),
            lambda q=q, reg=reg: ck.riccati_sweep_reference(*q, reg),
            bound(nbytes(*q, reg, *out), lanes * riccati_flops(nt, 4, 2)),
            r0["launches"][run]["riccati_sweep"], err1, card,
            f"B={lanes}, Nt={nt}, nx=4, nu=2: a rank's block of {world}"))
        x = torch.as_tensor(xs[:lanes, -2], device=dev).contiguous()
        u = torch.as_tensor(us[:lanes, -1], device=dev).contiguous()
        err2 = ck.check_rk4_substeps(four_tank_ode, x, u, DT / 10, 10)
        y = ck.rk4_substeps(four_tank_ode, x, u, DT / 10, 10)
        rows.append(timed_row(
            f"rk4_substeps[mesh_{name}]", "rk4_substeps", 233,
            lambda x=x, u=u: ck.rk4_substeps(four_tank_ode, x, u, DT / 10,
                                             10),
            lambda x=x, u=u: ck.rk4_substeps_reference(four_tank_ode, x, u,
                                                       DT / 10, 10),
            bound(nbytes(x, u, y), lanes * 10 * (4 * 22 + 52)),
            r0["launches"][run]["rk4_substeps"], err2, card,
            f"B={lanes} on rank 0's gathered states"))
    p = MESH_FIT["multistart"] * 4 // world
    x, ell, sf2, sn2 = gc.gram_inputs(100, 6, p, 32, device=dev)
    err4 = gc.check_se_ard_gram(x, ell, sf2, sn2)
    k = gc.se_ard_gram(x, ell, sf2, sn2, 1e-6)
    rows.append(timed_row(
        "se_ard_gram[mesh_fit]", "se_ard_gram", 78,
        lambda: gc.se_ard_gram(x, ell, sf2, sn2, 1e-6),
        lambda: gc.se_ard_gram_reference(x, ell, sf2, sn2, 1e-6),
        bound(nbytes(x, ell, sf2, sn2, k), p * 100 * 100 * (3 * 6 + 4)),
        r0["launches"]["fit"]["se_ard_gram"], err4, card,
        f"P={p}, N=100, D=6: a rank's block of the example fit"))
    a = gc.spd_inputs(100, p, 33, device=dev)
    err5 = gc.check_cholesky(a)
    rows.append(timed_row(
        "cholesky[mesh_fit]", "cholesky", 206, lambda: gc.cholesky(a),
        lambda: gc.cholesky_reference(a), cholesky_bound(p, 100),
        r0["launches"]["fit"]["cholesky"], err5, card,
        f"P={p}, N=100: a rank's block of the example fit",
        library=lambda: torch.linalg.cholesky_ex(a)))
    return rows


def mesh_phase(ck, gc, dev, card, children):
    """Phase 19: waits for the children, holds (a) bitwise against the
    runs without a mesh and every other layout against (a), prints each
    layout's ms per study step (and rollout rate), fit and ensemble walls
    and each rank's launch counts; returns the kernel rows at the second
    layout's block sizes."""
    t_wait = time.perf_counter()
    children.join()
    waited = time.perf_counter() - t_wait
    runs = [[torch.load(os.path.join(children.out_dir,
                                     f"{backend}{world}_rank{r}.pt"),
                        weights_only=False) for r in range(world)]
            for backend, world in children.layouts]
    a = runs[0][0]
    mesh_check_a(a, card)
    span = MESH_STUDY_STEPS - 1
    for ranks in runs:
        worst = mesh_check_b(ranks, a, card) if ranks is not runs[0] \
            else None
        ms = [(r["seconds"]["study"] - r["seconds"]["study_1"]) / span * 1e3
              for r in ranks]
        log(f"[mesh] {ranks[0]['backend']}, {len(ranks)} rank(s): study "
            f"ms per control step (wall slope, {MESH_STUDY_STEPS} against 1 "
            f"step) at B={STUDY_B // len(ranks)} a rank "
            f"{[round(v, 3) for v in ms]} ({STUDY_B / max(ms) * 1e3:.1f} "
            f"rollout solves/s together); fit wall (P="
            f"{MESH_FIT['multistart'] * 4 // len(ranks)} a rank) "
            f"{[round(r['seconds']['fit'], 3) for r in ranks]} s; ensemble "
            f"wall ({MC_LANES // len(ranks)} lanes a rank) "
            f"{[round(r['seconds']['mc'], 3) for r in ranks]} s; worst "
            f"against (a) {worst} on {card}")
    log(f"[mesh] layouts' walls "
        f"{ {k: round(v, 1) for k, v in children.walls.items()} } s, "
        f"started {t_wait - children.t0:.1f} s before this phase, "
        f"{waited:.1f} s waited here")
    return mesh_rows(ck, gc, dev, card, runs[1])


def fit_record(gp):
    """A fit's hypers, NLL per dim and evaluations, on the CPU."""
    return dict(hyper=[h.cpu() for h in gp.hyper], nll=gp.nll.cpu(),
                n_evals=gp.n_evals)


def mesh_alone():
    """Phases 1-2, phase 8's example fit and phase 19, and phase 19's
    kernel rows, alone; on a machine of four cards (c), four NCCL ranks
    across them, in place of (b)."""
    from gpmpc_tpu_torch.ops import cuda_kernels as ck
    from gpmpc_tpu_torch.ops import gp_cuda as gc
    card = card_line()
    dev = torch.device("cuda")
    log(f"[card] nvidia-smi: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    ck.build_library()
    log(f"[build] {time.perf_counter() - t0:.2f} s")
    gp, _ = train_on_card(ck, dev, "example", MESH_FIT)
    four = torch.cuda.device_count() >= 4
    children = MeshChildren(gp, MESH_LAYOUTS_CARDS if four else MESH_LAYOUTS)
    try:
        rows = mesh_phase(ck, gc, dev, card, children)
    finally:
        children.stop()
    print(card_line(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    return 0


# ------------------------------------------------------------ phase 20

#: phase 20: the port's walkthroughs (gpmpc_tpu_torch/examples) at their
#: full settings, each in a child process (``--example-child``) started
#: after phase 6 that runs beside phases 7-18; the fits' shapes (P, N,
#: D) for their K4 and K5 rows (pendulum: 2 starts x Ny 2 at N = 120, D =
#: 3; batched_study: 1 start x Ny 4 at N = 50, D = 6); the seconds a child
#: may take there, and under ``--examples``
EXAMPLES_FULL = ("pendulum", "batched_study")
EXAMPLE_FITS = {"pendulum": (4, 120, 3), "batched_study": (4, 50, 6)}
EXAMPLE_TIMEOUT = 900
EXAMPLES_ALONE_TIMEOUT = 2100
#: every walkthrough, in ROADMAP's order (``--examples`` with no name)
EXAMPLES = ("four_tank", "car", "pendulum", "output_feedback", "quadrotor",
            "risk_audit", "adaptive", "dae_network", "batched_study")


def example_child(name, quick, out_path, device="cuda"):
    """Phase 20's child process: ``gpmpc_tpu_torch.examples.<name>``'s
    ``main(quick, device)`` (its own asserts are its self-checks) with the
    kernels' launch counts zeroed just before it; writes its wall seconds,
    its readings and the counts to ``out_path`` (JSON).  It runs at a
    lower host priority with one intra-op thread, so that the smoke's
    own phases beside it keep the host's cores."""
    import importlib
    from gpmpc_tpu_torch.ops import cuda_kernels as ck
    os.nice(10)
    torch.set_num_threads(1)
    mod = importlib.import_module(f"gpmpc_tpu_torch.examples.{name}")
    if torch.device(device).type == "cuda":
        ck.build_library()
        torch.cuda.synchronize()
    ck.reset_launches()
    t0 = time.perf_counter()
    readings = mod.main(quick=quick, device=device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    out = dict(name=name, quick=quick, wall=time.perf_counter() - t0,
               readings=readings, launches=dict(ck.LAUNCHES))
    with open(out_path, "w") as fh:
        json.dump(out, fh, default=float)
    return 0


def example_steps(name, quick, n, out_path, device="cuda"):
    """``--examples NAME --steps N``: for an example whose loops do not
    fit one call (four_tank, car, dae_network), its own data, fit and
    controller functions, then per controller a cold ``solve_step`` and
    ``n`` warm steps (each solve_step + plant step, host clock after a
    synchronize);
    writes ms per cold and warm step and the masked inner SQP steps a
    control step runs to ``out_path`` (JSON)."""
    import importlib
    from gpmpc_tpu_torch.ops import cuda_kernels as ck
    mod = importlib.import_module(f"gpmpc_tpu_torch.examples.{name}")
    dev = torch.device(device)
    dtype = torch.float32 if dev.type == "cuda" else torch.float64
    if dev.type == "cuda":
        ck.build_library()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    model = mod.build_model(dev, dtype)
    if name == "four_tank":
        X, Y, _, _ = mod.training_data(model, quick)
        gp = mod.fit(X, Y, dev, dtype)
        ctrls = [(m, mod.build_mpc(model, gp, m, p, quick))
                 for m, p in mod.METHODS]
        con_par = None
    elif name == "car":
        gp = mod.fit(*mod.training_data(model, quick))
        ctrls = [("EM", mod.build_mpc(model, gp, quick))]
        con_par = mod.OBSTACLES.ravel()
    elif name == "dae_network":
        gp = None
        ctrls = [("rk4", mod.build_mpc(model))]
        con_par = None
    else:
        raise ValueError(f"--steps times four_tank, car or dae_network, "
                         f"not {name}")
    out = dict(name=name, quick=quick, steps=n,
               n_evals=gp.n_evals if gp is not None else 0, controllers={})
    for tag, mpc in ctrls:
        x = torch.as_tensor(mod.X0, dtype=dtype, device=dev)
        sync()
        t0 = time.perf_counter()
        u, warm, _, _ = mpc.solve_step(x, mod.X_SP, con_par=con_par)
        x = model.integrate(x, u)
        sync()
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(n):
            u, warm, _, info = mpc.solve_step(x, mod.X_SP, warm=warm,
                                              u_prev=u, con_par=con_par)
            x = model.integrate(x, u)
        sync()
        warm_s = (time.perf_counter() - t0) / n
        cfg = mpc.sqp_cfg
        out["controllers"][tag] = dict(
            cold_ms=1e3 * cold, ms_per_step=1e3 * warm_s,
            inner_steps=cfg.al_iters * cfg.max_iters * mpc.cov_updates,
            cold_inner_steps=(mpc.init_sqp_cfg.al_iters
                              * mpc.init_sqp_cfg.max_iters
                              * mpc.cov_updates),
            finite=bool(torch.isfinite(x).all()))
        log(f"[examples] {name} {tag}: cold step {1e3 * cold:.1f} ms, "
            f"{1e3 * warm_s:.1f} ms per warm step over {n}")
    with open(out_path, "w") as fh:
        json.dump(out, fh, default=float)
    return 0


class ExampleChildren:
    """Walkthroughs in child processes, all started at once, each in its
    own working directory under ``build/examples/{quick,full,steps}/``
    (their figures and checkpoints land there) with its output in
    ``<name>.log`` there: each runs
    ``main`` (``--example-child``), or with ``steps`` times its
    controllers (``--example-steps``).  ``join`` waits for them (all
    within ``timeout`` s) and
    returns each one's exit code, wall and JSON; ``stop`` kills any still
    running."""

    def __init__(self, names, quick, steps=None, timeout=EXAMPLE_TIMEOUT):
        self.timeout = timeout
        mode = "quick" if quick else "full"
        self.out_dir = os.path.join(HERE, "build", "examples",
                                    mode if steps is None else "steps")
        self.t0 = time.perf_counter()
        self.procs = {}
        for name in names:
            cwd = os.path.join(self.out_dir, name)
            os.makedirs(cwd, exist_ok=True)
            out = os.path.join(cwd, "result.json")
            if os.path.exists(out):
                os.remove(out)
            argv = (["--example-child", name, mode, out] if steps is None
                    else ["--example-steps", name, mode, str(steps), out])
            with open(os.path.join(self.out_dir, f"{name}.log"), "w") as fh:
                self.procs[name] = subprocess.Popen(
                    [sys.executable, os.path.join(HERE, "chip_smoke.py"),
                     *argv], cwd=cwd, stdout=fh, stderr=subprocess.STDOUT)

    def join(self):
        done = {}
        for name, p in self.procs.items():
            left = self.timeout - (time.perf_counter() - self.t0)
            try:
                rc = p.wait(timeout=max(left, 1.0))
            except subprocess.TimeoutExpired:
                p.kill()
                rc = p.wait()
            res = None
            out = os.path.join(self.out_dir, name, "result.json")
            if rc == 0 and os.path.exists(out):
                with open(out) as fh:
                    res = json.load(fh)
            done[name] = dict(rc=rc, result=res,
                              wall=time.perf_counter() - self.t0)
        return done

    def log_tail(self, name, n=3000):
        with open(os.path.join(self.out_dir, f"{name}.log")) as fh:
            return fh.read()[-n:]

    def stop(self):
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


def example_self_checks(name, r):
    """The readings phase 20 holds for each full-settings walkthrough (the
    examples' own asserts, read back from their JSON)."""
    if name == "pendulum":
        return r["max_abs_u"] <= 5.0 + 1e-6 and r["final_err"] < 0.1
    if name == "batched_study":
        return (r["checkpoint_bitwise"] is True
                and np.isfinite(r["mean_cost"]) and r["gp_points"] >= 50)
    raise ValueError(name)


def example_fit_rows(gc, dev, card, name, launches):
    """K4 and K5 rows at a walkthrough's fit shape (EXAMPLE_FITS), with
    its child's launch counts."""
    p, n, d = EXAMPLE_FITS[name]
    x, ell, sf2, sn2 = gc.gram_inputs(n, d, p, 34, device=dev)
    err4 = gc.check_se_ard_gram(x, ell, sf2, sn2)
    k = gc.se_ard_gram(x, ell, sf2, sn2, 1e-6)
    a = gc.spd_inputs(n, p, 35, device=dev)
    err5 = gc.check_cholesky(a)
    return [
        timed_row(f"se_ard_gram[{name}]", "se_ard_gram", 78,
                  lambda: gc.se_ard_gram(x, ell, sf2, sn2, 1e-6),
                  lambda: gc.se_ard_gram_reference(x, ell, sf2, sn2, 1e-6),
                  bound(nbytes(x, ell, sf2, sn2, k),
                        p * n * n * (3 * d + 4)),
                  launches["se_ard_gram"], err4, card,
                  f"P={p}, N={n}, D={d}: the {name} example's fit"),
        timed_row(f"cholesky[{name}]", "cholesky", 206,
                  lambda: gc.cholesky(a), lambda: gc.cholesky_reference(a),
                  cholesky_bound(p, n), launches["cholesky"], err5, card,
                  f"P={p}, N={n}: the {name} example's fit",
                  library=lambda: torch.linalg.cholesky_ex(a))]


def examples_phase(gc, dev, card, children):
    """Phase 20: waits for the full-settings children; each exits 0 (its
    asserts held), its self-check readings hold and its K4 and K5 launches
    are its fit's evaluations + 1 and + 3 (one of each an evaluation, one
    K4 and three K5 for the posterior), no K1, K2 or K3; returns their
    kernel rows."""
    t_wait = time.perf_counter()
    done = children.join()
    waited = time.perf_counter() - t_wait
    rows = []
    for name, d in done.items():
        res = d["result"]
        if d["rc"] != 0 or res is None:
            log(f"[examples] {name} log:\n{children.log_tail(name)}")
            raise AssertionError(f"the {name} example exited {d['rc']}")
        r, got = res["readings"], res["launches"]
        n = r["n_evals"]
        expect = {"riccati_sweep": 0, "rk4_substeps": 0,
                  "se_ard_gram": n + 1, "cholesky": n + 3,
                  "gp_predict_batch": 0}
        for line in children.log_tail(name, 2000).splitlines():
            if line and not line.startswith(("[", " ")):
                log(f"[examples] {name}: {line}")
        log(f"[examples] {name} at full settings: {res['wall']:.1f} s "
            f"(its child {d['wall']:.1f} s after the start), "
            f"{r['ms_per_step']:.1f} ms per control step, readings {r}, "
            f"launches {got} ({n} fit evaluations) on {card}")
        if got != expect:
            raise AssertionError(f"{name}: launches {got} != {expect}")
        if not example_self_checks(name, r):
            raise AssertionError(f"{name}: self-checks fail: {r}")
        rows += example_fit_rows(gc, dev, card, name, got)
    log(f"[examples] phase 20: children started {t_wait - children.t0:.1f}"
        f" s before this phase, {waited:.1f} s waited here")
    return rows


def examples_alone(names, quick, steps):
    """``--examples [NAME ...] [--full] [--steps N]``: the named walkthroughs
    (all nine without a name) on the card, ``--quick`` unless ``--full``,
    each in a child, all at once; with ``--steps N`` (four_tank, car,
    dae_network)
    their controllers' cold and warm steps instead.  Prints each one's
    wall, ms per control step and readings; exits 1 if any failed."""
    card = card_line()
    log(f"[card] nvidia-smi: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    from gpmpc_tpu_torch.ops import cuda_kernels as ck
    t0 = time.perf_counter()
    ck.build_library()
    log(f"[build] {time.perf_counter() - t0:.2f} s")
    children = ExampleChildren(names or EXAMPLES, quick, steps,
                               timeout=EXAMPLES_ALONE_TIMEOUT)
    try:
        done = children.join()
    finally:
        children.stop()
    failed = []
    for name, d in done.items():
        res = d["result"]
        for line in children.log_tail(name, 4000).splitlines():
            log(f"[examples] {name}| {line}")
        if d["rc"] != 0 or res is None:
            failed.append(name)
            log(f"[examples] {name}: FAILED (exit {d['rc']}) after "
                f"{d['wall']:.1f} s")
            continue
        if steps is not None:
            log(f"[examples] {name} ({'quick' if quick else 'full'} sizes,"
                f" {steps} warm steps a controller): {res['controllers']} "
                f"on {card}")
            continue
        r = res["readings"]
        log(f"[examples] {name} ({'quick' if quick else 'full'}): wall "
            f"{res['wall']:.1f} s, {r.get('ms_per_step', float('nan')):.1f}"
            f" ms per control step, readings {r}, launches "
            f"{res['launches']} on {card}")
    print(card_line(), flush=True)
    print(json.dumps({"examples": {k: d["result"] for k, d in
                                   done.items()}}, default=float),
          flush=True)
    return 1 if failed else 0


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


def chain_cycles(ck, entry, x, u, h, dev):
    """The SM cycles of one rollout's substep chain by a chain-cycles C
    entry ``entry(x, u, out, cycles, n_sub, h, stream)`` (one thread
    between two clock64() reads, from before its loads to after its
    stores), min over 20 calls, at n_sub = 0, 10, 20 and 40."""
    out = torch.empty_like(x)
    cyc = torch.zeros(1, dtype=torch.int64, device=dev)
    c = {}
    for n_sub in (0, 10, 20, 40):
        reads = []
        for _ in range(20):
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream(dev).cuda_stream
                code = entry(x.data_ptr(), u.data_ptr(), out.data_ptr(),
                             cyc.data_ptr(), n_sub, float(h), stream)
            ck._raise_on_error("rk4_chain_cycles", code)
            reads.append(int(cyc.item()))
        c[n_sub] = min(reads)
    return c


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
    with SmiSampler() as smi:
        c = chain_cycles(ck, lambda *a: lib.gpmpc_rk4_chain_cycles_f32(0, *a),
                         x, u, DT / 10, dev)
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
           "k3": "gpmpc_gp_predict_batch_f32", "k4": "gpmpc_se_ard_gram_f32",
           "k1block": "gpmpc_riccati_sweep_block_f32"}


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
    other = ctypes.CDLL(str(so))
    fn = getattr(other, sym)
    fn.argtypes, fn.restype = getattr(repo, sym).argtypes, ctypes.c_int
    libs = {"other": SimpleNamespace(**{sym: fn}), "repo": repo}
    layouts = {"repo": ck.riccati_block_layout}
    if kernel == "k1block":
        # the other build's workspace follows its own layout
        other.gpmpc_riccati_block_layout.argtypes = [ctypes.c_int] * 2 + [
            ctypes.c_void_p]

        def other_layout(nx, nu):
            out = (ctypes.c_int * 4)()
            other.gpmpc_riccati_block_layout(nx, nu, out)
            return ck.BlockLayout(out[0], bool(out[1]), out[2], out[3])

        layouts["other"] = other_layout

    def through(name, call, *args):
        keep = ck._lib, ck.riccati_block_layout
        ck._lib = libs[name]
        ck.riccati_block_layout = layouts.get(name, keep[1])
        try:
            return call(*args)
        finally:
            ck._lib, ck.riccati_block_layout = keep

    if kernel == "k1":
        err = through("other", ck.check_riccati_sweep,
                      ck.stage_qp_inputs(20, 4, 2, 0, device=dev),
                      torch.tensor(1e-6, device=dev))
        shape = "(Nt,nx,nu)=(20,4,2)"
        k1_bitwise(ck, dev, through)

        def times(name):
            k1_times(ck, dev, card, sweep=lambda *a: through(
                name, ck.riccati_sweep, *a))
    elif kernel == "k1block":
        err = max(through("other", ck.check_riccati_sweep,
                          ck.stage_qp_inputs(nt, nx, nu, nt + nx, device=dev),
                          torch.tensor(1e-6, device=dev))
                  for _, nt, nx, nu, _ in K1_BLOCK_ROWS[:2])
        shape = "the network's (40, 20), Nt=20 and (40, 40), Nt=5"
        # both breakdowns in one call, where the other source carries the
        # stamps (a source from before them has none of its own)
        with open(other_src) as f:
            stamped = "GPMPC_RICCATI_STAMPS" in f.read()
        if stamped:
            k1_stamps(ck, dev, card, src=other_src, tag="other")
        else:
            log(f"[k1block other] {other_src} has no GPMPC_RICCATI_STAMPS: "
                f"no breakdown")
        k1_stamps(ck, dev, card)

        def times(name):
            k1_block_rows(ck, dev, card, {}, tag=name, sweep=lambda *a:
                          through(name, ck.riccati_sweep, *a))
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


def k1_bitwise(ck, dev, through):
    """--compare k1: at each pre-built (nx, nu) that the other build also
    instantiates, one problem at Nt = 20 and a batch of 64 at Nt = 70
    (across three chunks), the other build's outputs against the
    repository's, bitwise."""
    for nx, nu in ck.RICCATI_SHAPES:
        for nt, batch in ((20, None), (70, 64)):
            args = ck.stage_qp_inputs(nt, nx, nu, nt + nx, batch, device=dev)
            reg = torch.full(() if batch is None else (batch,), 1e-6,
                             device=dev)
            try:
                other = through("other", ck.riccati_sweep, *args, reg)
            except RuntimeError as e:
                log(f"[k1 other] ({nx}, {nu}): not in the other build ({e})")
                break
            repo = through("repo", ck.riccati_sweep, *args, reg)
            same = all(torch.equal(a, b) for a, b in zip(other, repo))
            log(f"[k1 other] ({nx}, {nu}), Nt={nt}, B={batch or 1}: outputs "
                f"{'bitwise equal' if same else 'DIFFER'} to the "
                f"repository's build")
            if not same:
                raise AssertionError(f"K1 ({nx}, {nu}) differs from the "
                                     f"other build")


def k1_alone(other_src=None):
    """Phase 3's K1 and K2 checks, phase 22 (b)'s block-path checks with
    the tile and panel edges, the block path's section breakdown
    (``k1_stamps``), and phase 11's K1 lines and block-path rows alone;
    with ``other_src``, ``compare("k1", other_src)``."""
    from gpmpc_tpu_torch.ops import cuda_kernels as ck
    from gpmpc_tpu_torch.systems import four_tank_ode

    if other_src is not None:
        return compare("k1", other_src)
    card = card_line()
    dev = torch.device("cuda")
    log(f"[card] nvidia-smi: {card}")
    kind = torch.cuda.get_device_name(0)
    ck.build_library()
    log_ptxas(ck)
    check_kernels(ck, four_tank_ode, dev)
    errs = k1_block_checks(ck, dev, edges=True)
    log(f"[K1 block] max|err| by pair {errs}")
    k1_stamps(ck, dev, card)
    k1_times(ck, dev, card)
    rows = k1_block_rows(ck, dev, card, {})
    print(card_line(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
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


# ------------------------------------------------------------ phase 21

#: phase 4's traced K2 errors at B = 1 (the paths' shape), by ODE
TRACED_ERRS = {}


def k2_id(model):
    """The ode_id of a fused model's K2 functor (its ``k2`` on the card)."""
    return model.k2.ode_id


def traced_odes(dev):
    """The ODEs that K2 traces in phases 4, 11 and 21: name -> (ODE, nx,
    nu, h, n_sub).  The four-tank plant as bench.py:460-462 and
    tests/test_pallas.py:47 build it (a lambda, no tag), the 1.3 kg
    quadrotor as phase 21 (b)'s plant builds it, the pendulum
    walkthrough's ODE (written for one point), a closure over a CUDA
    tensor and phase 22's network of NET_UNITS four-tank units (slices
    and a cat)."""
    from benchmarks.bench_spec import DT
    from gpmpc_tpu_torch.examples import pendulum
    from gpmpc_tpu_torch.systems import (QUAD_PARAMS, four_tank_ode,
                                         planar_quadrotor_ode)
    heavy = dict(QUAD_PARAMS, m=1.3)
    c = torch.tensor([1.0, 2.0, 3.0], device=dev)

    def closure(x, u):
        return torch.where(x > 1.0, torch.clamp(x * c, 0.1, 5.0) ** 2,
                           (1.0 - x) / 2.0 + u[..., 0:1])

    return {"four_tank": (lambda x, u: four_tank_ode(x, u), 4, 2, DT / 10,
                          10),
            "quadrotor": (lambda x, u: planar_quadrotor_ode(x, u, heavy), 6,
                          2, QUAD_DT / 4, 4),
            "pendulum": (pendulum.pendulum_ode, 2, 1, pendulum.DT / 10, 10),
            "closure": (closure, 3, 1, 0.05, 10),
            "network": (tank_network_ode(), 4 * NET_UNITS, 2 * NET_UNITS,
                        DT / 10, 10)}


def traced_inputs(name, batch, seed, dev):
    """K2 check inputs for a traced ODE: the four-tank's of
    ``cuda_kernels.rk4_inputs`` (a drained tank in a batch's first
    rollout), the quadrotor in its golden's box with thrusts in [2, 9],
    the pendulum over a swing, the closure across its branch, the network
    as the four-tank's with unit 0's fourth tank drained; f32 (n,) for
    one rollout when ``batch`` is None."""
    if name == "four_tank":
        from gpmpc_tpu_torch.ops import cuda_kernels as ck
        return ck.rk4_inputs(batch, seed, dev)
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    if name == "network":
        x = np.abs(rng.standard_normal(lead + (4 * NET_UNITS,))) * 4 + 0.5
        x[..., 3] = 0.0
        u = np.abs(rng.standard_normal(lead + (2 * NET_UNITS,))) * 3
        kw = dict(dtype=torch.float32, device=dev)
        return torch.tensor(x, **kw), torch.tensor(u, **kw)
    x, u = {"quadrotor": (rng.uniform(QUAD_X_LO, QUAD_X_HI, lead + (6,)),
                          rng.uniform(2.0, 9.0, lead + (2,))),
            "pendulum": (rng.uniform([-np.pi, -3.0], [np.pi, 3.0],
                                     lead + (2,)),
                         rng.uniform(-5.0, 5.0, lead + (1,))),
            "closure": (rng.uniform(-2.0, 2.5, lead + (3,)),
                        rng.uniform(-1.0, 1.0, lead + (1,)))}[name]
    kw = dict(dtype=torch.float32, device=dev)
    return torch.tensor(x, **kw), torch.tensor(u, **kw)


def build_traced_k2(ck, dev):
    """Phase 2's traced K2: each ODE of :func:`traced_odes` but the
    network traced and lowered, and every unit built at once (one nvcc
    each; the whole smoke runs this beside the main library's build).
    The network's unit, ~30 s of nvcc on the H100's host, is built by
    phase 22's child at its first launch, off the main process.  Returns
    the specs by name."""
    odes = traced_odes(dev)
    t0 = time.perf_counter()
    specs = {k: ck.register_ode(o, nx, nu, dev)
             for k, (o, nx, nu, _, _) in odes.items() if k != "network"}
    t_trace = time.perf_counter() - t0
    built = ck.prebuild(specs.values())
    log(f"[K2 traced] {len(specs)} ODEs traced and lowered in {t_trace:.2f} "
        f"s; {len(built)} units built at once (one nvcc each) in "
        f"{max(built.values(), default=0.0):.2f} s")
    for k, spec in specs.items():
        f = spec.functor
        log(f"[K2 traced] {k}: ode_id {spec.ode_id}, {f.name}, (nx, nu, NW) "
            f"= ({f.nx}, {f.nu}, {f.nw}), {f.n_prep} operations a rollout "
            f"(prep), {f.n_eval} an evaluation -> "
            f"{ck.K2_BUILDS[spec.ode_id]['path']}")
    for line in next(iter(ck.K2_BUILDS.values()))["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in \
                line:
            log(f"[K2 traced build] {line.strip()}")
    return specs


def build_beside(ck, fn):
    """``ck.build_library()`` in a thread (its nvcc processes) while
    ``fn()`` runs here; ``fn``'s result, or the build's error."""
    err = []

    def build():
        try:
            ck.build_library()
        except BaseException as e:              # re-raised below
            err.append(e)

    t = threading.Thread(target=build)
    t.start()
    try:
        return fn()
    finally:
        t.join()
        if err:
            raise err[0]


def check_traced_k2(ck, dev, specs):
    """Phase 4's traced K2: each unit of :func:`build_traced_k2` held
    against its plain version (over each rollout) at K2's card tolerance:
    the four-tank lambda at B = 1, 8 (n_sub = 7, the run-time loop, a
    drained tank) and 1024, also against the hand-written FourTank; the
    quadrotor at B = 1, 64 and 1024; the pendulum and the closure at B = 1
    and 64 (the network's in phase 22 (a))."""
    from gpmpc_tpu_torch.systems import four_tank_ode
    odes = traced_odes(dev)
    cases = ([("four_tank", b, n) for b, n in ((None, 10), (8, 7),
                                               (1024, 10))]
             + [("quadrotor", b, 4) for b in (None, 64, 1024)]
             + [(k, b, 10) for k in ("pendulum", "closure")
                for b in (None, 64)])
    for name, batch, n_sub in cases:
        ode, _, _, h, _ = odes[name]
        x, u = traced_inputs(name, batch, (batch or 1) + n_sub, dev)
        before = ck.K2_LAUNCHES.get(specs[name].ode_id, 0)
        err = ck.check_rk4_substeps(ode, x, u, h, n_sub, spec=specs[name])
        torch.cuda.synchronize()
        if ck.K2_LAUNCHES[specs[name].ode_id] != before + 1:
            raise AssertionError(f"traced K2 {name} did not launch once")
        extra = ""
        if name == "four_tank":
            hand = ck.rk4_substeps(four_tank_ode, x, u, h, n_sub)
            got = ck.rk4_substeps(ode, x, u, h, n_sub, spec=specs[name])
            gap = float((got - hand).abs().max())
            rel = float(((got - hand).abs() / hand.abs().clamp(
                min=1e-6)).max())
            extra = (f"; against the hand-written FourTank max|diff| "
                     f"{gap:.3e} (relative {rel:.3e})")
        log(f"[K2 traced] {name} batch={batch or 1}, n_sub={n_sub}, h={h:g} "
            f"max|err| {err:.3e} against its plain version (rtol 1e-5, "
            f"atol 1e-6){extra}")
        if batch is None:
            TRACED_ERRS[name] = err


def traced_k2_phase(ck, dev, card, xs_np):
    """Phase 21: (a) the main path as the JAX package builds it
    (bench.py:457-480: the plant ``Model(ode=lambda x, u: four_tank_ode(x,
    u), fused_integrator=True, integrator_substeps=10)``), N_STEPS RTI
    steps through ``MPC.solve``: exact launches (K1 4 and the traced K2 1
    a step), finite, each next state within phase 5's replay bounds of
    phase 5's trajectory (the hand-written FourTank's; relative 1e-2 in
    the first TRANSIENT_STEPS steps, 1e-3 after); (b) the quadrotor's
    hybrid mismatch as phase 16 (c) runs it with the plant fused (its
    lambda traced): the residual data through vmap(plant.integrate) (one
    K2 launch), the fit, QUAD_STEPS steps (one K2 launch a step), every
    step replayed on the CPU under phase 16 (c)'s bounds.  Returns the
    traced K2 launches of (a) and of (b), and (b)'s GP (phase 16 (c) takes
    it in the whole smoke)."""
    from benchmarks.bench_spec import DT, MODEL_R, X0, XSP
    from gpmpc_tpu_torch import Model
    from gpmpc_tpu_torch.systems import four_tank_ode
    t_phase = time.perf_counter()
    plant = Model(Nx=4, Nu=2, ode=lambda x, u: four_tank_ode(x, u), dt=DT,
                  R=MODEL_R, clip_negative=True, integrator_substeps=10,
                  fused_integrator=True, device=dev, dtype=torch.float32)
    mpc = build_slice(dev, RTI, model=plant)
    ck.reset_launches()
    t0 = time.perf_counter()
    xs, us = mpc.solve(X0, N_STEPS * DT, XSP, noise=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, k2 = dict(ck.LAUNCHES), dict(ck.K2_LAUNCHES)
    expect = {"riccati_sweep": N_STEPS * RTI["al_iters"] * RTI["max_iters"],
              "rk4_substeps": N_STEPS, "se_ard_gram": 0, "cholesky": 0,
              "gp_predict_batch": 0}
    traced = k2_id(plant)
    log(f"[traced K2] (a) the main path as the JAX package builds it (the "
        f"plant's ODE a lambda, traced: ode_id {traced}), {N_STEPS} RTI "
        f"steps: {wall:.3f} s; launches {launches}, K2 by functor {k2}")
    if launches != expect or k2 != {traced: N_STEPS}:
        raise AssertionError(f"traced main path launches {launches}, {k2} "
                             f"!= {expect}, all K2 on {traced}")
    xa = xs.cpu().numpy()
    if xa.shape != (N_STEPS + 1, 4) or not np.all(np.isfinite(xa)):
        raise AssertionError("traced main path: non-finite or misshapen")
    worst = [(0.0, 0), (0.0, 0)]
    for k in range(N_STEPS):
        rel = float(np.max(np.abs(xa[k + 1] - xs_np[k + 1])
                           / np.abs(xs_np[k + 1])))
        worst[int(k >= TRANSIENT_STEPS)] = max(worst[int(
            k >= TRANSIENT_STEPS)], (rel, k))
    # the plants alone on (a)'s own states and inputs
    xt = torch.as_tensor(xa[:-1], device=dev)
    ut = us.to(dev)
    hand = build_plant(dev).integrate(xt, ut)
    gap = float((plant.integrate(xt, ut) - hand).abs().max())
    log(f"[traced K2] (a) next state against phase 5's loop (the "
        f"hand-written FourTank): max relative difference {worst[0][0]:.3e} "
        f"at step {worst[0][1]} in the transient (<= 1e-2), "
        f"{worst[1][0]:.3e} at step {worst[1][1]} after it (<= 1e-3); the "
        f"two plants alone on (a)'s states and inputs: max|diff| {gap:.3e}; "
        f"final state {xa[-1].tolist()} on {card}")
    if worst[0][0] > 1e-2 or worst[1][0] > 1e-3:
        raise AssertionError("the traced main path left phase 5's bounds")
    _, (data_k2, loop_k2), gp = quad_phase(ck, dev, card, fused=True)
    log(f"[traced K2] phase 21: {time.perf_counter() - t_phase:.1f} s")
    return {"four_tank": N_STEPS, "quadrotor": data_k2 + loop_k2}, gp


def traced_k2_times(ck, dev, card, specs):
    """Phase 11's traced K2 lines, after the hand-written FourTank's
    (:func:`k2_times`, :func:`k2_chain_cycles`) in the same call: each
    traced functor's event ms over 200 calls, device ms per launch
    (mean/median over 200) and its plain version's ms beside the bound,
    the four-tank and the quadrotor at K2_TIME_BATCHES and the pendulum,
    the closure and (where ``specs`` has it) the network at B = 1; the
    chain's SM cycles of the traced
    four-tank and quadrotor.  Returns {name: row numbers at B = 1}."""
    odes = traced_odes(dev)
    rows = {}
    with SmiSampler() as smi:
        for name in ("four_tank", "quadrotor", "pendulum", "closure",
                     "network"):
            if name not in specs:
                continue
            ode, nx, nu, h, n_sub = odes[name]
            spec = specs[name]
            f = spec.functor
            for bsz in (K2_TIME_BATCHES if name in ("four_tank", "quadrotor")
                        else (1,)):
                x, u = traced_inputs(name, None if bsz == 1 else bsz, bsz,
                                     dev)
                out = ck.rk4_substeps(ode, x, u, h, n_sub, spec=spec)

                def call():
                    ck.rk4_substeps(ode, x, u, h, n_sub, spec=spec)

                # a substep: 4 evaluations, and the plain-order stage
                # combination (csrc/rk4_chain.h rk4_step_plain), 13
                # operations a state as in the FourTank rows; prep once
                bd = bound(nbytes(x, u, out),
                           bsz * (f.n_prep + n_sub * (4 * f.n_eval
                                                      + 13 * nx)))
                ms = cuda_time_ms(call, reps=200)
                dev_ms = launch_ms(call, 200)
                plain = cuda_time_ms(lambda: ck.rk4_substeps_rollouts(
                    ode, x, u, h, n_sub), reps=20)
                log(f"[K2 traced time] {name} B={bsz}, n_sub={n_sub}: event "
                    f"{ms:.4f} ms (200 calls); device per launch mean/median "
                    f"{fmt_pair(dev_ms)}; plain {plain:.4f} ms; bound "
                    f"{bd[0]:.3e} ms ({bd[1]}) on {card}")
                if bsz == 1:
                    rows[name] = dict(ms=ms, device_ms=dev_ms[0],
                                      plain_ms=plain, bound=bd)
        for name in ("four_tank", "quadrotor"):
            lib = ck.K2_BUILDS[specs[name].ode_id]["lib"]
            x, u = traced_inputs(name, None, 1, dev)
            c = chain_cycles(ck, lib.gpmpc_rk4_traced_chain_cycles_f32, x, u,
                             odes[name][3], dev)
            rows[name]["chain_cycles"] = c[10]
            log(f"[K2 traced chain] {name}: one thread, clock64 from before "
                f"the loads to after the stores, min of 20: n_sub=0 {c[0]}, "
                f"10 (compiled-in) {c[10]}, 20 {c[20]}, 40 {c[40]} cycles: "
                f"{(c[10] - c[0]) / 40:.1f} cycles an evaluation at n_sub=10,"
                f" {(c[40] - c[20]) / 80:.1f} in the run-time loop, on "
                f"{card}")
    log(f"[K2 traced time] nvidia-smi over the window: {smi.summary()}")
    return rows


def traced_k2_rows(specs, launches, times):
    """The JSON rows of the traced K2 on its paths, at B = 1: phase 21's
    four-tank (a) and quadrotor (b) and, in the whole smoke, phase 22's
    network (``launches`` by name)."""
    return [{"name": f"rk4_substeps[traced,{name}]", "route": "cuda",
             "source": "gpmpc_tpu_torch/csrc/rk4_substeps.cu",
             "generated_by": "gpmpc_tpu_torch/ops/ode_trace.py",
             "functor": specs[name].functor.name,
             "replaces": "gpmpc_tpu/ops/pallas_kernels.py:233",
             "launches": launches[name], "max_abs_err": TRACED_ERRS[name],
             "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
             "device_ms": times[name]["device_ms"],
             "bound_ms": times[name]["bound"][0],
             "bound_by": times[name]["bound"][1], "library_ms": None,
             "chain_cycles": times[name].get("chain_cycles")}
            for name in launches]


def traced_k2_alone():
    """Phases 1-2, phase 4's traced K2, phase 5's loop (the trajectory
    phase 21 (a) is held against), phase 21 and phase 11's K2 lines and
    traced K2 rows, alone."""
    from benchmarks.bench_spec import DT, X0, XSP
    from gpmpc_tpu_torch.ops import cuda_kernels as ck
    from gpmpc_tpu_torch.systems import four_tank_ode
    card = card_line()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    log(f"[card] nvidia-smi: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    specs = build_beside(ck, lambda: build_traced_k2(ck, dev))
    log(f"[build] {time.perf_counter() - t0:.2f} s (the traced units' "
        f"included)")
    check_traced_k2(ck, dev, specs)
    xs, _ = build_slice(dev, RTI).solve(X0, N_STEPS * DT, XSP, noise=False)
    launches, _ = traced_k2_phase(ck, dev, card, xs.cpu().numpy())
    k2_times(ck, four_tank_ode, dev, card)
    k2_chain_cycles(ck, dev, card)
    rows = traced_k2_rows(specs, launches, traced_k2_times(ck, dev, card,
                                                           specs))
    print(card_line(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ------------------------------------------------------------ phase 22

#: phase 22: NET_UNITS four-tank units side by side (nx = 40, nu = 20),
#: each unit phase 16 (a)'s tank_mhe_ofb configuration with small
#: numpy-seeded offsets (NET_SEED) to its start, prior and setpoint, and a
#: dense off-block state weight; the MPC's horizon, and NET_STEPS steps of
#: the output-feedback loop
NET_UNITS = 10
NET_NT = 20
NET_STEPS = 6
NET_SEED = 22
#: per unit: phase 16 (a)'s state weight
NET_Q_UNIT = np.array([10.0, 10.0, 0.1, 0.1])
#: phase 22 (b): K1's block path against its plain version at these (nx,
#: nu) (past each lane limit, the network's MPC and MHE, a pair whose
#: working set passes shared memory), batches and horizons
K1_BLOCK_SHAPES = ((31, 2), (4, 33), (40, 20), (40, 40), (96, 48))
K1_BLOCK_BATCHES = (None, 64)
K1_BLOCK_NTS = (3, 20, 33)
#: ``--k1`` also: the block kernel's tile and panel edges (nu on both sides
#: of one and two 32-column panels; nx on both sides of the warp kernel's
#: lane limit, of 32 and of 64) and a pair of each layout no other pair
#: takes -- one stage buffer beside a shared working set (52, 52), one
#: beside a working set in the workspace (130, 5), a stage past shared
#: memory, in the workspace too (200, 3) -- at Nt = 3, B = 1 and 64,
#: outside phase 22 for the smoke's time (the plain version takes seconds
#: a call at nu 64)
K1_EDGE_SHAPES = tuple((nx, nu) for nx in (31, 32, 63, 64, 65)
                       for nu in (32, 33, 64, 65)) + ((52, 52), (130, 5),
                                                      (200, 3))
#: seconds a phase's child process may take from its start to its join (on
#: an H100: phase 21 ~70 s, phases 12-13 ~3 min, phase 15 ~3 min, phase
#: 22 ~6 min, each beside the main process's phases)
PHASE_CHILD_TIMEOUT = 900


def tank_network_ode(units=NET_UNITS):
    """``units`` four-tank processes side by side: ``four_tank_ode`` of
    unit i on x[4i:4i+4] and u[2i:2i+2], concatenated (a lambda, so K2
    traces it into a functor of its own)."""
    from gpmpc_tpu_torch.systems import four_tank_ode
    return lambda x, u: torch.cat(
        [four_tank_ode(x[..., 4 * i:4 * i + 4], u[..., 2 * i:2 * i + 2])
         for i in range(units)], dim=-1)


def tank_network_setup(units=NET_UNITS):
    """Each unit's start, prior and setpoint (phase 16 (a)'s plus offsets
    uniform in +-0.4, half of them on the setpoint; numpy, NET_SEED), the
    state weight kron(I, diag(NET_Q_UNIT)) + 0.1 mean(NET_Q_UNIT) 11'/nx
    (positive definite and dense, so that K1's matrices are full) and the
    measurement matrix (each unit's two lower levels)."""
    rng = np.random.default_rng(NET_SEED)
    off = rng.uniform(-0.4, 0.4, (units, 4))
    nx = 4 * units
    q = (np.kron(np.eye(units), np.diag(NET_Q_UNIT))
         + 0.1 * NET_Q_UNIT.mean() * np.ones((nx, nx)) / nx)
    c = np.zeros((2 * units, nx))
    for i in range(units):
        c[2 * i, 4 * i] = c[2 * i + 1, 4 * i + 1] = 1.0
    return ((OFB_X0 + off).ravel(), (OFB_XBAR + off).ravel(),
            (OFB_XSP + 0.5 * off).ravel(), q, c)


def build_tank_network(dev, units=NET_UNITS):
    """Phase 22's plant, estimator and controller on ``dev``, f32: the
    network's fused plant (K2 traced, 10 substeps, R = 1e-3 I), the MHE
    (window 4, each unit's lower two levels measured, rk4 dynamics, the
    filtered arrival cost, levels >= 0; OFB_MHE_OPTS: K1 at (nx, nx)) and
    the rk4 MPC (no GP, Nt = NET_NT, R = 0.01 I, phase 16 (a)'s bounds per
    unit; the main path's RTI budget after OFB_MPC_INIT: K1 at (nx,
    nu))."""
    from gpmpc_tpu_torch import MHE, MPC, Model
    nx, nu = 4 * units, 2 * units
    _, _, _, q, c = tank_network_setup(units)
    model = Model(Nx=nx, Nu=nu, ode=tank_network_ode(units), dt=3.0,
                  R=np.diag([1e-3] * nx), clip_negative=True,
                  integrator_substeps=10, fused_integrator=True, device=dev,
                  dtype=torch.float32)
    ct = torch.tensor(c, dtype=torch.float32, device=dev)
    mhe = MHE(model, window=4, Q_noise=model.R,
              R_meas=np.diag([2.5e-3] * 2 * units),
              P_arrival=np.diag([0.5] * nx), h=lambda x: ct @ x,
              xlb=[0.0] * nx, discrete_method="rk4", arrival_update=True,
              solver_opts=OFB_MHE_OPTS)
    mpc = MPC(horizon=NET_NT * 3.0, model=model, gp=None, gp_method="ME",
              discrete_method="rk4", Q=q, R=0.01 * np.eye(nu),
              ulb=[0.0] * nu, uub=[8.0] * nu,
              xlb=[0.5, 0.5, 0.1, 0.1] * units,
              xub=[14.0, 25.0, 8.0, 8.0] * units, feedback=False,
              percentile=None, cov_updates=1, solver_opts=RTI,
              init_solver_opts=OFB_MPC_INIT, device=dev)
    return mhe, mpc


def network_loop(ck, dev, card):
    """Phase 22 (a): simulate_output_feedback of the network on the card,
    NET_STEPS steps with phase 16 (a)'s noise draws at its widths: K1 at
    (40, 40) al x mi a MHE step and at (40, 20) in the cold start and al x
    mi a control step, both on the block path, the traced K2 once a step,
    exactly; finite states and estimates; every step's MHE window and MPC
    solve replayed on the CPU in f32 from the card's inputs (phase 16
    (a)'s bounds: estimate and next state within rtol 1e-2 over the first
    TRANSIENT_STEPS steps, 1e-3 after); the estimate error per step; ms
    per MHE and per MPC step by CUDA events.  Returns its record."""
    from gpmpc_tpu_torch import simulate_output_feedback
    nx, nu = 4 * NET_UNITS, 2 * NET_UNITS
    x0, x_bar, x_sp, _, _ = tank_network_setup()
    t0 = time.perf_counter()
    mhe, mpc = build_tank_network(dev)
    t_build = time.perf_counter() - t0
    paths = {p: ck.riccati_path(*p) for p in ((nx, nx), (nx, nu))}
    log(f"[network] {NET_UNITS} four-tank units (nx={nx}, nu={nu}) built in "
        f"{t_build:.2f} s (the ODE traced for K2: ode_id "
        f"{k2_id(mpc.model)}); K1 paths {paths}; block layouts "
        f"{[tuple(ck.riccati_block_layout(*p)) for p in paths]}")
    if set(paths.values()) != {"block"}:
        raise AssertionError("the network's K1 pairs are not on the block "
                             "path")
    # the traced K2 against its plain version (its first launch builds its
    # unit) at one rollout and 64
    _, _, _, h, n_sub = traced_odes(dev)["network"]
    k2_err = None
    for batch in (None, 64):
        x, u = traced_inputs("network", batch, (batch or 1) + n_sub, dev)
        err = ck.check_rk4_substeps(mpc.model.ode, x, u, h, n_sub,
                                    spec=mpc.model.k2)
        k2_err = err if k2_err is None else k2_err
        log(f"[network] traced K2 batch={batch or 1}, n_sub={n_sub} "
            f"max|err| {err:.3e} against its plain version (rtol 1e-5, "
            f"atol 1e-6)")
    build = ck.K2_BUILDS.get(k2_id(mpc.model))
    if build is not None:
        log(f"[network] traced K2 unit built at its first launch in "
            f"{build['seconds']:.2f} s -> {build['path']}")
    mrec = CallRecorder(mhe, "_step")
    prec = CallRecorder(mpc, "_solve_step")
    rng = np.random.default_rng(23)
    noise_w = 0.01 * rng.standard_normal((NET_STEPS, nx))
    noise_v = 0.05 * rng.standard_normal((NET_STEPS, nu))
    ck.reset_launches()
    t0 = time.perf_counter()
    res = simulate_output_feedback(mpc, mhe, x0, x_bar, NET_STEPS * mpc.dt,
                                   x_sp, noise_w=noise_w, noise_v=noise_v)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, by_shape = dict(ck.LAUNCHES), dict(ck.RICCATI_LAUNCHES)
    k2 = dict(ck.K2_LAUNCHES)
    m_cfg, cfg, init = mhe.sqp_cfg, mpc.sqp_cfg, mpc.init_sqp_cfg
    expect = {(nx, nx): NET_STEPS * m_cfg.al_iters * m_cfg.max_iters,
              (nx, nu): init.al_iters * init.max_iters
              + NET_STEPS * cfg.al_iters * cfg.max_iters}
    expect_k2 = {k2_id(mpc.model): NET_STEPS}
    log(f"[network] (a) output-feedback loop, {NET_STEPS} steps (MHE window "
        f"{mhe.M} al{m_cfg.al_iters} x mi{m_cfg.max_iters}, MPC Nt={mpc.Nt} "
        f"RTI after an al{init.al_iters} x mi{init.max_iters} cold start, "
        f"fused plant, f32): {wall:.3f} s; K1 launches by (nx, nu) "
        f"{by_shape}, expected {expect}; K2 by functor {k2}, expected "
        f"{expect_k2}; all launches {launches}")
    if by_shape != expect or k2 != expect_k2 or launches[
            "riccati_sweep"] != sum(expect.values()):
        raise AssertionError("the network's launch counts are off")
    if not all(np.all(np.isfinite(v)) for v in (res.x_true, res.x_hat,
                                                  res.u)):
        raise AssertionError("non-finite network loop")
    err = np.linalg.norm(res.x_hat - res.x_true[:-1], axis=1)
    m_ms, p_ms = mrec.ms(), prec.ms()
    lower = res.x_true[-1].reshape(NET_UNITS, 4)[:, :2]
    miss = float(np.abs(lower - x_sp.reshape(NET_UNITS, 4)[:, :2]).max())
    log(f"[network] (a) |x_hat - x| per step {np.round(err, 5).tolist()}; "
        f"lower tanks' largest distance to their setpoint after "
        f"{NET_STEPS} steps {miss:.4f}; MHE converged "
        f"{int(res.mhe_converged.sum())}/{NET_STEPS}, MPC "
        f"{int(res.mpc_converged.sum())}/{NET_STEPS}; ms per MHE step (CUDA "
        f"events) mean {np.mean(m_ms):.3f}, median {np.median(m_ms):.3f}; "
        f"per MPC step mean {np.mean(p_ms):.3f}, median "
        f"{np.median(p_ms):.3f} on {card}")
    if not np.all(np.isfinite(err)):
        raise AssertionError("non-finite estimate error")
    t0 = time.perf_counter()
    cpu_mhe, cpu_mpc = build_tank_network(torch.device("cpu"))
    cpu_mhe.consts, cpu_mpc.consts = to_cpu(mhe.consts), to_cpu(mpc.consts)
    sigma0 = torch.zeros(nx, nx)
    worst = [[0.0, 0.0], [0.0, 0.0]]          # [estimate, next state]
    for k in range(NET_STEPS):
        state, y, u_prev = mrec.calls[k]
        _, (x_hat_c, _) = cpu_mhe._step(to_cpu(state), y.cpu(),
                                        u_prev.cpu())
        rel_hat = float(((mrec.outs[k][1][0].cpu() - x_hat_c).abs()
                         / x_hat_c.abs()).max())
        warm, x_hat, ref, u_prev, _, con_par, _ = prec.calls[k]
        _, u_c, _, _ = cpu_mpc._solve_step(
            to_cpu(warm), x_hat.cpu(), ref.cpu(), u_prev.cpu(), sigma0,
            con_par.cpu(), cpu_mpc.consts)
        u_c = cpu_mpc._saturate(u_c, u_prev.cpu(), cpu_mpc.consts)
        x_c = torch.clamp(cpu_mpc.model.integrate(
            torch.tensor(res.x_true[k]), u_c)
            + torch.tensor(noise_w[k], dtype=torch.float32), min=0.0)
        rel = float((torch.tensor(res.x_true[k + 1]) - x_c).abs().div(
            x_c.abs()).max())
        phase = int(k >= TRANSIENT_STEPS)
        worst[phase] = [max(worst[phase][0], rel_hat),
                        max(worst[phase][1], rel)]
    log(f"[network] (a) every step replayed on the CPU in f32 (plain "
        f"versions) from the card's inputs ({time.perf_counter() - t0:.1f} "
        f"s): max relative difference of the estimate / the next state "
        f"{worst[0][0]:.3e} / {worst[0][1]:.3e} in the first "
        f"{TRANSIENT_STEPS} steps (rtol 1e-2), {worst[1][0]:.3e} / "
        f"{worst[1][1]:.3e} after (rtol 1e-3)")
    if max(worst[0]) > 1e-2 or max(worst[1]) > 1e-3:
        raise AssertionError("card and CPU network steps disagree")
    return dict(launches={f"{a},{b}": n for (a, b), n in by_shape.items()},
                k2=sum(k2.values()), k2_err=k2_err, wall=wall,
                est_err=err.tolist(),
                mhe_ms=float(np.median(m_ms)), mpc_ms=float(np.median(p_ms)),
                replay=worst)


def k1_block_checks(ck, dev, edges=False):
    """Phase 22 (b) and ``--k1``: K1's block path against its plain
    version (``cuda_kernels.riccati_check_tolerances``) at K1_BLOCK_SHAPES
    x K1_BLOCK_BATCHES x K1_BLOCK_NTS (with ``edges`` also K1_EDGE_SHAPES
    at Nt = 3), a batch through the vmap rule, one launch each on the
    block path and no library of its own, a repeated launch bitwise the
    same; an indefinite and a zero H_uu pivot at each pair (non-finite
    gains); the layout the built kernel takes against
    ``riccati_block_layout``.  Returns {"nx,nu": max abs error over the
    pair's checks}."""
    import ctypes
    lib = ck.build_library()
    out = (ctypes.c_int * 4)()
    for nx in range(1, 130, 3):
        for nu in (1, 2, 7, 20, 33, 48, nx):
            lib.gpmpc_riccati_block_layout(nx, nu, out)
            if (out[0], bool(out[1]), out[2], out[3]) != tuple(
                    ck.riccati_block_layout(nx, nu)):
                raise AssertionError(f"K1 block layout at ({nx}, {nu}): the "
                                     f"kernel's {list(out)} != the mirror's")
    log("[K1 block] the kernel's layout equals riccati_block_layout at 301 "
        "pairs")
    errs = {}
    grid = [(pair, K1_BLOCK_NTS) for pair in K1_BLOCK_SHAPES]
    if edges:
        grid += [(pair, (3,)) for pair in K1_EDGE_SHAPES]
    for (nx, nu), nts in grid:
        if ck.riccati_path(nx, nu) != "block":
            raise AssertionError(f"({nx}, {nu}) is not on the block path")
        t0 = time.perf_counter()
        line = []
        for batch in K1_BLOCK_BATCHES:
            for nt in nts:
                args = ck.stage_qp_inputs(nt, nx, nu, nt + nx + nu, batch,
                                          device=dev)
                reg = torch.full(() if batch is None else (batch,), 1e-6,
                                 device=dev)
                ck.reset_launches()
                err = ck.check_riccati_sweep(args, reg,
                                             vmapped=batch is not None)
                torch.cuda.synchronize()
                if ck.RICCATI_LAUNCHES != {(nx, nu): 1} or (
                        nx, nu) in ck.RICCATI_BUILDS:
                    raise AssertionError(f"K1 ({nx}, {nu}) did not launch "
                                         f"once on the block path")
                if not all(torch.equal(a, b) for a, b in zip(
                        ck.riccati_sweep(*args, reg),
                        ck.riccati_sweep(*args, reg))):
                    raise AssertionError(f"K1 ({nx}, {nu}) does not repeat "
                                         f"bitwise")
                errs[f"{nx},{nu}"] = max(errs.get(f"{nx},{nu}", 0.0), err)
                line.append(f"B={batch or 1} Nt={nt} {err:.2e}")
        for kind in ("indefinite", "zero"):
            ck.check_riccati_sweep_bad_pivot(
                kind, device=dev, shape=(min(nts[-1], 8), nx, nu))
        torch.cuda.synchronize()
        log(f"[K1 block] ({nx}, {nu}) {tuple(ck.riccati_block_layout(nx, nu))}"
            f": max|err| against the plain version {'; '.join(line)} (B=64 "
            f"through the vmap rule; tolerances riccati_check_tolerances; "
            f"repeats bitwise); an indefinite and a zero pivot -> "
            f"non-finite gains "
            f"({time.perf_counter() - t0:.1f} s)")
    return errs


def network_phase(ck, dev, card):
    """Phase 22: (a) the network's loop, (b) K1's block-path checks."""
    t0 = time.perf_counter()
    rec = network_loop(ck, dev, card)
    rec["errs"] = k1_block_checks(ck, dev)
    log(f"[network] phase 22: {time.perf_counter() - t0:.1f} s")
    return rec


BLOCK_SRC = "gpmpc_tpu_torch/csrc/riccati_sweep_block.cu"
#: phase 11's block-path rows: (name, Nt, nx, nu, B), the network's (40,
#: 20) (Nt = 20, B = 1 and 64) and (40, 40) (the MHE's Nt = 5), and (96,
#: 48) past shared memory (Nt = 3: the plain version takes ~10 s a call at
#: Nt = 20, where only ``--compare k1block`` times it)
K1_BLOCK_ROWS = (("network_mpc", NET_NT, 40, 20, 1),
                 ("network_mhe", 5, 40, 40, 1), ("B64", NET_NT, 40, 20, 64),
                 ("workspace", 3, 96, 48, 1))


def k1_block_rows(ck, dev, card, launches, tag="repo", sweep=None):
    """Phase 11's block-path rows at K1_BLOCK_ROWS: each held against its
    plain version here, event ms over 200 calls, device ms per launch over
    200, the plain version's ms over one call after one (it unrolls the nu
    x nu Cholesky op by op, one launch an op: on an H100 ~0.8-1.8 s a call
    at these shapes), the bound and the one-SM floor; ``launches`` by
    "nx,nu" from phase 22 (a) (none at B = 64 or (96, 48)).  With
    ``sweep`` (another build of the block path, for ``--compare
    k1block``) it times that, without the check or the plain version, at
    K1_BLOCK_ROWS and (96, 48) with Nt = 20, and nvidia-smi's clocks over
    the window."""
    rows = []
    shapes = K1_BLOCK_ROWS + ((("workspace", NET_NT, 96, 48, 1),)
                              if sweep else ())
    call = sweep or ck.riccati_sweep
    with SmiSampler() as smi:
        for name, nt, nx, nu, bsz in shapes:
            batch = None if bsz == 1 else bsz
            q = ck.stage_qp_inputs(nt, nx, nu, nt + nx, batch, device=dev)
            reg = torch.full(() if batch is None else (batch,), 1e-6,
                             device=dev)
            err = None if sweep else ck.check_riccati_sweep(q, reg)
            out = call(*q, reg)
            ms = cuda_time_ms(lambda: call(*q, reg), reps=200)
            dev_ms, _, note = device_time_ms(lambda: call(*q, reg))
            plain = None if sweep else cuda_time_ms(
                lambda: ck.riccati_sweep_reference(*q, reg), reps=1,
                warmup=1)
            flops = riccati_flops(nt, nx, nu)
            bd = bound(nbytes(*q, reg, *out), bsz * flops)
            # a block a problem runs on one SM: its share of the f32 peak
            floor = flops / (F32_FLOPS / H100_SMS) * 1e3
            n = launches.get(f"{nx},{nu}", 0) if bsz == 1 and nx == 40 else 0
            log(f"[time {tag}] riccati_sweep block path ({nx}, {nu}) at "
                f"Nt={nt}, B={bsz}: kernel {ms:.4f} ms, device "
                f"{fmt_ms(dev_ms)}{note} per launch, plain "
                f"{'not timed' if plain is None else f'{plain:.4f} ms'}, "
                f"bound {bd[0]:.3e} ms ({bd[1]}), one-SM floor {floor:.4f} "
                f"ms; {n} launches on its path; max|err| "
                f"{'not checked' if err is None else f'{err:.3e}'}; layout "
                f"{tuple(ck.riccati_block_layout(nx, nu))} on {card}")
            rows.append({"name": f"riccati_sweep[block,{nx},{nu},{name}]",
                         "route": "cuda", "source": BLOCK_SRC,
                         "replaces": "gpmpc_tpu/ops/pallas_kernels.py:394",
                         "launches": n, "max_abs_err": err, "ms": ms,
                         "plain_ms": plain, "device_ms": dev_ms,
                         "bound_ms": bd[0], "bound_by": bd[1],
                         "one_sm_floor_ms": floor, "library_ms": None})
    log(f"[time {tag}] nvidia-smi over the block rows: {smi.summary()}")
    return rows


#: ``--k1``'s section breakdown of the block path: (name, Nt, nx, nu) at
#: B = 1, the network's MPC and MHE
K1_STAMP_SHAPES = (("network_mpc", NET_NT, 40, 20), ("network_mhe", 5, 40, 40))
#: the sections the kernel's clock64 stamps split a launch into
K1_SECTIONS = ("stage copy", "products", "Cholesky", "solves",
               "value update + decrease", "rollout")


def sm_clock_mhz():
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return float(out.stdout.strip().splitlines()[0])


def k1_stamps(ck, dev, card, src=None, tag="repo", reps=50):
    """``--k1``'s breakdown of the block path by section: ``src`` (the
    repository's ``csrc/riccati_sweep_block.cu`` by default) built with
    ``GPMPC_RICCATI_STAMPS`` into a library of its own, launched ``reps``
    times at each of K1_STAMP_SHAPES; thread 0 of problem 0 sums the SM
    cycles of each section (clock64), printed per launch and per stage
    beside the SM clock nvidia-smi reads right after and the stamped
    build's event ms.  Returns {name: {section: cycles a launch}}."""
    import ctypes
    from types import SimpleNamespace
    src = src or str(ck.CSRC / "riccati_sweep_block.cu")
    so = ck.BUILD_DIR / "k1_stamps" / f"libgpmpc_riccati_block_stamps_{tag}.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    build = subprocess.run([ck._nvcc(), *ck.NVCC_FLAGS,
                            "-DGPMPC_RICCATI_STAMPS", "-shared", "-o",
                            str(so), src], capture_output=True, text=True)
    if build.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} with the stamps:\n"
                           f"{build.stdout}{build.stderr}")
    for line in (build.stdout + build.stderr).splitlines():
        if "registers" in line or "spill" in line:
            log(f"[K1 stamps {tag}] {line.strip()}")
    lib = ctypes.CDLL(str(so))
    repo = ck.build_library()
    fn = lib.gpmpc_riccati_sweep_block_f32
    fn.argtypes = repo.gpmpc_riccati_sweep_block_f32.argtypes
    fn.restype = ctypes.c_int
    lib.gpmpc_riccati_block_stamps.argtypes = [ctypes.c_void_p]
    lib.gpmpc_riccati_block_stamps.restype = ctypes.c_int
    out = (ctypes.c_ulonglong * 8)()
    stamped = SimpleNamespace(gpmpc_riccati_sweep_block_f32=fn)
    result = {}
    keep, ck._lib = ck._lib, stamped
    try:
        for name, nt, nx, nu in K1_STAMP_SHAPES:
            q = ck.stage_qp_inputs(nt, nx, nu, nt + nx, device=dev)
            reg = torch.tensor(1e-6, device=dev)
            err = ck.check_riccati_sweep(q, reg)
            ms = cuda_time_ms(lambda: ck.riccati_sweep(*q, reg), reps=reps)
            torch.cuda.synchronize()
            lib.gpmpc_riccati_block_stamps(out)
            for _ in range(reps):
                ck.riccati_sweep(*q, reg)
            torch.cuda.synchronize()
            mhz = sm_clock_mhz()
            code = lib.gpmpc_riccati_block_stamps(out)
            if code != 0 or out[6] != reps:
                raise RuntimeError(f"K1 stamps: {code}, {out[6]} launches "
                                   f"stamped of {reps}")
            cyc = {s: out[i] / reps for i, s in enumerate(K1_SECTIONS)}
            total = sum(cyc.values())
            result[name] = dict(cycles=cyc, total=total, sm_mhz=mhz, ms=ms,
                                nt=nt, err=err)
            parts = "; ".join(
                f"{s} {c:.0f} ({100 * c / total:.1f}%, "
                f"{c / (1 if s == 'rollout' else nt):.0f} a stage)"
                for s, c in cyc.items())
            log(f"[K1 stamps {tag}] ({nx}, {nu}) Nt={nt} B=1: SM cycles a "
                f"launch (thread 0) {total:.0f} = {total / mhz / 1e3:.4f} ms "
                f"at the SM clock {mhz:.0f} MHz read after; event "
                f"{ms:.4f} ms a launch (stamped build, {reps} calls); "
                f"max|err| {err:.3e}; {parts} on {card}")
    finally:
        ck._lib = keep
    return result


def network_alone():
    """Phases 1-2, phase 22 in this process, and phase 11's block-path
    rows."""
    from gpmpc_tpu_torch.ops import cuda_kernels as ck
    card = card_line()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    log(f"[card] nvidia-smi: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    ck.build_library()
    log(f"[build] {time.perf_counter() - t0:.2f} s")
    log_ptxas(ck)
    rec = network_phase(ck, dev, card)
    rows = k1_block_rows(ck, dev, card, rec["launches"])
    print(card_line(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


class PhaseChild:
    """A phase in a child process (``chip_smoke.py --phase-child NAME
    DIR``) that runs beside the main process's phases, its inputs in
    ``build/phases/NAME_in.npz``, its log in ``NAME.log`` and its result
    in ``NAME.json`` there.  ``join`` waits (within PHASE_CHILD_TIMEOUT s
    of the start), prints the child's log and returns its result, or
    raises; ``stop`` kills it if it still runs."""

    def __init__(self, name, inputs=None):
        self.name = name
        self.dir = os.path.join(HERE, "build", "phases")
        os.makedirs(self.dir, exist_ok=True)
        self.out = os.path.join(self.dir, f"{name}.json")
        if os.path.exists(self.out):
            os.remove(self.out)
        if inputs is not None:
            np.savez(os.path.join(self.dir, f"{name}_in.npz"), **inputs)
        self.log_path = os.path.join(self.dir, f"{name}.log")
        self.t0 = time.perf_counter()
        with open(self.log_path, "w") as fh:
            self.proc = subprocess.Popen(
                [sys.executable, os.path.join(HERE, "chip_smoke.py"),
                 "--phase-child", name, self.dir], cwd=HERE, stdout=fh,
                stderr=subprocess.STDOUT)

    def join(self):
        left = PHASE_CHILD_TIMEOUT - (time.perf_counter() - self.t0)
        try:
            rc = self.proc.wait(timeout=max(left, 1.0))
        except subprocess.TimeoutExpired:
            self.proc.kill()
            rc = self.proc.wait()
        wall = time.perf_counter() - self.t0
        with open(self.log_path) as fh:
            for line in fh.read().splitlines():
                log(f"[child {self.name}] {line}")
        log(f"[child {self.name}] exit {rc}, {wall:.1f} s from its start")
        if rc != 0 or not os.path.exists(self.out):
            raise AssertionError(f"phase child {self.name} failed (exit "
                                 f"{rc}); its log is {self.log_path}")
        with open(self.out) as fh:
            return json.load(fh)

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def gp_record(gp):
    """A GP's training set, hypers and fit evaluations, for JSON."""
    from gpmpc_tpu_torch.models.convert import hypers_to_numpy
    return dict(X=gp.X_raw.cpu().numpy().tolist(),
                Y=gp.Y_raw.cpu().numpy().tolist(),
                hyper={k: v.tolist()
                       for k, v in hypers_to_numpy(gp.hyper).items()},
                n_evals=int(gp.n_evals))


def gp_from_record(rec, dev):
    """The GP of :func:`gp_record` on ``dev``, f32 (its posterior
    recomputed from the same training set and hypers)."""
    from gpmpc_tpu_torch.models.convert import gp_from_numpy
    gp = gp_from_numpy(np.array(rec["X"]), np.array(rec["Y"]),
                       **{k: np.array(v) for k, v in rec["hyper"].items()},
                       device=dev, dtype=torch.float32, gp_method="TA",
                       optimizer_opts=GP_OPTS)
    gp.n_evals = rec["n_evals"]
    return gp


def phase_child(name, out_dir):
    """A phase's child process (:class:`PhaseChild`): ``traced_k2`` runs
    phase 21 on phase 5's trajectory (``traced_k2_in.npz``), ``network``
    phase 22, ``car`` phases 12-13 and ``slice_f`` phase 15 (its TA step
    from a 3-step loop of its own, as ``--slice-f`` makes it); each
    writes its result to ``NAME.json``."""
    from gpmpc_tpu_torch.ops import cuda_kernels as ck
    card = card_line()
    dev = torch.device("cuda")
    ck.build_library()
    if name == "traced_k2":
        with np.load(os.path.join(out_dir, "traced_k2_in.npz")) as f:
            xs_np = f["xs"]
        launches, gp = traced_k2_phase(ck, dev, card, xs_np)
        res = dict(launches=launches, gp=gp_record(gp))
    elif name == "network":
        res = network_phase(ck, dev, card)
    elif name == "car":
        from gpmpc_tpu_torch.ops import gp_cuda as gc
        res = dict(launches=car_loop(ck, dev, card),
                   val_launches=car_validation(ck, gc, dev, card))
    elif name == "slice_f":
        from gpmpc_tpu_torch.ops import gp_cuda as gc
        res = dict(rows=slice_f_phase(ck, gc, dev, card))
    else:
        raise ValueError(f"no phase child {name!r}")
    with open(os.path.join(out_dir, f"{name}.json"), "w") as fh:
        json.dump(res, fh)
    return 0


def main(argv):
    if "--sparse-reference" in argv:        # phase 17's CPU child process
        sys.path.insert(0, HERE)
        return sparse_reference(argv[argv.index("--sparse-reference") + 1])
    if "--export-artifact" in argv:         # phase 18 (a)'s child process
        sys.path.insert(0, HERE)
        return export_artifact(argv[argv.index("--export-artifact") + 1])
    if "--serve-artifact" in argv:          # phase 18 (b)'s child process
        sys.path.insert(0, HERE)
        i = argv.index("--serve-artifact")
        return serve_artifact(*argv[i + 1:i + 4])
    if "--mesh-rank" in argv:               # phase 19's child processes
        sys.path.insert(0, HERE)
        i = argv.index("--mesh-rank")
        rank, backend = int(argv[i + 1]), argv[i + 3]
        return mesh_rank(rank, int(argv[i + 2]), backend, argv[i + 4],
                         f"cuda:{rank if backend == 'nccl' else 0}")
    if "--example-child" in argv:           # phase 20's child processes
        sys.path.insert(0, HERE)
        i = argv.index("--example-child")
        return example_child(argv[i + 1], argv[i + 2] == "quick",
                             argv[i + 3])
    if "--phase-child" in argv:             # phases 21 and 22's children
        sys.path.insert(0, HERE)
        i = argv.index("--phase-child")
        return phase_child(argv[i + 1], argv[i + 2])
    if "--example-steps" in argv:           # --examples --steps' children
        sys.path.insert(0, HERE)
        i = argv.index("--example-steps")
        return example_steps(argv[i + 1], argv[i + 2] == "quick",
                             int(argv[i + 3]), argv[i + 4])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this smoke "
              "test runs only on an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    n_steps = int(argv[argv.index("--steps") + 1]) if "--steps" in argv \
        else 140
    if "--examples" in argv:
        names = []
        for a in argv[argv.index("--examples") + 1:]:
            if a.startswith("--"):
                break
            names.append(a)
        return examples_alone(names, "--full" not in argv,
                              n_steps if "--steps" in argv else None)
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
    if "--traced-k2" in argv:
        return traced_k2_alone()
    if "--network" in argv:
        return network_alone()
    if "--mesh" in argv:
        return mesh_alone()
    if "--slice-g" in argv:
        return slice_g_alone()
    if "--slice-f3" in argv:
        return slice_f3_alone()
    if "--slice-f2" in argv:
        return slice_f2_alone()
    if "--slice-f" in argv:
        return slice_f_alone()
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

    # 2. build, and beside it K2's traced ODEs traced, lowered and built
    t0 = time.perf_counter()
    traced_specs = build_beside(ck, lambda: build_traced_k2(ck, dev))
    torch.cuda.synchronize()
    log(f"[build] {time.perf_counter() - t0:.2f} s -> {ck.BUILD_INFO['path']}"
        f" (the traced units' included)")
    log_ptxas(ck)

    # 3-4. kernels against their plain versions; K2 traced for any ODE
    k1_err, k2_err = check_kernels(ck, four_tank_ode, dev)
    check_traced_k2(ck, dev, traced_specs)

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
    u0, warm, _, _ = mpc.solve_step(
        torch.as_tensor(xs_np[-1], device=dev), XSP, warm=None)
    rti_step = rti_step_fn(mpc, xs_np[-1], u0, warm)
    step_ms = cuda_time_ms(rti_step, reps=10)
    log(f"[time] RTI control step (solve_step + plant step), CUDA events "
        f"after warm-up: {step_ms:.3f} ms/step on {card}")
    prof = profile_steps(rti_step, n=MAIN_PROFILED)
    log(f"[profile] per RTI control step: {prof['kernels_per_step']:.0f} "
        f"device kernels, {prof['device_ms_per_step']:.3f} ms device time "
        f"({prof['all_rows_ms_per_step']:.3f} ms summed over every row, "
        f"CPU ops included, as PRs 1-6 summed it), "
        f"{prof['wall_ms_per_step']:.3f} ms wall under the profiler; device "
        f"busy {100 * prof['busy_share']:.2f}% on {card}")
    for name, count, us in prof["top"]:
        log(f"[profile]   {name:60s} {count:6d} launches/{MAIN_PROFILED} "
            f"steps {us:9.1f} us/step")

    # Phases 12-13, 15 and 20-22 run in child processes beside the main
    # process's phases (each is one host thread; the card is idle most of
    # any step), started after phase 6's timings and joined after phase
    # 18: 22. the four-tank network under output feedback (K1's block
    # path, the longest) at once; 21. the main path as the JAX package
    # builds it and the quadrotor's loop (each plant's ODE traced into K2,
    # on phase 5's trajectory), 12-13. the car's closed loop and its
    # validation, and 20. the walkthroughs at full settings beside phases
    # 7-14; 15. slice F part 1 beside phases 16-18
    children = [PhaseChild("network"), PhaseChild("traced_k2",
                                                  inputs=dict(xs=xs_np)),
                PhaseChild("car")]
    p22, p21, p_car = children
    try:
        ex_children = ExampleChildren(EXAMPLES_FULL, quick=False)
        children.append(ex_children)
        # 7. the GP path's kernels against their plain versions
        errs = check_gp_kernels(gc, dev)
        errs.update(riccati_sweep=k1_err, rk4_substeps=k2_err)

        # 8. training at full width, 9. validation, 10. the trained GP's
        # loop
        gp, train_launches = train_on_card(
            ck, dev, "fixture", dict(multistart=1, max_iters=100))
        gp_example, _ = train_on_card(ck, dev, "example", MESH_FIT)
        # 19. the data-parallel surfaces over a mesh: child processes that
        # run beside phases 9-14, checked after phase 14
        mesh_children = MeshChildren(gp_example)
        children.append(mesh_children)
        val_launches = validate_on_card(ck, dev, gp)
        trained_loop(dev, gp, xs_np, us_np)

        # 14. the batched study
        study_launches, study_res = study_phase(ck, dev, card)
        mesh_rows_19 = mesh_phase(ck, gc, dev, card, mesh_children)
        r21 = p21.join()
        traced_launches = r21["launches"]
        quad_gp = gp_from_record(r21["gp"], dev)
        p15 = PhaseChild("slice_f")
        children.append(p15)

        # 16. slice F, part 2a: the tank's output-feedback loop, K1 built
        # on demand, the quadrotor's hybrid mismatch
        slice_f2_rows = slice_f2_phase(ck, dev, card, quad_gp)

        # 17. slice F, part 3: solve_mc and the chance calibration, UT
        # under solve_mc (K3 vmapped), the adaptive plant and the DAE, the
        # sparse GP; phase 18's export and deploy children run beside it
        g_children = SliceGChildren()
        children.append(g_children)
        slice_f3_rows = slice_f3_phase(ck, gc, dev, card, step_ms)

        # 18. slice G: the deployable RTI solve step (export, serve,
        # deploy; the eager step's trace is phase 6's)
        slice_g_rows = slice_g_phase(ck, dev, card, g_children,
                                     eager_trace=False)
        slice_f_rows = p15.join()["rows"]
        car = p_car.join()
        car_launches, car_val_launches = car["launches"], car["val_launches"]
        examples_rows = examples_phase(gc, dev, card, ex_children)
        network = p22.join()
    finally:
        for child in children:
            child.stop()

    # 11. kernel times beside their bounds
    times = kernel_times(ck, gc, four_tank_ode, dev, card)
    car_times = car_kernel_times(ck, gc, dev, card)
    k1_times(ck, dev, card)
    k4_times(gc, dev, card)
    k3_times(gc, dev, card)
    k2_times(ck, four_tank_ode, dev, card)
    k2_chain_cycles(ck, dev, card)
    # the network's unit, built by phase 22's child, loads from disk
    ode, nx, nu, _, _ = traced_odes(dev)["network"]
    traced_specs["network"] = ck.register_ode(ode, nx, nu, dev)
    traced_times = traced_k2_times(ck, dev, card, traced_specs)
    block_rows = k1_block_rows(ck, dev, card, network["launches"])
    traced_launches["network"] = network["k2"]
    TRACED_ERRS["network"] = network["k2_err"]
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
    rows += traced_k2_rows(traced_specs, traced_launches, traced_times)
    # the block path's rows at the network's shapes; its B=64 and (96, 48)
    # rows, which no path of this run launches, are in the log alone
    rows += (slice_f_rows + slice_f2_rows + slice_f3_rows + slice_g_rows
             + mesh_rows_19 + examples_rows
             + [r for r in block_rows if r["launches"]])
    print(card_line(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
