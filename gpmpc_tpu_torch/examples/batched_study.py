"""Batched closed-loop study: many GP-MPC rollouts at once.

Counterpart of ``examples/batched_study.py``.  1024 receding-horizon
four-tank rollouts from randomized initial states (16 with ``--quick``),
each conditioning its own GP online on the transitions it observes, run
as one batch: every control step is one vmapped solve of all rollouts.
Started under a launcher with more than one rank (torchrun, Slurm,
Open MPI), the rollouts shard over the ranks' mesh; a single process runs
the plain study.  The study is checkpointed to ``batched_study.npz`` and
read back.

Usage: python3 -m gpmpc_tpu_torch.examples.batched_study [--quick] [--cpu]
                                                         [--batch N]
"""

import numpy as np
import torch
import torch.distributed as dist

from gpmpc_tpu_torch import GP, Model
from gpmpc_tpu_torch.examples._common import (clock, device_dtype,
                                              generator, run_cli)
from gpmpc_tpu_torch.parallel import (BatchedStudy, initialize_multihost,
                                      load_study, make_study_mesh,
                                      save_study)
from gpmpc_tpu_torch.systems import four_tank_ode

DT = 3.0
N_TRAIN = 50
X0 = np.array([8.0, 9.0, 1.0, 1.0])
X0_LO = np.array([-3.0, -3.0, -0.4, -0.4])
X0_HI = np.array([6.0, 6.0, 2.0, 2.0])
X_SP = np.array([12.4, 12.7, 1.8, 1.4])
CHECKPOINT = "batched_study.npz"


def build_model(device, dtype):
    return Model(Nx=4, Nu=2, ode=four_tank_ode, dt=DT,
                 R=np.diag([1e-3] * 4), clip_negative=True,
                 integrator_substeps=10, device=device, dtype=dtype)


def fit(model):
    """The prior GP: 50 noisy transitions (seed 2), one start, 100
    iterations, the f32-safe jitter and noise floor."""
    X, Y = model.generate_training_data(
        N_TRAIN, uub=[6.0, 6.0], ulb=[0.0, 0.0], xub=[20.0, 20.0, 6.0, 6.0],
        xlb=[1.0, 1.0, 0.5, 0.5], generator=generator(model.device, 2))
    return GP(X, Y, multistart=1, max_iters=100, seed=1,
              optimizer_opts=dict(jitter=1e-5, min_noise=1e-5),
              device=model.device, dtype=model.dtype)


def study_mesh(device):
    """The ranks' mesh when a launcher started more than one process, else
    None (one process: the plain study)."""
    initialize_multihost(device=device)
    if dist.is_initialized() and dist.get_world_size() > 1:
        return make_study_mesh(device.type)
    return None


def build_study(model, gp, n_steps, mesh):
    return BatchedStudy(
        model, gp, horizon=8 * DT, Q=np.diag([10.0, 10.0, 0.1, 0.1]),
        R=0.01 * np.eye(2), ulb=[0.0, 0.0], uub=[8.0, 8.0],
        capacity=N_TRAIN + n_steps + 14,
        solver_opts=dict(al_iters=1, max_iters=3, ls_steps=4), mesh=mesh)


def initial_states(b, device, dtype):
    """B initial states: X0 plus uniform offsets in [X0_LO, X0_HI) (seed
    0)."""
    kw = dict(dtype=dtype, device=device)
    lo, hi = (torch.as_tensor(v, **kw) for v in (X0_LO, X0_HI))
    u = torch.rand((b, 4), generator=generator(device, 0), **kw)
    return torch.as_tensor(X0, **kw) + lo + (hi - lo) * u


def run_study(study, x0s, n_steps):
    """The study with process noise (seed 1); returns the result and its
    wall seconds."""
    t0 = clock(study.device)
    res = study.run(x0s, X_SP, n_steps=n_steps, noise=True,
                    generator=generator(study.device, 1))
    return res, clock(study.device) - t0


def checkpoint(study, res, path=CHECKPOINT):
    """Save the study and load it back; returns whether every array and
    posterior leaf came back bitwise."""
    save_study(path, res)
    back = load_study(path, study.post0)
    return all(torch.equal(getattr(back, k), getattr(res, k)) for k in
               ("x_traj", "u_traj", "cost", "obj", "gp_points",
                "mean_cost")) and \
        all(torch.equal(a, b) for a, b in zip(back.post, res.post))


def main(quick=False, device=None, batch=None):
    device, dtype = device_dtype(device)
    b = batch or (16 if quick else 1024)
    n_steps = 5 if quick else 20
    model = build_model(device, dtype)
    gp = fit(model)
    mesh = study_mesh(device)
    ranks = dist.get_world_size() if mesh is not None else 1
    print(f"ranks: {ranks} ({device}), mesh: "
          f"{mesh.mesh_dim_names if mesh is not None else 'single'}  "
          f"batch={b}")
    study = build_study(model, gp, n_steps, mesh)
    res, wall = run_study(study, initial_states(b, device, dtype), n_steps)
    cost = res.cost.cpu().numpy()
    points = int(res.gp_points[0])
    print(f"ran {b} rollouts x {n_steps} steps in {wall:.2f}s = "
          f"{b * n_steps / wall:,.0f} rollout-solves/s")
    print(f"closed-loop cost: mean {cost.mean():.1f}  p10 "
          f"{np.percentile(cost, 10):.1f}  p90 {np.percentile(cost, 90):.1f}")
    print(f"GP points per rollout after online conditioning: {points} "
          f"(from {N_TRAIN})")
    assert np.isfinite(cost).all(), "non-finite closed-loop cost"
    same = None
    if mesh is None or dist.get_rank() == 0:
        same = checkpoint(study, res)
        print(f"checkpoint written: {CHECKPOINT} (read back bitwise: "
              f"{same}; resume via study.run(..., "
              f"init_post=load_study(...).post))")
        assert same, "the checkpoint did not read back bitwise"
    return dict(wall=wall, ms_per_step=1e3 * wall / n_steps,
                rollout_solves_per_s=b * n_steps / wall,
                mean_cost=float(cost.mean()), gp_points=points,
                checkpoint_bitwise=same, n_evals=gp.n_evals)


if __name__ == "__main__":
    run_cli(main, __doc__, batch=True)
