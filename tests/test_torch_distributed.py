"""Port parity for the data-parallel surfaces over a ``torch.distributed``
mesh (``gpmpc_tpu_torch/parallel/distributed.py``): ``fit(mesh=)``,
``GP(mesh=)`` (the exact and the sparse fit), ``BatchedStudy(mesh=)`` and
``MPC.solve_mc(mesh=)``, at the sizes of ``tests/test_distributed.py``.

One spawn of four gloo ranks on the CPU (this file run as a script, which
imports no JAX) runs every surface on a 2-D ``("dcn", "dp")`` mesh of
(2, 2) and on a 1-D mesh of 4, and writes each rank's gathered results.
The test holds 2-D against 1-D against the port's local run at the JAX
test's tolerances for the same comparisons, and the local and sharded runs
against the JAX package's local run at the parity rules of ROADMAP.md
(closed loops 1e-6 in f64).  Also the launch gate, a one-rank group in
this process, and uneven batches refused as JAX's ``device_put`` refuses
them."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:                   # run as a script (the ranks)
    sys.path.insert(0, REPO)

from gpmpc_tpu_torch import GP, MPC, Model  # noqa: E402
from gpmpc_tpu_torch.models import gp_core  # noqa: E402
from gpmpc_tpu_torch.models.convert import gp_from_fixture  # noqa: E402
from gpmpc_tpu_torch.parallel import BatchedStudy  # noqa: E402
from gpmpc_tpu_torch.parallel import distributed  # noqa: E402
from gpmpc_tpu_torch.systems import four_tank_ode  # noqa: E402
from gpmpc_tpu_torch.utils.config import GPConfig  # noqa: E402

F64 = torch.float64
DT = 3.0
X_SS = np.array([12.4, 12.7, 1.8, 1.4])
X0 = np.array([8.0, 9.0, 1.0, 1.0])
RANKS = 4
#: the seconds a rank may take, and the process group's collective timeout
RANK_TIMEOUT, GROUP_TIMEOUT = 150, 100
#: the study (tests/test_distributed.py's sizes; the bench study's solver
#: budget), the ensemble (its sizes; a small budget, its cold start too)
STUDY_B, STUDY_NT, STUDY_STEPS, STUDY_CAPACITY = 8, 3, 3, 48
STUDY_BUDGET = dict(al_iters=1, max_iters=3, ls_steps=4)
MC_LANES, MC_STEPS, MC_NT = 8, 6, 4
MC_BUDGET = dict(al_iters=2, max_iters=3)
GP_OPTS = dict(jitter=1e-5, min_noise=1e-4)


def _fit_data():
    """x (24, 3) uniform, y (24, 3) = sin(x W') + 0.01 noise, numpy-made."""
    rng = np.random.default_rng(4)
    x = rng.uniform(size=(24, 3))
    w = np.array([[1.0, -0.5, 0.2], [0.3, 0.8, -1.1], [0.0, 0.5, 0.5]])
    return x, np.sin(x @ w.T) + 0.01 * rng.standard_normal((24, 3))


def _model():
    return Model(Nx=4, Nu=2, ode=four_tank_ode, dt=DT, R=np.diag([1e-3] * 4),
                 clip_negative=True, dtype=F64, integrator_substeps=5,
                 device="cpu")


def _study(mesh):
    gp = gp_from_fixture(n=30, device="cpu", dtype=F64,
                         optimizer_opts=GP_OPTS)
    return BatchedStudy(_model(), gp, horizon=STUDY_NT * DT,
                        Q=np.diag([10.0, 10.0, 0.1, 0.1]),
                        R=0.01 * np.eye(2), ulb=[0.0, 0.0], uub=[8.0, 8.0],
                        capacity=STUDY_CAPACITY, solver_opts=STUDY_BUDGET,
                        mesh=mesh)


def _study_x0s():
    rng = np.random.default_rng(7)
    return np.clip(X0 + 0.2 * rng.standard_normal((STUDY_B, 4)), 1.0, None)


def _mpc():
    return MPC(horizon=MC_NT * DT, model=_model(), gp=None,
               discrete_method="rk4", gp_method="ME",
               Q=np.diag([10.0, 10.0, 0.1, 0.1]), R=0.01 * np.eye(2),
               ulb=[0.0, 0.0], uub=[8.0, 8.0], feedback=False,
               percentile=None, cov_updates=1, solver_opts=MC_BUDGET,
               init_solver_opts=MC_BUDGET, device="cpu")


def _np(t):
    return t.detach().cpu().numpy()


def _port_runs(mesh, mc_noise):
    """Every surface on ``mesh`` (None: the local run), as numpy arrays
    under ``{surface}_{name}``.  The study draws its noise from a torch
    generator (in full, then sliced under a mesh); the ensemble takes the
    JAX package's noise ``mc_noise``."""
    x, y = (torch.tensor(a) for a in _fit_data())
    out = {}
    for tag, s in (("fit3", 3), ("fit1", 1)):
        h, v, n = gp_core.fit(x, y, GPConfig(multistart=s, max_iters=40),
                              torch.Generator().manual_seed(1), mesh=mesh)
        out.update({f"{tag}_{k}": _np(a) for k, a in h._asdict().items()},
                   **{f"{tag}_values": _np(v), f"{tag}_evals": n})
    for tag, kw in (("gp", {}), ("sparse", dict(inducing=8))):
        gp = GP(x, y, multistart=3, max_iters=40, seed=1, mesh=mesh,
                device="cpu", dtype=F64, **kw)
        out.update({f"{tag}_{k}": _np(a)
                    for k, a in gp.hyper._asdict().items()},
                   **{f"{tag}_nll": _np(gp.nll), f"{tag}_evals": gp.n_evals})
    res = _study(mesh).run(_study_x0s(), X_SS, STUDY_STEPS,
                           generator=torch.Generator().manual_seed(5))
    out.update({f"study_{k}": _np(getattr(res, k)) for k in
                ("x_traj", "u_traj", "cost", "obj", "gp_points",
                 "mean_cost")},
               study_inv_k=_np(res.post.inv_k))
    mpc = _mpc()
    xs, us = mpc.solve_mc(X0, MC_STEPS * DT, X_SS, MC_LANES,
                          noise_ws=mc_noise, mesh=mesh)
    out.update(mc_xs=_np(xs), mc_us=_np(us),
               mc_converged=mpc.last_mc["converged"],
               mc_sigmas=mpc.last_mc["sigmas"])
    return out


def _uneven(mesh, mc_noise):
    """The messages of the study at B=6 and solve_mc at 6 lanes on a mesh
    of 4 ranks (each must raise ValueError)."""
    msgs = []
    for run in (lambda: _study(mesh).run(_study_x0s()[:6], X_SS, 1,
                                         noise=False),
                lambda: _mpc().solve_mc(X0, DT, X_SS, 6,
                                        noise_ws=mc_noise[:6, :1],
                                        mesh=mesh)):
        try:
            run()
            msgs.append("no error")
        except ValueError as e:
            msgs.append(f"ValueError: {e}")
    return msgs


def rank_main(rank, rendezvous, inputs, out_dir):
    """One gloo rank on the CPU: every surface on the (2, 2) mesh and on
    the 1-D mesh of 4, the uneven batches; writes ``rank{rank}.npz``."""
    torch.set_num_threads(1)
    import torch.distributed as dist
    joined = distributed.initialize_multihost(
        coordinator_address=f"file://{rendezvous}", num_processes=RANKS,
        process_id=rank, device="cpu", timeout=GROUP_TIMEOUT)
    if not joined:
        raise RuntimeError("initialize_multihost joined no process group")
    mc_noise = np.load(inputs)["mc_noise"]
    out = {}
    meshes = {"2d": distributed.make_study_mesh(n_hosts=2),
              "1d": distributed.make_study_mesh()}
    for tag, mesh in meshes.items():
        out[f"{tag}_shape"] = np.array(mesh.shape)
        out[f"{tag}_names"] = np.array(mesh.mesh_dim_names)
        out.update({f"{tag}_{k}": v
                    for k, v in _port_runs(mesh, mc_noise).items()})
    out["uneven"] = np.array(_uneven(meshes["1d"], mc_noise))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


def local_main(inputs, out_dir):
    """The port's local run of every surface (no mesh, no process group),
    in a process of its own beside the ranks; writes ``local.npz``."""
    torch.set_num_threads(1)
    np.savez(os.path.join(out_dir, "local.npz"),
             **_port_runs(None, np.load(inputs)["mc_noise"]))


# --------------------------------------------------------------- the tests


def test_initialize_multihost_is_noop_single_process(monkeypatch):
    """``tests/test_distributed.py``'s gate, with the process group's
    initialization stubbed: no cluster environment, and a one-task Slurm
    launch, touch nothing; four Slurm tasks, torchrun's variables,
    ``auto=True`` and an explicit spec delegate, with the spec's address,
    world size and rank and the CPU's backend."""
    import torch.distributed as dist
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK",
              "LOCAL_WORLD_SIZE", "SLURM_NTASKS", "SLURM_NPROCS",
              "SLURM_PROCID", "SLURM_LOCALID", "OMPI_COMM_WORLD_SIZE",
              "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_LOCAL_RANK",
              "PMI_SIZE", "PMI_RANK", "MPI_LOCALRANKID"):
        monkeypatch.delenv(k, raising=False)
    called = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: called.append(kw))
    init = distributed.initialize_multihost
    assert init() is False and init(device="cpu") is False
    monkeypatch.setenv("SLURM_NTASKS", "1")
    assert init(device="cpu") is False
    assert called == []
    monkeypatch.setenv("SLURM_NTASKS", "4")
    monkeypatch.setenv("SLURM_PROCID", "2")
    assert init(device="cpu") is True
    assert called[-1] == dict(backend="gloo", world_size=4, rank=2)
    monkeypatch.delenv("SLURM_NTASKS")
    monkeypatch.delenv("SLURM_PROCID")
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert init(device="cpu") is False          # no MASTER_ADDR beside it
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("RANK", "1")
    assert init(device="cpu") is True
    assert called[-1] == dict(backend="gloo", world_size=2, rank=1)
    for k in ("WORLD_SIZE", "MASTER_ADDR", "RANK"):
        monkeypatch.delenv(k)
    assert init(auto=True, device="cpu") is True
    assert called[-1] == dict(backend="gloo")
    assert init(coordinator_address="localhost:1234", num_processes=2,
                process_id=0, device="cpu", backend="gloo",
                timeout=30) is True
    kw = called[-1]
    assert kw["init_method"] == "tcp://localhost:1234"
    assert (kw["world_size"], kw["rank"]) == (2, 0)
    assert kw["timeout"].total_seconds() == 30
    # a CUDA rank never falls back on the CPU
    if not torch.cuda.is_available():
        n = len(called)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init(coordinator_address="localhost:1234", num_processes=2,
                 process_id=0)
        assert len(called) == n


@pytest.fixture
def one_rank_group(tmp_path):
    """A one-rank gloo group in this process on a ``file://`` rendezvous,
    destroyed afterwards so no later test sees it."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        distributed.make_study_mesh(devices="cpu")
    assert distributed.initialize_multihost(
        coordinator_address=f"file://{tmp_path / 'rendezvous'}",
        num_processes=1, process_id=0, device="cpu", timeout=60)
    yield dist
    dist.destroy_process_group()
    assert not dist.is_initialized()


def test_one_rank_meshes_and_placements(one_rank_group):
    """``make_study_mesh`` on one gloo rank: ``("dp",)`` of size 1; a
    (1, 1) ``("dcn", "dp")`` mesh; ``ValueError`` where the world does
    not split over the hosts.  The placement helpers and collectives on
    both meshes, and the surfaces' mesh checks."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard
    m1 = distributed.make_study_mesh()
    assert m1.mesh_dim_names == ("dp",) and m1.size() == 1
    assert m1.device_type == "cpu"
    m2 = init_device_mesh("cpu", (1, 1), mesh_dim_names=("dcn", "dp"))
    with pytest.raises(ValueError, match="do not split over 2 hosts"):
        distributed.make_study_mesh(n_hosts=2)
    x = np.arange(12.0).reshape(6, 2)
    for m in (m1, m2):
        assert not distributed.mesh_is_multiprocess(m)
        assert distributed.batch_spec(m) == m.mesh_dim_names
        assert distributed.batch_sharding(m) == [Shard(0)] * m.ndim
        np.testing.assert_array_equal(
            distributed.global_put(x, m, distributed.batch_spec(m)), x)
        tree = distributed.tree_global_put(
            dict(a=x, b=(torch.ones(3), None)), m, ())
        assert torch.equal(tree["a"], torch.as_tensor(x))
        assert tree["b"][1] is None
        with pytest.raises(ValueError, match="spec must be"):
            distributed.global_put(x, m, ("other",))
        t = torch.tensor([[True, False], [False, True]])
        assert torch.equal(distributed.gather(t, m), t)
        assert int(distributed.all_reduce(torch.tensor(3), m, "max")) == 3
    # the surfaces refuse anything but a DeviceMesh, and a mesh of another
    # device type
    with pytest.raises(TypeError, match="DeviceMesh"):
        distributed.check_mesh(object(), "cpu")
    with pytest.raises(ValueError, match="device type 'cpu'"):
        distributed.check_mesh(m1, "cuda")
    x, y = _fit_data()
    with pytest.raises(ValueError, match="device type"):
        gp_core.fit(torch.tensor(x, device="meta"),
                    torch.tensor(y, device="meta"), GPConfig(),
                    torch.Generator(), mesh=m1)


def _inputs(path):
    """The ensemble's noise as the JAX package's solve_mc draws it from
    PRNGKey(3) (tests/test_torch_solve_mc.py::_jax_noise), saved for the
    ranks; returns it with the JAX controller."""
    import jax
    from test_torch_solve_mc import _jax_noise
    jmpc = _jax_mpc()
    w = _jax_noise(jmpc, jax.random.PRNGKey(3), MC_LANES, MC_STEPS)
    np.savez(path, mc_noise=w)
    return w, jmpc


def _jax_model():
    import jax.numpy as jnp
    from gpmpc_tpu import Model as JModel
    from gpmpc_tpu.systems import four_tank_ode as jode
    return JModel(Nx=4, Nu=2, ode=lambda x, u: jode(x, u), dt=DT,
                  R=np.diag([1e-3] * 4), clip_negative=True,
                  dtype=jnp.float64, integrator_substeps=5)


def _jax_mpc():
    from gpmpc_tpu import MPC as JMPC
    return JMPC(horizon=MC_NT * DT, model=_jax_model(), gp=None,
                discrete_method="rk4", gp_method="ME",
                Q=np.diag([10.0, 10.0, 0.1, 0.1]), R=0.01 * np.eye(2),
                ulb=[0.0, 0.0], uub=[8.0, 8.0], feedback=False,
                percentile=None, cov_updates=1, solver_opts=MC_BUDGET,
                init_solver_opts=MC_BUDGET)


def _jax_runs(jmpc, study_noise):
    """The JAX package's local runs: the fit at multistart=1, the study on
    the port's noise, the ensemble."""
    import jax
    import jax.numpy as jnp
    from gpmpc_tpu.models import gp_core as jcore
    from gpmpc_tpu.parallel import batched as jbatched
    from gpmpc_tpu.utils.config import GPConfig as JConfig
    from test_torch_parallel import _jax_gp
    x, y = _fit_data()
    h, v = jcore.fit(jnp.asarray(x), jnp.asarray(y),
                     JConfig(multistart=1, max_iters=40),
                     jax.random.PRNGKey(1))
    out = {f"fit1_{k}": np.asarray(a) for k, a in h._asdict().items()}
    out["fit1_values"] = np.asarray(v)
    js = jbatched.BatchedStudy(
        _jax_model(), _jax_gp(30), horizon=STUDY_NT * DT,
        Q=np.diag([10.0, 10.0, 0.1, 0.1]), R=0.01 * np.eye(2),
        ulb=[0.0, 0.0], uub=[8.0, 8.0], capacity=STUDY_CAPACITY,
        solver_opts=STUDY_BUDGET)
    res = js._run_jit(jnp.asarray(_study_x0s()), jnp.asarray(X_SS),
                      jnp.asarray(study_noise), js.post0, js.consts,
                      n_steps=STUDY_STEPS, batched_post=False)
    out.update({f"study_{k}": np.asarray(getattr(res, k)) for k in
                ("x_traj", "u_traj", "cost", "obj", "gp_points",
                 "mean_cost")})
    xs, us = jmpc.solve_mc(X0, MC_STEPS * DT, X_SS, MC_LANES,
                           key=jax.random.PRNGKey(3))
    out.update(mc_xs=np.asarray(xs), mc_us=np.asarray(us),
               mc_converged=jmpc.last_mc["converged"])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four gloo ranks' results (one dict a rank), the port's local run
    (a fifth process beside them) and the JAX package's, computed here
    while they run."""
    tmp = tmp_path_factory.mktemp("mesh")
    w, jmpc = _inputs(tmp / "inputs.npz")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    io = (str(tmp / "inputs.npz"), str(tmp))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), *argv], cwd=REPO,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for argv in [(str(r), str(tmp / "rendezvous")) + io
                     for r in range(RANKS)] + [("local",) + io]]
    try:
        study_noise = _study(None).noise(
            STUDY_B, STUDY_STEPS, torch.Generator().manual_seed(5))
        ref = _jax_runs(jmpc, _np(study_noise))
        logs = [p.communicate(timeout=RANK_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"{p.args[2:3]}:\n{log[-4000:]}"
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(RANKS)]
    return ranks, dict(np.load(tmp / "local.npz")), ref


def _close(got, ref, atol, rtol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(ref, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


def _keys(rank, surface):
    return sorted(k[3:] for k in rank if k.startswith(f"1d_{surface}_"))


def _layouts_agree(runs, surface, atol_2d, atol_local, rtol=0.0):
    """Every rank returns the same (whole) result; the 2-D mesh against the
    1-D mesh within ``atol_2d`` and against the local run within
    ``atol_local`` (``rtol`` beside it)."""
    ranks, local, _ = runs
    for key in _keys(ranks[0], surface):
        for r in ranks[1:]:
            for tag in ("2d", "1d"):
                np.testing.assert_array_equal(r[f"{tag}_{key}"],
                                              ranks[0][f"{tag}_{key}"])
        two, one = ranks[0][f"2d_{key}"], ranks[0][f"1d_{key}"]
        assert two.shape == np.shape(local[key]), key
        _close(two, one, atol_2d, what=f"2-D vs 1-D {key}")
        _close(two, local[key], atol_local, rtol, what=f"2-D vs local {key}")


def test_meshes_span_the_four_ranks(runs):
    ranks, _, _ = runs
    for r in ranks:
        assert tuple(r["2d_shape"]) == (2, 2)
        assert tuple(r["2d_names"]) == ("dcn", "dp")
        assert tuple(r["1d_shape"]) == (4,) and tuple(r["1d_names"]) == (
            "dp",)


def test_fit_sharded_matches_local_and_jax(runs):
    """The (multistart 3 x 3 dims) grid of 9 problems over 4 ranks pads 3
    (JAX's test pads 7 over 8): hypers within 1e-12 and values within
    1e-10 of the local fit (``tests/test_distributed.py:158-162``), on both
    layouts, through ``gp_core.fit``, ``GP`` and the sparse GP's two fits;
    ``n_evals`` the most any rank made, at most the local run's.  At
    multistart=1 (start 0 is the same heuristic on both sides) the local
    and the sharded fits against JAX's: NLL within 1e-6 relative, the
    hypers within 1e-3 (``tests/test_torch_gp_train.py::
    test_fit_matches_jax_x64``)."""
    ranks, local, ref = runs
    for surface in ("fit3", "fit1", "gp", "sparse"):
        keys = [k for k in _keys(ranks[0], surface)
                if not k.endswith("_evals")]
        for key in keys:
            for tag in ("2d", "1d"):
                tol = 1e-10 if key.endswith(("_values", "_nll")) else 1e-12
                _close(ranks[0][f"{tag}_{key}"], local[key], tol,
                       what=f"{tag} {key}")
        evals = int(ranks[0][f"2d_{surface}_evals"])
        assert 1 < evals <= local[f"{surface}_evals"]
        assert int(ranks[0][f"1d_{surface}_evals"]) == evals
    for got in (local["fit1_values"], ranks[0]["2d_fit1_values"],
                ranks[0]["1d_fit1_values"]):
        _close(got, ref["fit1_values"], 0.0, 1e-6, "fit vs JAX")
    for k in ("log_ell", "log_sf2"):
        _close(local[f"fit1_{k}"], ref[f"fit1_{k}"], 1e-3, what=k)


def test_study_sharded_matches_local_and_jax(runs):
    """B=8 rollouts, Nt=3, 3 steps, capacity 48, over 4 ranks (2 each), the
    noise drawn in full on every rank and sliced: 2-D against 1-D within
    1e-10, against the local run within 1e-5 and mean_cost rtol 1e-6
    (``tests/test_distributed.py:117-122``); the local and the sharded
    study against JAX's on the same noise within 1e-6."""
    ranks, local, ref = runs
    _layouts_agree(runs, "study", 1e-10, 1e-5)
    _close(ranks[0]["2d_study_mean_cost"], local["study_mean_cost"], 0.0,
           1e-6, "mean_cost")
    _close(ranks[0]["1d_study_mean_cost"],
           ranks[0]["1d_study_cost"].mean(), 0.0, 1e-14, "mean of cost")
    assert ranks[0]["1d_study_inv_k"].shape == (STUDY_B, 4, STUDY_CAPACITY,
                                                STUDY_CAPACITY)
    for k in ("x_traj", "u_traj", "cost", "obj", "gp_points", "mean_cost"):
        for got in (local[f"study_{k}"], ranks[0][f"2d_study_{k}"],
                    ranks[0][f"1d_study_{k}"]):
            _close(got, ref[f"study_{k}"], 1e-6, what=f"study {k} vs JAX")


def test_solve_mc_sharded_matches_local_and_jax(runs):
    """8 lanes, 6 steps, ME, no feedback, over 4 ranks (2 lanes each), the
    JAX package's noise: 2-D against 1-D and against the local run within
    1e-7 (``tests/test_distributed.py:168-171``), ``last_mc`` gathered; the
    local and sharded ensembles against JAX's within 1e-6."""
    ranks, local, ref = runs
    _layouts_agree(runs, "mc", 1e-7, 1e-7)
    for k in ("xs", "us"):
        for got in (local[f"mc_{k}"], ranks[0][f"2d_mc_{k}"],
                    ranks[0][f"1d_mc_{k}"]):
            _close(got, ref[f"mc_{k}"], 1e-6, what=f"mc {k} vs JAX")
    np.testing.assert_array_equal(ranks[0]["2d_mc_converged"],
                                  ref["mc_converged"])
    assert float(ranks[0]["2d_mc_xs"][:, -1, 0].std()) > 1e-4


def test_uneven_batches_raise(runs):
    """A study of 6 rollouts and an ensemble of 6 lanes on a mesh of 4
    ranks raise ValueError on every rank, as JAX's device_put of a (6, 4)
    batch over 4 devices does."""
    ranks, _, _ = runs
    for r in ranks:
        for msg in r["uneven"]:
            assert msg.startswith("ValueError: a batch of 6 does not "
                                  "divide over the mesh's 4 ranks"), msg


if __name__ == "__main__":
    if sys.argv[1] == "local":
        local_main(*sys.argv[2:4])
    else:
        rank_main(int(sys.argv[1]), *sys.argv[2:5])
