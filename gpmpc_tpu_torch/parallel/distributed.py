"""Multi-process runtime and the batch mesh of the data-parallel surfaces,
on ``torch.distributed``.

Counterpart of ``gpmpc_tpu/parallel/distributed.py``.  The JAX package
shards a batch axis over the devices of a ``jax.sharding.Mesh`` and lets
XLA place the lanes; here one process drives one device, so a mesh is a
set of ranks: a :class:`torch.distributed.device_mesh.DeviceMesh` whose
batch axis spans all of its dims.  Every batched surface
(:class:`~gpmpc_tpu_torch.parallel.batched.BatchedStudy`,
:meth:`MPC.solve_mc <gpmpc_tpu_torch.mpc.controller.MPC.solve_mc>`,
``GP(mesh=)`` and :func:`gp_core.fit <gpmpc_tpu_torch.models.gp_core.fit>`)
takes the same inputs on every rank (the SPMD contract: same program, same
inputs, the same seed), runs its contiguous block of the batch
(:func:`local_block`) and gathers the blocks in mesh order
(:func:`gather`), so every rank returns the local run's result, lane for
lane.  This module owns:

* **process bring-up** (:func:`initialize_multihost`, a gate over
  ``torch.distributed.init_process_group``: a no-op unless a cluster spec
  is given or a launcher planted one in the environment);
* **the mesh** (:func:`make_study_mesh`): ``("dp",)`` over the world, or
  ``("dcn", "dp")`` whose rows are each host's ranks, so that a
  collective may reduce within a host first;
* the placement helpers of the JAX module (:func:`global_put`,
  :func:`batch_spec`, :func:`batch_sharding`, ...) and the collectives the
  consumers use, all through the process group's own ``all_gather`` and
  ``all_reduce`` on the device's tensors.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["initialize_multihost", "make_study_mesh", "batch_sharding",
           "batch_spec", "mesh_is_multiprocess", "global_put",
           "tree_global_put"]

#: world-size variables of the launchers the gate recognizes (torchrun's
#: WORLD_SIZE counts only with MASTER_ADDR beside it)
_SIZE_KEYS = ("SLURM_NTASKS", "SLURM_NPROCS", "OMPI_COMM_WORLD_SIZE",
              "PMI_SIZE")
_RANK_KEYS = ("RANK", "SLURM_PROCID", "OMPI_COMM_WORLD_RANK", "PMI_RANK")
_WORLD_KEYS = ("WORLD_SIZE",) + _SIZE_KEYS
_LOCAL_RANK_KEYS = ("LOCAL_RANK", "SLURM_LOCALID",
                    "OMPI_COMM_WORLD_LOCAL_RANK", "MPI_LOCALRANKID")


def _env_int(keys, default=None):
    """The first of ``keys`` set in the environment as an int."""
    for k in keys:
        try:
            return int(os.environ[k])
        except (KeyError, ValueError):
            pass
    return default


def _cluster_env_present() -> bool:
    """True when a recognized multi-process launcher planted cluster info:
    torchrun's ``WORLD_SIZE`` > 1 with ``MASTER_ADDR``, a Slurm step of
    more than one task, and Open MPI or PMI world sizes above one.  A
    one-task launch is not a cluster."""
    if os.environ.get("MASTER_ADDR") and _env_int(("WORLD_SIZE",), 1) > 1:
        return True
    return any(_env_int((k,), 1) > 1 for k in _SIZE_KEYS)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         auto: bool = False,
                         backend: Optional[str] = None,
                         device=None,
                         timeout: Optional[float] = None,
                         **kwargs) -> bool:
    """Join (or skip) the process group; returns True if it was
    initialized.

    Call once per process, before the first collective.  Launch modes:

    * manual: ``coordinator_address`` ("host:port" of rank 0, or an
      ``init_method`` URL such as ``"file:///shared/rendezvous"``),
      ``num_processes`` and this process's ``process_id``;
    * a recognized launcher (torchrun, Slurm, Open MPI, PMI): no
      arguments; the rank and world size come from the launcher's
      variables, the rendezvous from ``MASTER_ADDR``/``MASTER_PORT``;
    * ``auto=True`` delegates unconditionally;
    * one process with no cluster environment: a no-op, nothing touched.

    ``device`` (default ``"cuda"``) is this rank's device: ``"cuda"``
    binds the process to the card of its local rank, ``"cuda:i"`` to card
    i (several ranks may share one), ``"cpu"`` to the CPU.  A CUDA device
    without a card raises: the process never falls back on the CPU.
    ``backend`` defaults to ``"nccl"`` on CUDA and ``"gloo"`` on the CPU;
    ``timeout`` (seconds) bounds every collective of the group.  Other
    keywords go to ``torch.distributed.init_process_group``."""
    if (not auto and coordinator_address is None
            and num_processes in (None, 1)):
        # no explicit cluster spec: join only when a launcher planted one;
        # a plain one-process run must not wait for a rendezvous
        if not _cluster_env_present():
            return False
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "initialize_multihost: no CUDA device is available for "
                "device='cuda'; pass device='cpu' to run the ranks on the "
                "CPU")
        if dev.index is None:
            local = _env_int(_LOCAL_RANK_KEYS)
            if local is None:
                rank = process_id if process_id is not None else \
                    _env_int(_RANK_KEYS, 0)
                local = rank % torch.cuda.device_count()
            dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if coordinator_address is not None:
        kwargs["init_method"] = (coordinator_address
                                 if "://" in coordinator_address
                                 else f"tcp://{coordinator_address}")
    world = num_processes if num_processes is not None else \
        _env_int(_WORLD_KEYS)
    rank = process_id if process_id is not None else _env_int(_RANK_KEYS)
    if world is not None:
        kwargs["world_size"] = world
    if rank is not None:
        kwargs["rank"] = rank
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend=backend, **kwargs)
    return True


def _mesh_device_type(devices) -> str:
    """The device type of a mesh: that of ``devices`` (a device or a
    device type), else the default group's backend's own (``nccl``:
    CUDA, ``gloo``: the CPU)."""
    if devices is None:
        return "cuda" if dist.get_backend() == "nccl" else "cpu"
    return torch.device(devices).type


def make_study_mesh(devices=None, n_hosts: Optional[int] = None):
    """The batch mesh of the data-parallel surfaces over the world's ranks:
    a 1-D ``("dp",)`` mesh, or with ``n_hosts > 1`` a 2-D ``("dcn",
    "dp")`` mesh of shape ``(n_hosts, world // n_hosts)`` whose row i holds
    host i's ranks (launchers number each host's ranks contiguously).
    ``n_hosts`` defaults to ``WORLD_SIZE // LOCAL_WORLD_SIZE`` where a
    launcher set both, else 1.  ``devices`` names the device type (see
    :func:`_mesh_device_type`; gloo ranks on the card pass ``"cuda"``).
    Raises ``RuntimeError`` when no process group is initialized (there
    is no one-process mesh without one) and ``ValueError`` when the world
    does not split over ``n_hosts``."""
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_study_mesh: no process group is "
                           "initialized (call initialize_multihost first)")
    world = dist.get_world_size()
    device_type = _mesh_device_type(devices)
    if n_hosts is None:
        local = _env_int(("LOCAL_WORLD_SIZE",))
        n_hosts = (_env_int(("WORLD_SIZE",), world) // local
                   if local else 1)
    if n_hosts <= 1:
        return init_device_mesh(device_type, (world,),
                                mesh_dim_names=("dp",))
    if world % n_hosts:
        raise ValueError(f"{world} ranks do not split over {n_hosts} hosts")
    return init_device_mesh(device_type, (n_hosts, world // n_hosts),
                            mesh_dim_names=("dcn", "dp"))


def mesh_is_multiprocess(mesh) -> bool:
    """True when the mesh spans more than one process: every rank is one."""
    return mesh.size() > 1


def check_mesh(mesh, device) -> None:
    """Refuse what a data-parallel surface cannot shard over: anything but
    a ``DeviceMesh`` (``TypeError``), or a mesh of another device type than
    the surface's ``device`` (``ValueError``)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh "
                        f"(parallel.distributed.make_study_mesh); got "
                        f"{type(mesh).__name__}")
    if mesh.device_type != torch.device(device).type:
        raise ValueError(f"the mesh is of device type {mesh.device_type!r}, "
                         f"the data on {torch.device(device)}")


def _ranks(mesh):
    """The mesh's global ranks in mesh order (its dims flattened)."""
    return mesh.mesh.flatten().tolist()


def _group(mesh):
    """A process group of all the mesh's ranks: the 1-D mesh's own, the
    world's for a mesh of more dims over the whole world."""
    if mesh.ndim == 1:
        return mesh.get_group()
    if sorted(_ranks(mesh)) != list(range(dist.get_world_size())):
        raise ValueError("a mesh of more than one dim must span the world")
    return dist.group.WORLD


def _rank_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def local_block(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's contiguous block of the batch-leading ``x``: block i of
    mesh.size() equal blocks for the rank at mesh position i.  A batch that
    does not divide raises ``ValueError``, as JAX's ``device_put`` over a
    batch sharding does."""
    n, size = x.shape[0], mesh.size()
    if n % size:
        raise ValueError(f"a batch of {n} does not divide over the mesh's "
                         f"{size} ranks")
    k = n // size
    i = _ranks(mesh).index(dist.get_rank())
    return x[i * k:(i + 1) * k]


def _collective(name, group, fn, t):
    try:
        fn()
    except (RuntimeError, ValueError) as e:
        raise RuntimeError(
            f"{name} on backend {dist.get_backend(group)!r} with a "
            f"{t.dtype} tensor on {t.device}: {e}") from e


def gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """The blocks of every rank of ``mesh``, concatenated along dim 0 in
    mesh order: the inverse of :func:`local_block` (an ``all_gather`` over
    the mesh's ranks; every block must have one shape)."""
    group = _group(mesh)
    t = x.contiguous()
    flag = t.dtype == torch.bool
    if flag:
        t = t.to(torch.uint8)
    parts = [torch.empty_like(t) for _ in range(mesh.size())]
    _collective("all_gather", group,
                lambda: dist.all_gather(parts, t, group=group), t)
    out = torch.cat([parts[dist.get_group_rank(group, r)]
                     for r in _ranks(mesh)])
    return out.to(torch.bool) if flag else out


def all_reduce(x: torch.Tensor, mesh, op: str = "sum") -> torch.Tensor:
    """The sum (``op="sum"``) or max (``"max"``) of ``x`` over the mesh's
    ranks, a new tensor."""
    group = _group(mesh)
    t = x.clone()
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    _collective("all_reduce", group,
                lambda: dist.all_reduce(t, op=red, group=group), t)
    return t


def batch_spec(mesh) -> tuple:
    """The mesh dims a leading batch axis shards over: all of them."""
    return tuple(mesh.mesh_dim_names)


def batch_sharding(mesh) -> list:
    """The DTensor placements that say the same: ``Shard(0)`` on every
    mesh dim."""
    from torch.distributed.tensor import Shard

    return [Shard(0)] * mesh.ndim


def global_put(x, mesh, spec):
    """This rank's part of ``x`` on this rank's device: its block of a
    batch-leading array for ``spec == batch_spec(mesh)``, the whole of it
    (replicated) for ``spec == ()``.  Every rank passes the same full host
    copy."""
    t = torch.as_tensor(x)
    if tuple(spec) == batch_spec(mesh):
        t = local_block(t, mesh)
    elif tuple(spec):
        raise ValueError(f"spec must be batch_spec(mesh) = "
                         f"{batch_spec(mesh)} or () (replicated); got "
                         f"{spec!r}")
    return t.to(_rank_device(mesh))


def tree_global_put(tree, mesh, spec):
    """:func:`global_put` over every array leaf of a nest of tuples,
    NamedTuples, lists and dicts (one spec); other leaves pass as they
    are."""
    if torch.is_tensor(tree) or isinstance(tree, np.ndarray):
        return global_put(tree, mesh, spec)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_global_put(v, mesh, spec) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_global_put(v, mesh, spec) for v in tree)
    if isinstance(tree, dict):
        return {k: tree_global_put(v, mesh, spec) for k, v in tree.items()}
    return tree
