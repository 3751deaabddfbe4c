"""Batched closed-loop studies with online GP conditioning, and the
multi-process mesh of the data-parallel surfaces.

Counterpart of ``gpmpc_tpu/parallel/``: :class:`BatchedStudy`, the online
posterior (:mod:`online_gp`) and :mod:`distributed` on
``torch.distributed``."""

from gpmpc_tpu_torch.parallel import online_gp
from gpmpc_tpu_torch.parallel.batched import (BatchedStudy, StudyResult,
                                              load_study, save_study)
from gpmpc_tpu_torch.parallel.distributed import (initialize_multihost,
                                                  make_study_mesh,
                                                  batch_sharding, batch_spec,
                                                  mesh_is_multiprocess,
                                                  global_put, tree_global_put)

__all__ = ["BatchedStudy", "StudyResult", "online_gp", "save_study",
           "load_study", "initialize_multihost", "make_study_mesh",
           "batch_sharding", "batch_spec", "mesh_is_multiprocess",
           "global_put", "tree_global_put"]
