"""Batched closed-loop studies with online GP conditioning.

Counterpart of ``gpmpc_tpu/parallel/``: :class:`BatchedStudy` and the
online posterior (:mod:`online_gp`).  The multi-device module
``distributed.py`` is ROADMAP §1 item 6.9."""

from gpmpc_tpu_torch.parallel import online_gp
from gpmpc_tpu_torch.parallel.batched import (BatchedStudy, StudyResult,
                                              load_study, save_study)

__all__ = ["BatchedStudy", "StudyResult", "online_gp", "save_study",
           "load_study"]
