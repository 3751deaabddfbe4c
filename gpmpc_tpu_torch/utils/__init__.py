"""Configuration dataclasses, the chance-constraint calibration audit,
tracing and timing (``profiling``), figures on demand (``plotting``) and
the deployable solve step (``export``, imported on first use: it imports
the controller)."""

import importlib

from gpmpc_tpu_torch.utils import profiling
from gpmpc_tpu_torch.utils.calibration import (chance_calibration,
                                               violation_rates)
from gpmpc_tpu_torch.utils.config import GPConfig, MPCOptions, SQPConfig

__all__ = ["GPConfig", "SQPConfig", "MPCOptions", "chance_calibration",
           "violation_rates", "export", "profiling"]


def __getattr__(name):
    if name == "export":
        return importlib.import_module(f"{__name__}.export")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
