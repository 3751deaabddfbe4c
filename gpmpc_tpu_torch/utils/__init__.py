"""Configuration dataclasses and the chance-constraint calibration audit."""

from gpmpc_tpu_torch.utils.calibration import (chance_calibration,
                                               violation_rates)

__all__ = ["chance_calibration", "violation_rates"]
