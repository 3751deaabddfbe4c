"""GP, propagation and plant models."""

from gpmpc_tpu_torch.models.dynamics import Model
from gpmpc_tpu_torch.models.gp import GP

__all__ = ["Model", "GP"]
