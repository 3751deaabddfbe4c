"""Kernels, factorizations and the CUDA kernel wrappers.

Re-exports the JAX package's ``gpmpc_tpu.ops`` names except its TPU
dispatch (``PallasPolicy``, ``set_policy`` and the ``*_auto`` wrappers):
each CUDA wrapper here picks its kernel or its plain version by the
tensor's device."""

from gpmpc_tpu_torch.ops.chol import (chol_solve, cholesky_psd, cholupdate,
                                      tri_solve)
from gpmpc_tpu_torch.ops.kernels import (KERNELS, kernel_cross, kernel_gram,
                                         se_ard, se_ard_cross, se_ard_gram,
                                         sq_maha)

__all__ = [
    "KERNELS",
    "kernel_cross",
    "kernel_gram",
    "se_ard",
    "se_ard_cross",
    "se_ard_gram",
    "sq_maha",
    "cholesky_psd",
    "chol_solve",
    "tri_solve",
    "cholupdate",
]
