"""gpmpc_tpu_torch — the PyTorch/CUDA port of gpmpc_tpu.

The same Gaussian-process MPC as the JAX package ``gpmpc_tpu`` (the
reference, which stays beside it), on PyTorch, with the TPU's Pallas
kernels rewritten as CUDA C++ kernels for Hopper (``csrc/``,
``ops/cuda_kernels.py``).  Every tensor lives on the ``device`` and in the
``dtype`` given to ``Model``, ``GP`` and ``MPC``.

    from gpmpc_tpu_torch import Model, GP, MPC
"""

import torch as _torch

# Full-precision f32 products.  Reduced-precision (TF32) f32 matmuls corrupt
# the cancellation-amplified Gram expansion and the variance
# sf2 - ||L^-1 k*||^2 (models/gp_core.py), as bf16 passes did on the TPU
# (gpmpc_tpu/__init__.py).  Both switches are set, for matmuls and cuDNN.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from gpmpc_tpu_torch.models.dynamics import Model  # noqa: E402
from gpmpc_tpu_torch.models.gp import GP  # noqa: E402
from gpmpc_tpu_torch.mpc.controller import MPC  # noqa: E402

__version__ = "0.1.0"

__all__ = ["Model", "GP", "MPC", "__version__"]
