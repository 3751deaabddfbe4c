"""GP prior mean functions.

Counterpart of ``gpmpc_tpu/models/mean_functions.py``: every mean function
is a linear map over a fixed feature vector, m(x; w) = w . phi(x).
"""

from __future__ import annotations

import torch

_KINDS = ("zero", "const", "linear", "poly")


def num_mean_params(kind: str, d: int) -> int:
    """Number of mean parameters per output dimension."""
    if kind == "zero":
        return 0
    if kind == "const":
        return 1
    if kind == "linear":
        return d + 1
    if kind == "poly":
        return 2 * d + 1
    raise ValueError(f"unknown mean function {kind!r}; expected one of {_KINDS}")


def mean_features(x: torch.Tensor, kind: str) -> torch.Tensor:
    """Feature vector phi(x) for a batch of inputs; (..., D) -> (..., F)."""
    if kind == "zero":
        return x.new_zeros(x.shape[:-1] + (0,))
    ones = x.new_ones(x.shape[:-1] + (1,))
    if kind == "const":
        return ones
    if kind == "linear":
        return torch.cat([x, ones], dim=-1)
    if kind == "poly":
        return torch.cat([x * x, x, ones], dim=-1)
    raise ValueError(f"unknown mean function {kind!r}; expected one of {_KINDS}")


def mean_value(x: torch.Tensor, w: torch.Tensor, kind: str) -> torch.Tensor:
    """m(x; w) = w . phi(x); x: (..., D), w: (F,) -> (...)."""
    if kind == "zero":
        return x.new_zeros(x.shape[:-1])
    return mean_features(x, kind) @ w
