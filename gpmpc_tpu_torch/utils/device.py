"""Where the port's objects live when the caller does not say."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; when it is None, the CUDA card.
    Without a card that raises: the port runs on the card unless it is asked
    for the CPU, and never carries on there unasked.  A CUDA device without
    an index gets the current one, so "cuda" and "cuda:0" compare equal."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: gpmpc_tpu_torch runs on the "
                "card by default; pass device=\"cpu\" to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and \
            torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    return device
