"""What every walkthrough shares: its command line, its device and dtype,
a generator seeded like the JAX example's key, and its figures drawn only
where matplotlib is installed."""

from __future__ import annotations

import argparse
import time

import torch

from gpmpc_tpu_torch.utils.device import resolve_device
from gpmpc_tpu_torch.utils.plotting import MatplotlibMissing


def device_dtype(device=None):
    """The example's device (default: the card; raises without one) and its
    dtype: f32 on the card, as the JAX examples run on the TPU, f64 on the
    CPU, as they run on the CPU with x64."""
    dev = resolve_device(device)
    return dev, (torch.float64 if dev.type == "cpu" else torch.float32)


def generator(device, seed: int) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (the JAX example's
    ``PRNGKey`` number; torch draws other numbers from it)."""
    return torch.Generator(device=device).manual_seed(seed)


def clock(device) -> float:
    """``time.perf_counter()`` once the device has finished its work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def draw(plot, *args, **kwargs) -> bool:
    """Call a plotting function; where matplotlib is missing print that no
    figure was written and carry on.  Returns whether it drew."""
    try:
        plot(*args, **kwargs)
    except MatplotlibMissing as e:
        print(f"no figure written: {e}")
        return False
    return True


def run_cli(main, doc: str, batch: bool = False):
    """The examples' command line: ``--quick``, ``--cpu`` (f64 on the CPU;
    default f32 on the card) and, with ``batch``, ``--batch N``."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="small sizes for a fast run")
    ap.add_argument("--cpu", action="store_true",
                    help="f64 on the CPU (default: f32 on the CUDA card)")
    if batch:
        ap.add_argument("--batch", type=int, help="rollouts (B)")
    a = ap.parse_args()
    kw = dict(batch=a.batch) if batch else {}
    main(a.quick, "cpu" if a.cpu else None, **kw)
