"""Tracing and timing helpers.

Counterpart of ``gpmpc_tpu/utils/profiling.py``: (a) a ``torch.profiler``
trace of a block, written as a Chrome trace (CUDA activity beside the
host's when a card is in use), and (b) wall timing with the card
synchronized around each call, including the slope over a
length-parameterized run, which cancels fixed per-call costs (the port's
ensemble step is timed so).
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


def _sync():
    """Wait for the card, where one is in use."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the enclosed block and write
    it to ``log_dir`` as a Chrome trace (``trace_<pid>_<ns>.json``; open
    it in Perfetto or ``chrome://tracing``)::

        with profiling.trace("build/trace") as prof:
            mpc.solve(...)
        prof.key_averages()     # the same events, by operator and kernel

    Yields the profiler; its ``trace_path`` is set once the block ends."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    _sync()
    with profile(activities=acts) as prof:
        yield prof
        _sync()
    prof.trace_path = os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)


def time_fn(fn, *args, reps: int = 10, warmup: int = 1):
    """(min, median) wall seconds of ``fn(*args)``, the card synchronized
    before and after each call."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        ts.append(time.perf_counter() - t0)
    return min(ts), float(np.median(ts))


def slope_time(run_with_length, k1: int, k2: int, reps: int = 5):
    """Seconds per iteration from the slope between the best walls of
    ``run_with_length(k1)`` and ``run_with_length(k2)``: fixed per-call
    costs cancel."""
    def best(k):
        run_with_length(k)
        _sync()
        b = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            run_with_length(k)
            _sync()
            b = min(b, time.perf_counter() - t0)
        return b
    return (best(k2) - best(k1)) / (k2 - k1)
