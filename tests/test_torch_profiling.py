"""The port's tracing and timing helpers (``gpmpc_tpu_torch/utils/
profiling.py``) on the CPU: ``time_fn``'s (min, median), ``slope_time``
on a length-parameterized loop, and ``trace`` writing a Chrome trace."""

import json
import time

import torch

from gpmpc_tpu_torch.utils import profiling


def test_time_fn_min_at_most_median():
    a = torch.randn(64, 64, dtype=torch.float64)
    lo, med = profiling.time_fn(torch.linalg.inv, a, reps=7, warmup=2)
    assert 0.0 < lo <= med


def test_slope_time_is_the_per_iteration_cost():
    """A loop of k sleeps of 2 ms: the slope between 2 and 12 iterations
    is positive, and near 2 ms (sleep overshoots, so at least 2 ms and
    well under the fixed cost a call adds)."""
    calls = []

    def run(k):
        calls.append(k)
        time.sleep(0.005)              # a fixed cost the slope cancels
        for _ in range(k):
            time.sleep(0.002)

    per_iter = profiling.slope_time(run, 2, 12, reps=3)
    assert 0.0019 < per_iter < 0.005
    assert calls.count(2) == calls.count(12) == 4      # warm-up + reps


def test_trace_writes_a_chrome_trace(tmp_path):
    a = torch.randn(32, 32)
    with profiling.trace(str(tmp_path / "trace")) as prof:
        for _ in range(3):
            a = torch.tanh(a @ a)
    names = {e.key for e in prof.key_averages()}
    assert "aten::tanh" in names and "aten::mm" in names
    events = json.loads(open(prof.trace_path).read())["traceEvents"]
    assert any(e.get("name") == "aten::tanh" for e in events)
    assert prof.trace_path.startswith(str(tmp_path / "trace"))
