"""Timing and profiling helpers.

Port of ``simpledsp_tpu/utils/benchmark.py``: wall-clock timing of a step
function in the two patterns that matter on an accelerator, and the
one-line JSON record a benchmark prints.

* ``time_blocked``: latency per call, waiting for every call: what a
  request / response caller sees, launch overhead included.
* ``time_streaming``: throughput of a streaming step, the state chained and
  one wait at the end: what a pipeline sees, where the device's work hides
  the host's launches.

CUDA launches return before the device finishes, so each measurement ends
in ``torch.cuda.synchronize`` on the result's device; on the CPU the work is
done when the call returns.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import torch

from simpledsp_tpu_torch.utils.host import tree_leaves

__all__ = ["time_blocked", "time_streaming", "emit_metric", "trace"]


def _force(out) -> None:
    """Wait until ``out`` is computed: synchronize the device of its first
    CUDA tensor leaf (a device runs its stream in order, so this bounds
    everything queued before it)."""
    for leaf in tree_leaves(out):
        if torch.is_tensor(leaf) and leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
            return


def time_blocked(fn: Callable, *args, iters: int = 10,
                 warmup: int = 1) -> float:
    """Mean seconds per call, waiting for every call's result (launch
    latency included: the request / response view)."""
    for _ in range(warmup):
        _force(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        _force(fn(*args))
    return (time.perf_counter() - t0) / iters


def time_streaming(step: Callable, x, state, iters: int = 16,
                   warmup: int = 1) -> float:
    """Mean seconds per call of a streaming step ``(y, state') = step(x,
    state)``, the state chained and one wait at the end, less the time of
    one more wait: launch latency hidden, the pipeline view."""
    out, s = step(x, state)
    for _ in range(warmup - 1):
        out, s = step(x, s)
    _force((out, s))
    s = state
    t0 = time.perf_counter()
    for _ in range(iters):
        out, s = step(x, s)
    _force((out, s))
    t_loop = time.perf_counter() - t0
    t0 = time.perf_counter()
    _force((out, s))
    t_wait = time.perf_counter() - t0
    return max(t_loop - t_wait, 1e-9) / iters


def emit_metric(metric: str, value: float, unit: str,
                baseline: Optional[float] = None,
                detail: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Print (and return) the one-line JSON record of a benchmark."""
    rec: Dict[str, Any] = {"metric": metric, "value": round(value, 2),
                           "unit": unit}
    if baseline:
        rec["vs_baseline"] = round(value / baseline, 2)
    if detail:
        rec["detail"] = detail
    print(json.dumps(rec))
    return rec


@contextlib.contextmanager
def trace(dirname: Optional[str] = None):
    """``torch.profiler`` over the body (the CPU, and CUDA where there is
    a card), written as a Chrome trace ``trace-<ns>.json`` into ``dirname``
    (default: ``simpledsp_tpu_torch_trace`` in the temporary directory);
    view it in Perfetto or ``chrome://tracing``.  Yields ``dirname``.

    The profiler turns the port's spans on (``utils/tracing.py``), so the
    trace also shows each ``sdsp.*`` layer range (the chain's and the
    bank's entry, prepass, copies and kernel launches, the sharded chain's
    wraps and exchange) on the host's timeline above the kernels it
    launched."""
    dirname = dirname or os.path.join(tempfile.gettempdir(),
                                      "simpledsp_tpu_torch_trace")
    os.makedirs(dirname, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield dirname
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(dirname, f"trace-{time.time_ns()}.json"))
