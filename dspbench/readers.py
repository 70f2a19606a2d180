"""What the per-layer readers share: per-call device time, roofline shares
and the device's idle share, from the traced segment's summaries
(``trace.py``).  A reader that finds nothing to read returns None, and the
metric is left out of the line."""

from __future__ import annotations

from dspbench.roofline import bound_s
from dspbench.trace import device_s


def per_call_ms(ctx, match):
    """Device ms a call of the operations ``match`` accepts, the mean over
    the ranks; None where none ran."""
    values = []
    for t in ctx.traces:
        s, n = device_s(t, match)
        if n:
            values.append(s / t["calls"] * 1e3)
    return sum(values) / len(values) if values else None


def roofline(ctx, kernel: str):
    """The call's least time (its algorithm's work, ``roofline.py``) over
    the device time a call of the kernels named ``kernel``, in %."""
    ms = per_call_ms(ctx, lambda name: kernel in name)
    if ms is None:
        return None
    w = ctx.work
    return 100.0 * bound_s(w["flops"], w["bytes"]) / (ms * 1e-3)


def idle_share(ctx):
    """The share of the traced window in which no operation ran on the
    device, in %, the mean over the ranks."""
    if not all(t["busy_s"] > 0 for t in ctx.traces):
        return None
    return 100.0 * sum(1.0 - t["busy_s"] / t["window_s"]
                       for t in ctx.traces) / len(ctx.traces)


def step_mfu(ctx):
    """The call's least time over the traced window's wall time a call: the
    share of the card's roofline the whole call reaches, in %, the mean
    over the ranks."""
    if not all(t["busy_s"] > 0 for t in ctx.traces):
        return None
    w = ctx.work
    least = bound_s(w["flops"], w["bytes"])
    return 100.0 * sum(least / (t["window_s"] / t["window_calls"])
                       for t in ctx.traces) / len(ctx.traces)
