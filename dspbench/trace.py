"""The traced run: a profiler over a segment of calls, reduced to what the
per-layer readers need.

The harness wraps each call, each wait for a call in flight and the final
synchronize in spans of its own (``dspbench.call``, ``dspbench.wait``,
``dspbench.sync``).  The traced window runs from the span of the call
after the first ``skip`` (the profiler's own start is not the program's)
to the end of the last synchronize.  The reduction keeps, for one rank:

- every device operation's seconds and count by name over all the traced
  calls (kernels, copies and sets; the spans' own marks on the device's
  timeline are not work);
- the seconds in which some operation ran on the device (the union of
  their intervals inside the window);
- the idle gaps of the device inside the window, each put down to what
  the host was doing when it began: the innermost host event running then.

All of it is plain numbers, so that the ranks of a pod can send theirs to
rank 0.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict

SPAN_CALL = "dspbench.call"
SPAN_WAIT = "dspbench.wait"
SPAN_SYNC = "dspbench.sync"
SPANS = (SPAN_CALL, SPAN_WAIT, SPAN_SYNC)

TOP = 10            # entries of each list of the breakdown
_SCAN = 256         # host events looked back over to place a gap


@contextlib.contextmanager
def profiled(device):
    """A profiler of the host and, on a card, of the device."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof


def summarize(prof, calls: int, skip: int) -> dict:
    """The reduction of one rank's traced segment of ``calls`` calls, its
    window starting at call ``skip``."""
    from torch.autograd import DeviceType

    host, device, spans = [], [], []
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CPU:
            host.append((start, end, e.name))
            if e.name in SPANS:
                spans.append((start, end, e.name))
        elif not (e.name in SPANS or getattr(e, "is_user_annotation", False)
                  or e.name.startswith("nccl:")):
            # Ranges drawn on the device's timeline (the spans, and the
            # "nccl:<op>" range that covers each collective's kernel) are
            # not work of their own.
            device.append((start, end, e.name))
    starts = sorted(s[0] for s in spans if s[2] == SPAN_CALL)
    if len(starts) != calls or not 0 <= skip < calls:
        raise RuntimeError(f"the trace holds {len(starts)} call spans of "
                           f"{calls} (skip {skip})")
    lo, hi = starts[skip], max(s[1] for s in spans)
    by_name = defaultdict(lambda: [0.0, 0])
    for start, end, name in device:
        by_name[name][0] += (end - start) * 1e-6
        by_name[name][1] += 1
    busy, gaps = _busy_and_gaps(device, lo, hi)
    return {
        "calls": calls,
        "window_calls": calls - skip,
        "window_s": (hi - lo) * 1e-6,
        "busy_s": busy * 1e-6,
        "device": {k: v for k, v in by_name.items()},
        "gaps": _place_gaps(gaps, host),
    }


def _busy_and_gaps(device: list, lo: float, hi: float):
    """The union of the device intervals clipped to [lo, hi], and the idle
    intervals between them."""
    busy, gaps = 0.0, []
    cursor = lo
    for start, end, _ in sorted(device):
        start, end = max(start, lo), min(end, hi)
        if end <= start:
            continue
        if start > cursor:
            gaps.append((cursor, start))
        if end > cursor:
            busy += end - max(start, cursor)
            cursor = end
    if hi > cursor:
        gaps.append((cursor, hi))
    return busy, gaps


def _place_gaps(gaps: list, host: list) -> dict:
    """Seconds of device idle by the innermost host event running at each
    gap's start (the latest-starting one that covers it)."""
    host = sorted(host)
    starts = [h[0] for h in host]
    out = defaultdict(float)
    for g0, g1 in gaps:
        i = bisect.bisect_right(starts, g0) - 1
        name = "(no host event)"
        for j in range(i, max(-1, i - _SCAN), -1):
            if host[j][1] >= g0:
                name = host[j][2]
                break
        out[name] += (g1 - g0) * 1e-6
    return dict(out)


# -- what the readers take from the summaries ------------------------------

def device_s(summary: dict, match) -> tuple:
    """(seconds, count) of the device operations whose name ``match``
    accepts."""
    s = n = 0
    for name, (sec, count) in summary["device"].items():
        if match(name):
            s += sec
            n += count
    return s, n


def breakdown(summaries: list) -> dict:
    """The device operations that took most time and the longest idle gaps
    by what the host was doing, summed over the ranks and divided by their
    number."""
    ops, gaps = defaultdict(float), defaultdict(float)
    for s in summaries:
        for name, (sec, _) in s["device"].items():
            ops[name] += sec / len(summaries)
        for name, sec in s["gaps"].items():
            gaps[name] += sec / len(summaries)

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:TOP]]
    return {"device_ops": top(ops), "idle_gaps": top(gaps)}
