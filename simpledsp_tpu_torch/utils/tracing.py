"""The port's tracer: counters that are always on, and spans at the
benchmark's layer boundaries that are off unless asked for.

Counters
    :func:`count` adds to a plain dict and :func:`counters` returns a copy.
    Each kernel wrapper's ``launches`` is the counter
    ``kernel.<name>.launches`` (:class:`Launches`), still read and assigned
    as an attribute.  The bank counts its calls (``bank.calls``), those
    whose input reached the PFB kernel where it lay, with no prefixed copy
    (``bank.direct_calls``: ``__call__``'s fused path, also under the
    sharded bank), and the bytes its copies of the new channelizer history
    move (``bank.prefix_bytes``).  The radar counts its maps
    (``radar.maps``: ``kernel.doppler.launches`` over it is the share on
    the Doppler kernel), the range-Doppler cells they map
    (``radar.cells``) and its CFARs (``radar.cfars``, either route:
    ``kernel.cfar.launches`` over it is the share on the CFAR kernel); the
    FFT engine's small-DFT route counts the fixed-shape products it
    launches (``fft.dft_products``).  The channelizer's real-input entry
    counts its calls (``chan.calls``) and the bytes its history
    concatenation and new-history copy read and write
    (``chan.prefix_bytes``).

Spans
    ``with span("sdsp.chain.prepass"):`` marks one layer's part of a call.
    Off, :func:`span` reads two flags and returns one shared null context:
    no clock read, no allocation.  Spans are on while any of these holds:
    :func:`enable` has been called and :func:`disable` has not;
    ``SIMPLEDSP_TRACE=1`` was set when this module was imported; a
    ``torch.profiler`` is running.  On, each span records its name, its
    start and end on ``time.perf_counter_ns``, its parent, a call id (a
    span with no parent opens a new call and its children share it) and
    whether a profiler was running.  Under a profiler each span also opens
    ``torch.profiler.record_function(name)``, so it lies on the profiler's
    clock beside the device's kernels: an idle gap of the device can be put
    down to the innermost span the host was in.

    Spans are kept in memory, the newest :data:`MAX_SPANS`; the counter
    ``tracing.dropped`` counts the older ones let go.  :func:`snapshot`
    gives spans and counters as plain data, :func:`span_stats` each name's
    count, total and self milliseconds, :func:`reset` clears the spans.  A
    Chrome trace with the spans and the kernels on one timeline comes from
    :func:`simpledsp_tpu_torch.utils.benchmark.trace`.

The names the port records, each at its layer's boundary:

- ``sdsp.chain.forward``: ``NorthStarChain.forward``, a call;
- ``sdsp.chain.prepass``: ``kernels/chain.chain_prepass``;
- ``sdsp.chain.launch``: the chain kernel, or its plain version;
- ``sdsp.bank.forward``: ``FMReceiverBank.forward``, a call;
- ``sdsp.bank.prefix``: the bank's new channelizer history (copies of the
  stream's last L-1 samples);
- ``sdsp.pfb.launch``: the PFB kernel, or its plain version;
- ``sdsp.sharded_chain.forward``: ``ShardedNorthStarChain.forward``, a call;
- ``sdsp.sharded_chain.wrap``: a rank's local parts of its inputs;
- ``sdsp.sharded_chain.exchange``: the shard states' all_gather and
  all_reduce;
- ``sdsp.sharded_chain.unwrap``: the outputs placed on the mesh;
- ``sdsp.radar.map``: ``models/radar.range_doppler_map``, a map;
- ``sdsp.radar.range``: its pulse compression (``matched_filter_ri``);
- ``sdsp.radar.doppler``: its Doppler stage (window, transform across the
  pulses, power and roll), the Doppler kernel or its plain version;
- ``sdsp.radar.cfar``: ``cfar_ca``, a span with no parent of its own;
- ``sdsp.chan.forward``: ``PFBChannelizer.process_real``, a call;
- ``sdsp.chan.fir``: its polyphase branch FIRs;
- ``sdsp.chan.fft``: its half-spectrum transform across the branches.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler

__all__ = ["MAX_SPANS", "Launches", "Span", "count", "counters", "disable",
           "enable", "kernel_counter", "reset", "snapshot", "span",
           "span_stats"]

MAX_SPANS = 65536

_ENV = os.environ.get("SIMPLEDSP_TRACE") == "1"
_on = _ENV
_counters: dict = {}
_spans: collections.deque = collections.deque(maxlen=MAX_SPANS)
_ids = itertools.count(1)
_calls = itertools.count(1)
_local = threading.local()
_OFF = contextlib.nullcontext()


# -- counters ----------------------------------------------------------------

def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _counters[name] = _counters.get(name, 0) + n


def counters() -> dict:
    """A copy of every counter."""
    return dict(_counters)


def kernel_counter(name: str) -> str:
    """The launch counter of the kernel wrapper ``name``,
    ``kernel.<name>.launches``, registered at 0."""
    key = f"kernel.{name}.launches"
    _counters.setdefault(key, 0)
    return key


class Launches:
    """A kernel wrapper's ``launches`` attribute, kept in the counter named
    by the wrapper's ``launch_counter`` (:func:`kernel_counter`): read and
    assigned as an integer attribute, as callers that zero the counts do."""

    def __get__(self, obj, owner=None):
        if obj is None:
            return self
        return _counters.get(obj.launch_counter, 0)

    def __set__(self, obj, value: int) -> None:
        _counters[obj.launch_counter] = value


# -- spans -------------------------------------------------------------------

class Span(NamedTuple):
    """One finished span; ``parent`` is 0 for a span that opened its
    call."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int
    call: int
    profiled: bool


def enable() -> None:
    """Record spans until :func:`disable`."""
    global _on
    _on = True


def disable() -> None:
    """Stop what :func:`enable` started (``SIMPLEDSP_TRACE=1`` at import,
    and a running profiler, still turn spans on)."""
    global _on
    _on = _ENV


def span(name: str):
    """A context manager that records the span ``name`` while spans are on,
    and the shared null context while they are off."""
    if not (_on or _profiler._is_profiler_enabled):
        return _OFF
    return _Open(name)


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Open:
    """A span while it runs."""

    __slots__ = ("name", "id", "parent", "call", "profiled", "start",
                 "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        self.id = next(_ids)
        if stack:
            self.parent, self.call = stack[-1].id, stack[-1].call
        else:
            self.parent, self.call = 0, next(_calls)
        self.profiled = _profiler._is_profiler_enabled
        self._range = None
        if self.profiled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter_ns()
        _stack().pop()
        if self._range is not None:
            self._range.__exit__(*exc)
        if len(_spans) == MAX_SPANS:
            count("tracing.dropped")
        _spans.append(Span(self.name, self.start, end, self.id, self.parent,
                           self.call, self.profiled))
        return False


def reset() -> None:
    """Clear the recorded spans."""
    _spans.clear()


def snapshot() -> dict:
    """The recorded spans (oldest first, each a dict of :class:`Span`'s
    fields) and the counters, as plain data."""
    return {"spans": [s._asdict() for s in _spans], "counters": counters()}


def span_stats(profiled_only: bool = False, skip_calls: int = 0) -> dict:
    """``{name: {"count", "total_ms", "self_ms"}}`` over the recorded spans:
    with ``profiled_only`` those recorded under a profiler alone, less the
    first ``skip_calls`` calls among them.  A span's self time is its
    duration less the time its children cover."""
    spans = [s for s in _spans if s.profiled or not profiled_only]
    kept = set(sorted({s.call for s in spans})[skip_calls:])
    spans = [s for s in spans if s.call in kept]
    children = collections.Counter()
    for s in spans:
        if s.parent:
            children[s.parent] += s.end_ns - s.start_ns
    stats: dict = {}
    for s in spans:
        ns = s.end_ns - s.start_ns
        st = stats.setdefault(s.name, {"count": 0, "total_ms": 0.0,
                                       "self_ms": 0.0})
        st["count"] += 1
        st["total_ms"] += ns * 1e-6
        st["self_ms"] += (ns - children[s.id]) * 1e-6
    return stats
