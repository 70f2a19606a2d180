"""One run of one cell: set-up, the measured window, the traced segment, the
check against the reference, and the result line.

A run:

1. builds the port's object of the cell's configuration (its kernels load
   from ``build/`` in the checkout, built there on the first run);
2. makes the pool of input blocks on the card from the seed;
3. warms up on the cell's own shapes (``warmup_calls`` calls);
4. measures for ``--seconds``: calls submitted in turn over the pool, the
   state carried, either dispatched ahead with at most ``in_flight`` calls
   on the card (an event a call) or each waited for before the next
   (``dispatch``: ``ahead`` or ``blocking``);
5. with ``--trace 1``, profiles ``trace_calls`` more calls the same way
   (the traced window leaves out the first ``trace_skip``);
6. once the window has closed and the peak memory has been read, compares
   what kept calls produced with the reference: a call drawn from the
   seed early in the window (a few rows drawn from the seed), the last call
   of the window and, traced, the last call of the segment (every row).

Set-up runs from the start of the process to the first timed call.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import os
import sys
import time
from typing import Callable, Optional

from dspbench.inputs import draw
from dspbench.registry import ROOT, Registry
from dspbench.window import Window

FORBIDDEN = ("jax", "jaxlib", "flax", "simpledsp_tpu")


def boot_clock() -> float:
    """Seconds on the clock that process start times are read on."""
    return time.clock_gettime(time.CLOCK_BOOTTIME)


def process_start() -> float:
    """This process's start on :func:`boot_clock`, from
    ``/proc/self/stat``."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return int(fields[19]) / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def worse(a: float, b: float) -> float:
    """The worse of two readings of a number compared with its limit; a
    reading that is not a number (a NaN in an output) counts as
    infinite, so that it fails every limit and hides no other reading."""
    return max(math.inf if a != a else a, math.inf if b != b else b)


def worst_row(err, norm) -> float:
    """The largest of the rows' relative RMS errors ``sqrt(err / norm)``;
    a row whose error is not a number (a NaN or an infinity in the output)
    reads infinite."""
    import numpy as np
    rel = np.sqrt(np.asarray(err) / np.asarray(norm))
    return float(np.where(np.isfinite(rel), rel, np.inf).max())


def set_cache_dirs(root=ROOT) -> None:
    """Every kernel cache of the program inside the checkout, at fixed
    paths (the port's own nvcc builds go to ``build/`` beside it)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")


@dataclasses.dataclass
class Cell:
    """A cell's entries and files, with any sizes a test changes."""

    name: str
    entry: dict
    config: dict
    params: dict
    traffic: dict
    system: object
    reference: object

    @classmethod
    def load(cls, registry: Registry, name: str, params: dict = None,
             traffic: dict = None) -> "Cell":
        """The cell ``name`` of ``BENCHMARK.json``."""
        return cls.from_entry(registry, registry.cell(name), params, traffic)

    @classmethod
    def from_entry(cls, registry: Registry, entry: dict, params: dict = None,
                   traffic: dict = None) -> "Cell":
        """The cell of a ``workloads`` entry, its configuration's
        parameters and its mix updated by ``params`` and ``traffic``."""
        config = registry.config(entry["config"])
        return cls(entry["name"], entry, config,
                   dict(config["params"], **(params or {})),
                   dict(registry.traffic(entry["traffic"]), **(traffic or {})),
                   registry.system(config["system"]),
                   registry.reference(config["reference"]))


class _Device:
    """Waiting on the device: CUDA events, or nothing to wait for on the
    CPU (where the tests run a cell small)."""

    def __init__(self, device):
        import torch
        self.device, self.torch = device, torch
        self.cuda = device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize(self.device)

    def event(self):
        if not self.cuda:
            return None
        ev = self.torch.cuda.Event()
        ev.record()
        return ev

    def peak_bytes(self) -> int:
        return (int(self.torch.cuda.max_memory_allocated(self.device))
                if self.cuda else 0)


def _loop(sut, pool, state, g: int, traffic: dict, dev: _Device,
          stop: Callable[[int], bool], keep: int, span) -> tuple:
    """Submit calls from global call index ``g`` until ``stop(n)``; returns
    (state, calls made, the output of call ``keep`` or None, the last
    output, the next index, start, end, host seconds inside the calls)."""
    blocking = traffic["dispatch"] == "blocking"
    depth = traffic.get("in_flight", 1)
    pending = collections.deque()
    kept = out = None
    n, inside = 0, 0.0
    start = time.perf_counter()
    while not stop(n):
        if not blocking and len(pending) >= depth:
            with span("dspbench.wait"):
                pending.popleft().synchronize()
        with span("dspbench.call"):
            t = time.perf_counter()
            out, state = sut.call(pool[g % len(pool)], state)
            inside += time.perf_counter() - t
        if blocking:
            with span("dspbench.sync"):
                dev.sync()
        else:
            ev = dev.event()
            if ev is not None:
                pending.append(ev)
        if g == keep:
            kept = out
        g += 1
        n += 1
    with span("dspbench.sync"):
        dev.sync()
    return state, n, kept, out, g, start, time.perf_counter(), inside


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, *,
             mesh=None, stop_window: Optional[Callable] = None,
             before_window: Optional[Callable] = None,
             fault: Optional[Callable] = None, control: bool = False
             ) -> dict:
    """Run a cell on ``device`` (or this rank's part of it on ``mesh``) and
    check it.  ``stop_window(n, start)`` ends the window (default: after
    ``seconds``), ``before_window()`` runs just before it (the ranks of a
    pod meet there), ``fault`` wraps the system's call (tests plant a
    broken step with it) and ``control`` puts the cell's control in the
    program's place.  Returns one rank's plain record."""
    traffic, dev = cell.traffic, _Device(device)
    sut = cell.system.System(cell.params, traffic, device, mesh)
    if fault is not None:
        sut.call = fault(sut.call)
    with (cell.system.control(sut) if control else contextlib.nullcontext()):
        return _run(cell, sut, seed, seconds, trace, device, dev,
                    stop_window, before_window)


def _run(cell, sut, seed, seconds, trace, device, dev, stop_window,
         before_window) -> dict:
    from torch.profiler import record_function

    traffic = cell.traffic
    blocks = traffic["pool"]
    pool = sut.pool(seed, blocks)
    state = sut.init_state()
    g = 0
    for _ in range(traffic["warmup_calls"]):
        out, state = sut.call(pool[g % blocks], state)
        g += 1
    del out
    dev.sync()
    if stop_window is None:
        def stop_window(n, start):
            return time.perf_counter() - start >= seconds
    keep = g + draw(seed, "kept call", traffic["keep_within"], 1)[0]
    if before_window is not None:
        before_window()
    first = boot_clock()
    t0 = time.perf_counter()
    state, calls, early, last, g, start, end, inside = _loop(
        sut, pool, state, g, traffic, dev, lambda n: stop_window(n, t0),
        keep, lambda name: contextlib.nullcontext())
    window = Window(start, end, calls, sut.samples_per_call)
    if early is None:
        raise RuntimeError(f"the window made {calls} calls, too few to "
                           f"reach the kept call {keep} (keep_within "
                           f"{traffic['keep_within']})")
    kept = [(keep, early, sut.rows(seed, last=False)),
            (g - 1, last, sut.rows(seed, last=True))]
    del early, last
    summary = None
    if trace:
        n_traced = traffic["trace_calls"]
        from dspbench.trace import profiled, summarize
        with profiled(device) as prof:
            state, _, _, traced_last, g, *_ = _loop(
                sut, pool, state, g, traffic, dev,
                lambda n: n >= n_traced, -1, record_function)
        summary = summarize(prof, n_traced, traffic["trace_skip"])
        kept.append((g - 1, traced_last, sut.rows(seed, last=True)))
        del traced_last
    peak = dev.peak_bytes()
    del pool, state
    failed, compared, numbers = 0, 0, {}
    for entry in kept:
        got = sut.check(seed, blocks, [entry], cell.reference)
        compared += got["compared"]
        over = False
        for name, value in got["numbers"].items():
            numbers[name] = worse(numbers.get(name, 0.0), value)
            over |= not value <= cell.config["limits"][name]
        failed += over
    return {"window": list(window), "call_host_s": inside,
            "first_call": first,
            "attempted": calls + (traffic["trace_calls"] if trace else 0),
            "failed": failed, "compared": compared, "numbers": numbers,
            "memory_peak_bytes": peak, "trace": summary, "work": sut.work()}
