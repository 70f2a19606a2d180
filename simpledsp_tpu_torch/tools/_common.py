"""What the probes share: the card they measure, CUDA-event and host timing,
checks that raise, and the command-line entry; and what ``chain_stages``
uses to split a kernel by stage: sources edited into a directory of their
own and builds run all at once.  The card's peaks are the benchmark's
(``dspbench/roofline.py``).

A probe measures the card, so it runs on a CUDA device or raises: there is
no CPU version of a probe (the CPU tests hold the kernels' plain versions
instead).
"""

from __future__ import annotations

import json
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from dspbench.roofline import HBM_BYTES_PER_S as HBM_BPS
from simpledsp_tpu_torch.device import resolve_device

__all__ = ["HBM_BPS", "cuda_device", "median_ms", "capture_graph",
           "graph_ms", "host_us", "require", "same_bits", "randn", "record",
           "main", "edited_csrc", "build_all"]

REPS = 5


def cuda_device(device=None) -> torch.device:
    """``device`` (None: CUDA) as a CUDA ``torch.device``; raises
    RuntimeError for any other device or where there is no card."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"a probe measures the card and runs on a CUDA "
                           f"device, got {dev}")
    return dev


def median_ms(fn: Callable, reps: int = REPS, per: int = 1) -> float:
    """Median over ``reps`` CUDA-event timings of ``per`` back-to-back calls
    of ``fn``, in ms a call, after one call to warm up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / per)
    return float(np.median(times))


def capture_graph(fn: Callable, calls: int) -> torch.cuda.CUDAGraph:
    """``calls`` calls of ``fn`` captured in one CUDA graph (after one call
    outside the capture to warm up)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return graph


def graph_ms(fn: Callable, per: int = 20, reps: int = REPS) -> float:
    """Median over ``reps`` CUDA-event timings of a CUDA graph that replays
    ``per`` calls of ``fn``, in ms a call: the device's time for a call too
    small to hide the host's launch cost, without that cost."""
    return median_ms(capture_graph(fn, per).replay, reps=reps) / per


def host_us(fn: Callable, iters: int = 200, reps: int = REPS) -> float:
    """Median over ``reps`` of the host wall clock of ``iters`` calls of
    ``fn`` (synchronized before and after), in microseconds a call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) / iters * 1e6)
    return float(np.median(times))


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"probe check failed: {what}")


def same_bits(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """Raises unless ``got`` equals ``want`` bit for bit; returns the max
    |err| (0.0)."""
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"{what}: {tuple(got.shape)} {got.dtype} against "
            f"{tuple(want.shape)} {want.dtype}")
    require(bool(torch.equal(got, want)), f"{what}: not equal bit for bit")
    return float((got - want).abs().max()) if got.numel() else 0.0


def randn(shape, seed: int, device: torch.device) -> torch.Tensor:
    """Standard normal float32 of ``shape`` made on ``device`` from
    ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device)


def record(ms: float, plain_ms: float, library_ms: float, max_abs_err: float,
           moved: int, flops: float, device_ms: Optional[float] = None,
           library_device_ms: Optional[float] = None) -> dict:
    """The numbers a kernel's line in ``chip_smoke.py`` takes from a probe:
    its time, its plain version's and one PyTorch call's, its error, and the
    bytes it must move and the operations it must do (for the bound); with
    ``device_ms`` also the kernel's and the PyTorch call's CUDA-graph
    (device) times."""
    out = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "max_abs_err": max_abs_err, "bytes": int(moved),
           "flops": float(flops)}
    if device_ms is not None:
        out.update(device_ms=device_ms, library_device_ms=library_device_ms)
    return out


def main(run: Callable) -> None:
    """Run a probe on the card and print its result as JSON, with the card's
    name and power limit."""
    dev = cuda_device()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({"card": torch.cuda.get_device_name(dev),
                      "nvidia_smi": smi, **run(dev)}, indent=1))


def edited_csrc(checkout: Path,
                edits: Optional[Dict[str, Sequence[Tuple[str, str]]]],
                tag: str) -> Path:
    """The csrc directory of ``checkout`` with ``edits`` ({source: [(text,
    replacement), ...]}, each text replaced once; an empty text prepends
    its replacement), written to ``build/<tag>``; the directory as it is
    when ``edits`` is None."""
    csrc = checkout / "simpledsp_tpu_torch" / "csrc"
    if edits is None:
        return csrc
    d = checkout / "build" / tag
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(csrc, d)
    for source, pairs in edits.items():
        text = (csrc / source).read_text()
        for old, new in pairs:
            if old not in text:
                raise RuntimeError(f"{tag}: its edit of {source} does not "
                                   f"apply")
            text = text.replace(old, new, 1)
        (d / source).write_text(text)
    return d


def build_all(commands: Sequence[Sequence[str]], what: str) -> None:
    """Run every command at once (each builds a library at first use) and
    raise unless all exit 0."""
    builds = [subprocess.Popen(list(c), stdout=subprocess.DEVNULL)
              for c in commands]
    if any([b.wait() for b in builds]):
        raise RuntimeError(f"{what}: a build failed")
