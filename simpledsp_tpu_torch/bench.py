"""The headline benchmark: the north-star chain's throughput on the card.

Port of the JAX package's root ``bench.py``.  Workload (BASELINE.md): an
8th-order (4-section) Butterworth low-pass IIR into framed 4096-point real
FFTs, streaming with the IIR state carried from call to call, 64 channels
x 2^20 float32 samples a call.  Baseline: 47.1 Msamples/s, BASELINE.md's
single-core C++ float64 core.

    python -m simpledsp_tpu_torch bench [--device cpu]

Prints ONE JSON line on stdout:
  {"metric": ..., "value": N, "unit": "Msamples/s", "vs_baseline": N,
   "detail": {...}}

Before timing, the chain's warm-up output is held to the float64 scipy
oracle (``sosfilt`` + numpy ``rfft``, packed) on channels 0-1: below
130 dB the run stops with ``SystemExit``.  After the JSON line, the
compiled-path smoke (``tools/smoke.py``: the chain against the oracle,
``ShardedNorthStarChain`` on a mesh of one against the serial chain, a
dp-sharded FM bank against the serial bank) runs in a subprocess, its
stdout sent to stderr, writing its record to ``build/smoke.json``; a
failed smoke exits nonzero after the JSON line.  ``SDSP_SKIP_SMOKE=1``
skips it.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from simpledsp_tpu_torch.device import resolve_device

__all__ = ["BASELINE_MSPS", "METRIC", "main", "run_smoke", "device_name"]

BASELINE_MSPS = 47.1  # BASELINE.md north-star chain, 1 Xeon core
METRIC = "northstar_chain_8sos_iir_4096fft_throughput"
MIN_PARITY_DB = 130.0


def device_name(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them
    (``name, power.limit``), its name from torch where nvidia-smi is
    absent; ``str(device)`` off the card."""
    if device.type != "cuda":
        return str(device)
    try:
        lines = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        lines = []
    index = device.index or 0
    if index < len(lines):
        return lines[index].strip()
    return torch.cuda.get_device_name(device)


def run_smoke(device: torch.device) -> int:
    """``tools/smoke.py`` in a fresh process (its own builds and device
    handle) on ``device``; its stdout goes to stderr so that the benchmark
    prints exactly one stdout line."""
    from simpledsp_tpu_torch.tools.smoke import default_out_path
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "simpledsp_tpu_torch.tools.smoke",
         str(default_out_path()), "--device", str(device)],
        cwd=root, stdout=sys.stderr, stderr=sys.stderr, timeout=900)
    return proc.returncode


def _parity_snr(chain, x, x_host: np.ndarray) -> float:
    """SNR (dB) of the chain's first channels, those of ``x_host``, against
    the float64 scipy oracle (``sosfilt`` + ``rfft``, packed
    halfcomplex)."""
    import scipy.signal as sig

    from simpledsp_tpu_torch.design.biquad import sos_matrix

    (sr, si), _ = chain(x)
    k, nh = x_host.shape[0], chain.fft_size // 2
    got = (sr[:k].double().cpu().numpy()
           + 1j * si[:k].double().cpu().numpy())
    y64 = sig.sosfilt(sos_matrix(chain.design),
                      x_host.astype(np.float64), axis=-1)
    ref = np.fft.rfft(y64.reshape(k, -1, chain.fft_size))
    packed = ref[..., :nh].copy()
    packed[..., 0] += 1j * ref[..., nh].real
    err = got - packed
    return float(10 * np.log10((np.abs(packed) ** 2).sum()
                               / max((np.abs(err) ** 2).sum(), 1e-300)))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(*, channels: int = 64, samples: int = 1 << 20, device=None,
         iters: int = 16, loops: int = 5) -> dict:
    """Run the benchmark and print its JSON line; returns the record.
    The defaults are the JAX ``bench.py``'s; the keywords let a test run
    it small on the CPU."""
    from simpledsp_tpu_torch.models.northstar import NorthStarChain
    from simpledsp_tpu_torch.ops.iir import iir_init

    dev = resolve_device(device)
    chain = NorthStarChain(fft_size=4096, block_size=256,
                           dtype=torch.float32, device=dev)
    rng = np.random.default_rng(0)
    x_host = rng.standard_normal((channels, samples)).astype(np.float32)
    # Uploaded pre-framed (C, F, n1, n2) on the kernel path: the samples in
    # the kernel's tiling, as a streaming producer would emit them.
    x = chain.frame_input(x_host)
    s0 = iir_init(chain.design.nsections, (channels,), dtype=torch.float32,
                  device=dev)

    chain(x, s0)                      # warm-up
    _sync(dev)

    # Every run first holds the kernel path to the float64 oracle.
    snr_db = _parity_snr(chain, x, x_host[:2])
    if snr_db < MIN_PARITY_DB:
        raise SystemExit(f"compiled-path parity FAILED: {snr_db:.1f} dB < "
                         f"{MIN_PARITY_DB:.0f} dB")

    def one_loop() -> float:
        s = s0
        _sync(dev)
        start = time.perf_counter()
        for _ in range(iters):
            out, s = chain(x, s)
        # The chained state orders the calls; one sync waits for them all.
        _sync(dev)
        t_loop = time.perf_counter() - start
        # Less the cost of a sync on an idle device.
        start = time.perf_counter()
        _sync(dev)
        t_sync = time.perf_counter() - start
        return max(t_loop - t_sync, 1e-9) / iters

    dt = statistics.median(one_loop() for _ in range(loops))
    msps = channels * samples / dt / 1e6
    result = {
        "metric": METRIC,
        "value": round(msps, 1),
        "unit": "Msamples/s",
        "vs_baseline": round(msps / BASELINE_MSPS, 2),
        "detail": {
            "channels": channels, "samples_per_channel": samples,
            "seconds_per_call": round(dt, 6),
            "device": device_name(dev),
            "dtype": "float32",
            "parity_snr_db": round(snr_db, 1),
            "baseline": f"{BASELINE_MSPS} Msamples/s (1 Xeon core, f64 C++)",
        },
    }
    print(json.dumps(result), flush=True)

    if not os.environ.get("SDSP_SKIP_SMOKE"):
        rc = run_smoke(dev)
        if rc != 0:
            raise SystemExit(f"smoke FAILED (rc={rc}); see stderr and "
                             f"build/smoke.json")
        print("smoke OK (build/smoke.json)", file=sys.stderr)
    return result
