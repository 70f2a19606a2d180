"""Where the command-line front end's wall time goes, on the card.

    python3 -m simpledsp_tpu_torch.tools.cli_profile [--out DIR]

Writes inputs of ``chip_smoke.py`` phase 24's sizes into a temporary
directory (2^25 iq16 I/Q pairs, 2^25 float32 samples, 2^23 int16 PCM
samples; noise from fixed seeds: the paths' work does not depend on the
values) and runs ``spectra``, ``fm-rx`` at ``--block-frames`` 1024 and
16384, ``am-rx`` at 16384, ``mfcc`` and ``modem-sim`` (2^20 QPSK symbols)
through ``cli.main`` on the card:

1. once each to warm up;
2. once each in one ``utils.benchmark.trace`` session (a second profiler
   session in one process records no device activity on that machine),
   each run in a ``record_function`` range with idle time on both sides:
   the wall seconds of the range, the card's busy time within it (the
   union of its kernels', copies' and sets' intervals), its share, and
   the device time by kernel or copy name;
3. once each under ``cProfile``: the host functions with the most time of
   their own.

One JSON line a command on stdout, all of them in ``DIR/cli_profile.json``
(default ``chiprun_out``), the Chrome trace beside it in ``DIR/cli_trace``.
"""

from __future__ import annotations

import argparse
import cProfile
import contextlib
import io
import json
import pstats
import subprocess
import tempfile
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from simpledsp_tpu_torch import cli, runtime
from simpledsp_tpu_torch.kernels import chain, pfb
from simpledsp_tpu_torch.tools._common import cuda_device
from simpledsp_tpu_torch.utils.benchmark import trace

PAIRS, SAMPLES, PCM, SYMBOLS = 1 << 25, 1 << 25, 1 << 23, 1 << 20
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def commands(tmp: Path) -> dict:
    """name -> (argv, samples it takes in)."""
    rng = np.random.default_rng(0)
    rng.integers(-20000, 20000, 2 * PAIRS, dtype=np.int16).tofile(
        tmp / "band.iq16")
    rng.standard_normal(SAMPLES, dtype=np.float32).tofile(tmp / "noise.f32")
    rng.integers(-8000, 8000, PCM, dtype=np.int16).tofile(tmp / "speech.pcm")

    def rx(mode, frames):
        return ([f"{mode}-rx", "--input", str(tmp / "band.iq16"), "--output",
                 str(tmp / f"{mode}.npz"), "--rate", "1.024e6",
                 "--block-frames", str(frames)], PAIRS)

    return {
        "spectra": (["spectra", "--input", str(tmp / "noise.f32"),
                     "--output", str(tmp / "spectra.npz"), "--rate",
                     "39000"], SAMPLES),
        "fm-rx 1024": rx("fm", 1024), "fm-rx 16384": rx("fm", 16384),
        "am-rx 16384": rx("am", 16384),
        "mfcc": (["mfcc", "--input", str(tmp / "speech.pcm"), "--output",
                  str(tmp / "mfcc.npz"), "--rate", "16000"], PCM),
        "modem-sim": (["modem-sim", "--symbols", str(SYMBOLS), "--output",
                       str(tmp / "modem.npz")], SYMBOLS * 4 * 6),
    }


def run(argv) -> None:
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    if rc != 0:
        raise RuntimeError(f"cli {argv[0]} exited {rc}")


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -np.inf
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def device_time(trace_file: Path, names) -> dict:
    """name -> (wall us of its range, busy us, {device event: us})."""
    events = json.loads(trace_file.read_text())["traceEvents"]
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("cat") == "user_annotation"
                    and e.get("name") in names)
    starts = [r[0] for r in ranges]
    spans = defaultdict(list)
    by_name = defaultdict(lambda: defaultdict(float))
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        i = int(np.searchsorted(starts, e["ts"], side="right")) - 1
        if i < 0:
            continue
        name = ranges[i][2]
        spans[name].append((e["ts"], e["ts"] + e["dur"]))
        by_name[name][e["name"][:80]] += e["dur"]
    return {name: (b - a, busy_us(spans[name]), dict(by_name[name]))
            for a, b, name in ranges}


def host_profile(argv, top: int = 10) -> list:
    """The ``top`` host functions by time of their own under cProfile."""
    prof = cProfile.Profile()
    prof.enable()
    run(argv)
    prof.disable()
    stats = pstats.Stats(prof)
    rows = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:top]
    return [{"function": f"{Path(f).name}:{line}({fn})", "calls": nc,
             "own_s": round(tt, 6), "cumulative_s": round(ct, 6)}
            for (f, line, fn), (_, nc, tt, ct, _) in rows]


def profile(out: Path) -> list:
    dev = cuda_device()
    with ThreadPoolExecutor() as pool:   # the builds at once, as chip_smoke
        for built in [pool.submit(lib) for lib in (
                chain.chain_kernel.library, pfb.pfb_flat_kernel.library,
                runtime.load_library)]:
            built.result()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp_name:
        cmds = commands(Path(tmp_name))
        for argv, _ in cmds.values():
            run(argv)
        trace_dir = out / "cli_trace"
        with trace(str(trace_dir)):
            for name, (argv, _) in cmds.items():
                time.sleep(0.01)
                with torch.profiler.record_function(name):
                    run(argv)
                time.sleep(0.01)
        trace_file = max(trace_dir.glob("trace-*.json"),
                         key=lambda p: p.stat().st_mtime)
        times = device_time(trace_file, set(cmds))
        records = []
        for name, (argv, samples) in cmds.items():
            wall, busy, by_name = times[name]
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
            rec = {"command": name, "device": str(dev), "card": smi,
                   "samples": samples, "traced_wall_s": wall / 1e6,
                   "device_busy_s": busy / 1e6,
                   "device_busy_share": busy / wall,
                   "msamples_per_s_traced": samples / wall,
                   "device_us_by_name": {k: round(v, 3) for k, v in top},
                   "host_top": host_profile(argv)}
            print(json.dumps(rec))
            records.append(rec)
    (out / "cli_profile.json").write_text(json.dumps(records, indent=1))
    return records


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="chiprun_out",
                        help="directory for cli_profile.json and the trace")
    args = parser.parse_args()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    profile(out)
