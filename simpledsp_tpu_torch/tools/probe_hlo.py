"""Which kernels and copies does a public call launch beside its hand kernel?

Port of ``tools/probe_hlo.py``, whose Pallas body (:17, call :21) is y = 2x
over (16384, 32, 128) float32 frames; the probe dumped the compiled HLO
around it to find the layout copies XLA hid there.  On the card the
counterpart of that HLO is a ``torch.profiler`` trace of the device:

1. ``kernels.probes.scale_copy`` alone on the same frames, held to its plain
   version bit for bit: its trace must hold exactly one kernel and no copy;
   beside it the one PyTorch call of the same function, ``x * 2.0``.
2. One call each, after one call to warm up, of ``NorthStarChain`` (64 x
   2^20 float32, N = 4096), ``FMReceiverBank.__call__`` (16 x 2^20 I/Q),
   ``fftconvolve`` (256 x 65536, 301 taps, "same"), ``stft_ri`` (64 x
   262144, nfft 4096, hop 2048) and ``range_doppler_map`` (16 x 256 x 4096
   complex I/Q, a 512-sample chirp): PERF.md's cells.  Every kernel and
   copy on the device is listed by name with its device time, the
   package's own CUDA kernels marked as such.

All of them are traced in one profiler session, each call in a
``record_function`` range, synchronized before the next and with a margin
of idle time on both sides; a device event belongs to the call whose range
started last before it.

    python -m simpledsp_tpu_torch.tools.probe_hlo
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from simpledsp_tpu_torch.kernels import probes
from simpledsp_tpu_torch.tools._common import (cuda_device, main, randn,
                                               require, same_bits)

# The __global__ functions of csrc/: a device event whose name holds one of
# them is one of the package's own kernels.
HAND_KERNELS = ("chain_natural_kernel", "chain_regs_kernel", "pfb_kernel", "sum_partials_kernel",
                "ols_frames_kernel", "conv2d_valid_kernel", "fft_frames_kernel",
                "scale_copy_kernel", "permute_kernel", "contract_kernel",
                "row_sum_kernel", "cfar_ca_kernel", "doppler_power_kernel")

# Idle seconds before each call inside its range and after it outside: the
# trace's host and device timestamps may disagree, and without a margin a
# kernel launched at once after its range began was seen before that
# range, in the previous call's work (once in about ten runs on the H100).
# A margin of 1 ms still let a call's first kernel through to its
# neighbour in one full run of chip_smoke.py on the H100; 50 ms costs a
# tenth of a second a traced call.
MARGIN_S = 5e-2


def device_events(calls: dict) -> dict:
    """Run each of ``calls`` (name: call) once, in turn, under one profiler
    session (a second session in one process recorded no device activity
    on the card), each call synchronized before the next.  Returns name:
    [{name, kind, count, device_us}] summed by event name, kind "hand" (the
    package's kernels), "copy" (memcpy / memset) or "kernel"."""
    labels = {f"probe_hlo: {name}": name for name in calls}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for label, name in labels.items():
            with record_function(label):
                time.sleep(MARGIN_S)
                calls[name]()
                torch.cuda.synchronize()
            time.sleep(MARGIN_S)
    events = list(prof.events())
    starts = sorted((e.time_range.start, labels[e.name]) for e in events
                    if e.name in labels
                    and e.device_type == torch.autograd.DeviceType.CPU)
    require(len(starts) == len(calls), f"the profiler saw {len(starts)} of "
                                       f"{len(calls)} calls")
    total = {name: defaultdict(float) for name in calls}
    count = {name: defaultdict(int) for name in calls}
    for e in events:
        # The ranges show on the device's timeline too: not work of a call.
        if e.device_type != torch.autograd.DeviceType.CUDA or e.name in labels:
            continue
        # The call whose range started last before the event did; an event
        # that started before the first call's range is no call's work.
        i = bisect.bisect_right(starts, (e.time_range.start, "\uffff")) - 1
        if i < 0:
            continue
        owner = starts[i][1]
        total[owner][e.name] += e.time_range.elapsed_us()
        count[owner][e.name] += 1
    require(any(total.values()), "the profiler recorded no device activity")
    out = {}
    for name in calls:
        out[name] = []
        for ev, us in sorted(total[name].items(), key=lambda kv: -kv[1]):
            kind = ("copy" if ev.startswith(("Memcpy", "Memset"))
                    else "hand" if any(k in ev for k in HAND_KERNELS)
                    else "kernel")
            out[name].append({"name": ev, "kind": kind,
                              "count": count[name][ev], "device_us": us})
    return out


def _public_calls(dev: torch.device) -> dict:
    """name: a call of the public entry at PERF.md's sizes."""
    from simpledsp_tpu_torch.models import radar
    from simpledsp_tpu_torch.models.northstar import NorthStarChain
    from simpledsp_tpu_torch.models.sdr import FMReceiverBank
    from simpledsp_tpu_torch.ops.conv import fftconvolve
    from simpledsp_tpu_torch.ops.spectral import stft_ri

    chain = NorthStarChain(fft_size=4096, device=dev)
    xc = randn((64, 1 << 20), 10, dev)
    bank = FMReceiverBank(16, fs=1.6e6, device=dev)
    iq = (randn((16, 1 << 20), 11, dev), randn((16, 1 << 20), 12, dev))
    xs = randn((256, 1 << 16), 13, dev)
    taps = np.random.default_rng(301).standard_normal(301)
    xt = randn((64, 262144), 14, dev)
    tx_re, tx_im = radar.lfm_chirp(512, 0.8)
    pr, pi = randn((16, 256, 4096), 15, dev), randn((16, 256, 4096), 16, dev)
    return {
        "NorthStarChain 64 x 2^20, N = 4096": lambda: chain(xc),
        "FMReceiverBank.__call__ 16 x 2^20": lambda: bank(iq),
        "fftconvolve 256 x 65536, 301 taps, same":
            lambda: fftconvolve(xs, taps, "same"),
        "stft_ri 64 x 262144, nfft 4096, hop 2048":
            lambda: stft_ri(xt, 4096, hop=2048),
        "range_doppler_map 16 x 256 x 4096":
            lambda: radar.range_doppler_map(pr, pi, tx_re, tx_im),
    }


def run(device=None) -> dict:
    dev = cuda_device(device)
    x3 = randn((16384, 32, 128), 0, dev)
    same_bits(probes.scale_copy(x3), probes.scale_reference(x3),
              "scale_copy (16384, 32, 128)")
    calls = {"scale_copy alone": lambda: probes.scale_copy(x3),
             "x * 2.0": lambda: x3 * 2.0,
             **_public_calls(dev)}
    for fn in calls.values():
        fn()                                      # tables, plans, builds
    traced = device_events(calls)
    alone = traced.pop("scale_copy alone")
    require(len(alone) == 1 and alone[0]["kind"] == "hand"
            and alone[0]["count"] == 1,
            f"scale_copy alone launched more than its kernel: {alone}")
    library = traced.pop("x * 2.0")
    return {"scale_copy_alone": alone, "library": library, "calls": {
        name: {"hand_us": sum(e["device_us"] for e in ev
                              if e["kind"] == "hand"),
               "beside_us": sum(e["device_us"] for e in ev
                                if e["kind"] != "hand"),
               "events": ev} for name, ev in traced.items()}}


if __name__ == "__main__":
    main(run)
