"""Is the cost of a copy kernel on the card a fixed cost or a rate?

Port of ``tools/probe_dma_scale.py``, whose Pallas body (:18, calls :26 and
:55) is y = 2x over (f, 32, 128) float32 frames at f = 4096 ... 32768, and
the same copy twice in one program at f = 16384.  Here the copy is
``kernels.probes.scale_copy`` (16-byte vectors, ``csrc/probes.cu``), held to
its plain version bit for bit at every size.  Reported: ms (median of 5
CUDA-event timings of one call, the host's launch inside the window) and
device ms (a CUDA graph of 20 calls, ``graph_ms``), and the read + write
rate at each f, as GB/s and as a share of the card's 3.35 TB/s, of the
one-call window (``gbps``, ``share_of_hbm``) and of the device time
(``device_gbps``, ``device_share_of_hbm``); the least-squares line
ms = fixed + bytes / rate of the window through the four sizes (the fixed
cost is its intercept); two chained launches against one; and at f = 16384 the device times of ``torch.mul`` and of
``y.copy_(x)``, the card's own device-to-device copy and the ceiling of a
copy kernel.  All bounds in PERF.md assume 3.35 TB/s; this is the rate a
copy actually reaches.

    python -m simpledsp_tpu_torch.tools.probe_dma_scale
"""

from __future__ import annotations

import numpy as np
import torch

from simpledsp_tpu_torch.kernels import probes
from simpledsp_tpu_torch.tools._common import (HBM_BPS, cuda_device,
                                               graph_ms, main, median_ms,
                                               randn, record, same_bits)

FRAMES = (4096, 8192, 16384, 32768)
N1, N2 = 32, 128
CHAINED_F = 16384


def run(device=None) -> dict:
    dev = cuda_device(device)
    sizes, chained, rec = [], None, None
    for f in FRAMES:
        x = randn((f, N1, N2), f, dev)
        err = same_bits(probes.scale_copy(x), probes.scale_reference(x),
                        f"scale_copy f={f}")
        ms = median_ms(lambda: probes.scale_copy(x))
        dev_ms = graph_ms(lambda: probes.scale_copy(x))
        moved = 2 * x.numel() * x.element_size()
        sizes.append({"f": f, "bytes": moved, "ms": ms, "device_ms": dev_ms,
                      "gbps": moved / ms / 1e6,
                      "share_of_hbm": moved / (ms * 1e-3) / HBM_BPS,
                      "device_gbps": moved / dev_ms / 1e6,
                      "device_share_of_hbm": moved / (dev_ms * 1e-3)
                      / HBM_BPS})
        if f == CHAINED_F:
            same_bits(probes.scale_copy(probes.scale_copy(x)), x * 4.0,
                      "two chained scale_copy")
            two_ms = median_ms(lambda: probes.scale_copy(probes.scale_copy(x)))
            chained = {"f": f, "one_ms": ms, "two_ms": two_ms,
                       "ratio": two_ms / ms}
            y = torch.empty_like(x)
            copy_ms = graph_ms(lambda: y.copy_(x))
            rec = record(ms, median_ms(lambda: probes.scale_reference(x)),
                         median_ms(lambda: torch.mul(x, 2.0)), err, moved,
                         x.numel(), dev_ms,
                         graph_ms(lambda: torch.mul(x, 2.0)))
            rec["copy_device_ms"] = copy_ms
            del y
        del x
    slope, fixed = np.polyfit([s["bytes"] for s in sizes],
                              [s["ms"] for s in sizes], 1)
    return {"sizes": sizes, "chained": chained,
            "fit": {"fixed_ms": float(fixed), "gbps": float(1e-6 / slope)},
            "record": rec}


if __name__ == "__main__":
    main(run)
