"""Does the width of a store change the copy rate on the card?

Port of ``tools/probe_store.py``, whose Pallas bodies are ``body_copy``
(:59), y = 2x over wide (16384, 16, 128) and narrow (16384, 64, 32) tiles,
and ``body_regmix`` (:68), y = 2 x^T per frame, (16384, 16, 128) ->
(16384, 128, 16), all at equal bytes (call :32, 64 frames a grid step).  On
the TPU the question was the store rate against the minor width of a tile.
On the card a contiguous copy has no minor width; what it has is the width
of each thread's load and store.  So this probe times:

- the wide and narrow copies with 16-byte vectors
  (``kernels.probes.scale_copy``), and the wide copy with 4-, 8- and
  16-byte vectors;
- regmix as ``kernels.probes.permute`` (a wide load, a transposed store
  through a shared-memory tile);

each held to its plain version bit for bit, each beside the plain version's
time, as ms (median of 5 CUDA-event timings of one call) and device ms (a
CUDA graph of 20 calls), and GB/s read + write and its share of
3.35 TB/s, of the window (``gbps``) and of the device time
(``device_gbps``); beside the wide copy the device times of ``torch.mul``
and ``y.copy_(x)`` (the card's own copy), beside regmix that of
``.transpose(-1, -2).contiguous()`` (a transpose without the scale).

    python -m simpledsp_tpu_torch.tools.probe_store
"""

from __future__ import annotations

import torch

from simpledsp_tpu_torch.kernels import probes
from simpledsp_tpu_torch.tools._common import (HBM_BPS, cuda_device,
                                               graph_ms, main, median_ms,
                                               randn, same_bits)

F = 16384
WIDE, NARROW = (F, 16, 128), (F, 64, 32)


def run(device=None) -> dict:
    dev = cuda_device(device)
    wide, narrow = randn(WIDE, 0, dev), randn(NARROW, 1, dev)
    forms = [(f"wide {WIDE} copy, {v}-byte vectors", wide,
              lambda v=v: probes.scale_copy(wide, vec_bytes=v),
              lambda: probes.scale_reference(wide)) for v in (4, 8, 16)]
    forms.append((f"narrow {NARROW} copy, 16-byte vectors", narrow,
                  lambda: probes.scale_copy(narrow),
                  lambda: probes.scale_reference(narrow)))
    forms.append((f"regmix {WIDE} -> {(F, 128, 16)}, 2 x^T", wide,
                  lambda: probes.permute(wide, 2.0),
                  lambda: probes.permute_reference(wide, 2.0)))
    out = []
    for name, x, kernel, plain in forms:
        same_bits(kernel(), plain(), name)
        ms, dev_ms = median_ms(kernel), graph_ms(kernel)
        moved = 2 * x.numel() * x.element_size()
        out.append({"form": name, "ms": ms, "device_ms": dev_ms,
                    "gbps": moved / ms / 1e6,
                    "share_of_hbm": moved / (ms * 1e-3) / HBM_BPS,
                    "device_gbps": moved / dev_ms / 1e6,
                    "device_share_of_hbm": moved / (dev_ms * 1e-3) / HBM_BPS,
                    "plain_ms": median_ms(plain, reps=3),
                    "plain_device_ms": graph_ms(plain)})
    y = torch.empty_like(wide)
    library = {"wide: torch.mul": graph_ms(lambda: torch.mul(wide, 2.0)),
               "wide: y.copy_(x)": graph_ms(lambda: y.copy_(wide)),
               "regmix: .transpose(-1, -2).contiguous()": graph_ms(
                   lambda: wide.transpose(-1, -2).contiguous())}
    return {"forms": out, "library_device_ms": library}


if __name__ == "__main__":
    main(run)
