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
time, as ms (median of 5 CUDA-event timings), GB/s read + write and the
share of 3.35 TB/s.

    python -m simpledsp_tpu_torch.tools.probe_store
"""

from __future__ import annotations

from simpledsp_tpu_torch.kernels import probes
from simpledsp_tpu_torch.tools._common import (HBM_BPS, cuda_device, main,
                                               median_ms, randn, same_bits)

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
        ms = median_ms(kernel)
        moved = 2 * x.numel() * x.element_size()
        out.append({"form": name, "ms": ms, "gbps": moved / ms / 1e6,
                    "share_of_hbm": moved / (ms * 1e-3) / HBM_BPS,
                    "plain_ms": median_ms(plain, reps=3)})
    return {"forms": out}


if __name__ == "__main__":
    main(run)
