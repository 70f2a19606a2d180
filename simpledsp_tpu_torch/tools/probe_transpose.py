"""How fast do (B, T) flat streams become channel-major (B, M, nfr) frames?

Port of ``tools/probe_transpose.py``, whose Pallas body (:82, call :116)
reads (L, M) tiles of the (B, nfr, M) view of 16 streams through a 2-slot
DMA ring, transposes them in registers and packs P streams into one
(P M, L) output tile, giving (B / P, P M, nfr), for (P, L) = (8, 2048),
(8, 8192) and (1, 8192); B = M = 16, nfr = 65536 + 128 (the PFB frames
path's input layout).  The packed output is the (B, M, nfr) tensor itself,
viewed, so on the card P and L only shape the work of a block:
``kernels.probes.permute(x, rows_per_block=L, batch_per_block=P)`` gives
each block L rows of P streams, through a 32 x 33 shared-memory tile.  Each
form, and the default of one 32-row tile a block, is held bit for bit to
``x.view(b, nfr, m).transpose(-1, -2).contiguous()`` and timed beside it
(ms, median of 5 CUDA-event timings, and GB/s read + write).

    python -m simpledsp_tpu_torch.tools.probe_transpose
"""

from __future__ import annotations

from simpledsp_tpu_torch.kernels import probes
from simpledsp_tpu_torch.tools._common import (HBM_BPS, cuda_device, main,
                                               median_ms, randn, same_bits)

B, M = 16, 16
NFR = (1 << 16) + 128          # output frames + the halo pad
FORMS = ((8, 2048), (8, 8192), (1, 8192), (1, 32))   # (P, L)


def run(device=None) -> dict:
    dev = cuda_device(device)
    x = randn((B, NFR * M), 0, dev)
    x3 = x.view(B, NFR, M)
    moved = 2 * x.numel() * x.element_size()

    def torch_t():
        return x3.transpose(-1, -2).contiguous()

    want = torch_t()
    out = []
    for p, lt in FORMS:
        def kernel(p=p, lt=lt):
            return probes.permute(x3, rows_per_block=lt, batch_per_block=p)
        same_bits(kernel().view(B // p, p * M, NFR),
                  want.view(B // p, p * M, NFR), f"permute P={p} L={lt}")
        ms = median_ms(kernel)
        out.append({"P": p, "L": lt, "ms": ms, "gbps": moved / ms / 1e6,
                    "share_of_hbm": moved / (ms * 1e-3) / HBM_BPS})
    torch_ms = median_ms(torch_t)
    return {"forms": out,
            "torch_transpose": {"ms": torch_ms, "gbps": moved / torch_ms / 1e6}}


if __name__ == "__main__":
    main(run)
