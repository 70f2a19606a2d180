"""How fast do (B, T) flat streams become channel-major (B, M, nfr) frames?

Port of ``tools/probe_transpose.py``, whose Pallas body (:82, call :116)
reads (L, M) tiles of the (B, nfr, M) view of 16 streams through a 2-slot
DMA ring, transposes them in registers and packs P streams into one
(P M, L) output tile, giving (B / P, P M, nfr), for (P, L) = (8, 2048),
(8, 8192) and (1, 8192); B = M = 16, nfr = 65536 + 128 (the PFB frames
path's input layout).  The packed output is the (B, M, nfr) tensor itself,
viewed, so on the card P and L only order the work:
``kernels.probes.permute(x, rows_per_block=L, batch_per_block=P)`` makes
L rows of P streams a unit whose tiles (512 rows of one stream, 32 KB)
the kernel's persistent blocks take in turn, a unit after the other.
Each form, and the default of 32-row units, is held bit for bit to
``x.view(b, nfr, m).transpose(-1, -2).contiguous()`` and timed beside it
(ms, median of 5 CUDA-event timings of one call; device ms, a CUDA graph
of 20 calls; and GB/s read + write of each, ``gbps`` and
``device_gbps``).

    python -m simpledsp_tpu_torch.tools.probe_transpose
"""

from __future__ import annotations

from simpledsp_tpu_torch.kernels import probes
from simpledsp_tpu_torch.tools._common import (HBM_BPS, cuda_device,
                                               graph_ms, main, median_ms,
                                               randn, same_bits)

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
        ms, dev_ms = median_ms(kernel), graph_ms(kernel)
        out.append({"P": p, "L": lt, "ms": ms, "device_ms": dev_ms,
                    "gbps": moved / ms / 1e6,
                    "share_of_hbm": moved / (ms * 1e-3) / HBM_BPS,
                    "device_gbps": moved / dev_ms / 1e6,
                    "device_share_of_hbm": moved / (dev_ms * 1e-3) / HBM_BPS})
    torch_ms, torch_dev = median_ms(torch_t), graph_ms(torch_t)
    return {"forms": out,
            "torch_transpose": {"ms": torch_ms, "device_ms": torch_dev,
                                "gbps": moved / torch_ms / 1e6,
                                "device_gbps": moved / torch_dev / 1e6}}


if __name__ == "__main__":
    main(run)
