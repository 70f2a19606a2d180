"""What does one launch cost on the card, against the size of its grid?

Port of ``tools/probe_dispatch.py``, whose Pallas body (:30, call :35) is
y = 2x on one (8, 128) float32 tile at grid 1 / 16 / 256 / 1024, every grid
step the same block, timed against a tiny XLA function and a 4096 x 4096
matmul: the fixed cost of an executable on the TPU.  Here the tile is
rewritten by ``kernels.probes.scale_copy(x, same_tile_blocks=G)``
(``csrc/probes.cu``) with G = 1 / 16 / 256 / 1024 blocks, held to its plain
version bit for bit, and timed against:

- ``x * 2.0 + 1.0`` in torch on the same tile (two launches);
- the same G = 1 launch replayed from a ``torch.cuda.CUDAGraph``, one launch
  a graph and 16 launches a graph;
- ``torch.matmul`` of 4096 x 4096 float32 in IEEE mode, then a row sum (the
  JAX probe's baseline).

Since launch cost is what it measures, each gets the host wall clock a
call (200 calls back to back, synchronized at the end: the host's enqueue
rate where that is slower than the card) beside the card's time a call
(CUDA events, 200 calls a window), both medians of 5.

    python -m simpledsp_tpu_torch.tools.probe_dispatch
"""

from __future__ import annotations

import numpy as np
import torch

from simpledsp_tpu_torch.kernels import probes
from simpledsp_tpu_torch.precision import ieee_fp32
from simpledsp_tpu_torch.tools._common import (capture_graph, cuda_device,
                                               host_us, main, median_ms, randn,
                                               same_bits)

GRIDS = (1, 16, 256, 1024)
ITERS = 200
GRAPH_LAUNCHES = 16


def run(device=None) -> dict:
    dev = cuda_device(device)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (8, 128)).astype(np.float32), device=dev)
    big = randn((4096, 4096), 1, dev)

    def matmul():
        with ieee_fp32():
            return torch.matmul(big, big).sum(1, keepdim=True)

    # name: (call, calls a timing, launches a call)
    arms = {"torch x * 2.0 + 1.0": (lambda: x * 2.0 + 1.0, ITERS, 1)}
    for g in GRIDS:
        same_bits(probes.scale_copy(x, same_tile_blocks=g), x * 2.0,
                  f"scale_copy same tile, {g} blocks")
        arms[f"scale_copy same tile, grid {g}"] = (
            lambda g=g: probes.scale_copy(x, same_tile_blocks=g), ITERS, 1)
    one = capture_graph(lambda: probes.scale_copy(x, same_tile_blocks=1), 1)
    many = capture_graph(lambda: probes.scale_copy(x, same_tile_blocks=1),
                  GRAPH_LAUNCHES)
    arms["CUDA graph replay, 1 launch"] = (one.replay, ITERS, 1)
    arms[f"CUDA graph replay, {GRAPH_LAUNCHES} launches"] = (
        many.replay, ITERS // GRAPH_LAUNCHES, GRAPH_LAUNCHES)
    arms["torch.matmul 4096^2 IEEE fp32 + row sum"] = (matmul, 5, 1)
    out = []
    for name, (fn, iters, per) in arms.items():
        out.append({"arm": name,
                    "host_us": host_us(fn, iters) / per,
                    "device_us": median_ms(fn, per=iters) * 1e3 / per})
    return {"arms": out}


if __name__ == "__main__":
    main(run)
