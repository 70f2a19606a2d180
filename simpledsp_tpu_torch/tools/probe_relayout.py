"""Which half-spectrum store should the chain use on the card?

Port of ``tools/probe_relayout.py``.  Its Pallas kernel (``make_relayout``
:27, body :33, call :44) reorders (n1, F, n2) k1-major rows into the
natural-order (F, n2/2, n1) re and im planes: t = x.transpose(1, 2, 0),
re = t[:, :n2/2], im = t[:, n2/2:], as a pass of its own after a chain
kernel that skips its in-register reorder; the probe timed that pair
against the "reg" and "k1" + XLA transpose arms on the 64 x 2^20 chain at
N = 4096, state chained over 8 calls, arms interleaved.

Here the reorder is ``kernels.probes.permute`` (``csrc/probes.cu``), and the
arms are the port's half-spectrum stores, each through
``fused_chain_frames(..., half_spectrum=True)`` on 64 x 2^20 float32
samples a call, N = 4096, the state chained over 8 calls, the arms in turn
for 5 rounds (ms a call: median of the rounds, CUDA events):

- ``reg``: the chain kernel's natural-order store;
- ``regw``: the same in 16-byte vector stores;
- ``fmajor``: the kernel's k1-major rows, then the torch transpose of
  ``kernels/chain.py`` (the JAX "k1" + transpose arm);
- ``fmajor + relayout``: the same kernel output, (F, n1, n2/2) planes read
  through their strides, reordered by ``permute`` (the JAX two-call arm);
  it must equal the ``fmajor`` arm bit for bit.

The relayout kernel alone is also timed in the JAX form, (32, 16384, 128)
-> two (16384, 64, 32) planes, held bit for bit to its plain version,
beside ``x.permute(1, 2, 0).contiguous()``: one call in CUDA events, and
device time in a CUDA graph of 20 calls.

    python -m simpledsp_tpu_torch.tools.probe_relayout
"""

from __future__ import annotations

import numpy as np
import torch

from simpledsp_tpu_torch.kernels import chain as kchain
from simpledsp_tpu_torch.kernels import chain_variants as kcv
from simpledsp_tpu_torch.kernels import probes
from simpledsp_tpu_torch.models.northstar import default_design
from simpledsp_tpu_torch.tools._common import (cuda_device, graph_ms, main,
                                               median_ms, randn, record,
                                               same_bits)

N = 4096
C, T = 64, 1 << 20
CALLS = 8
ROUNDS = 5
N1, F, N2 = 32, 16384, 128     # the JAX relayout's (n1, f, n2) at this chain


def relayout_chain(ops, x: torch.Tensor, s0: torch.Tensor):
    """The half-spectrum chain as the fmajor kernel, then the relayout
    kernel on each plane: ((re, im) (C, F, n2/2, n1), s_final)."""
    x3, s3, s_fin = kchain.chain_prepass(ops, x, s0)
    zr, zi = kcv.chain_frames_store(x3, s3, ops.tables(), "fmajor")
    c, nf = x.shape[0], x3.shape[0] // x.shape[0]
    shape = (c, nf, ops.n2 // 2, ops.n1)
    return (probes.permute(zr).view(shape),
            probes.permute(zi).view(shape)), s_fin


def _window_ms(fn, x, s0) -> float:
    """ms a call of CALLS calls with the state chained, CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    s = s0
    start.record()
    for _ in range(CALLS):
        _, s = fn(x, s)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / CALLS


def run(device=None) -> dict:
    dev = cuda_device(device)
    ops = kchain.FusedNorthStarOperators(default_design(), N, device=dev)
    x = randn((C, T), 0, dev)
    s0 = torch.zeros(C, ops.state_dim, device=dev)

    def entry(layout):
        return lambda xx, ss: kchain.fused_chain_frames(
            ops, xx, ss, half_spectrum=True, layout=layout)

    arms = {"reg": entry("reg"), "regw": entry("regw"),
            "fmajor": entry("fmajor"),
            "fmajor + relayout": lambda xx, ss: relayout_chain(ops, xx, ss)}
    (ar, ai), _ = arms["fmajor"](x, s0)
    (br, bi), _ = arms["fmajor + relayout"](x, s0)
    same_bits(br, ar, "fmajor + relayout re against fmajor")
    same_bits(bi, ai, "fmajor + relayout im against fmajor")
    del ar, ai, br, bi
    times = {name: [] for name in arms}
    for name, fn in arms.items():
        _window_ms(fn, x, s0)                     # warm up
    for _ in range(ROUNDS):
        for name, fn in arms.items():
            times[name].append(_window_ms(fn, x, s0))
    chain_ms = {name: float(np.median(t)) for name, t in times.items()}
    del x

    xj = randn((N1, F, N2), 1, dev)
    view = xj.permute(1, 0, 2)                    # (f, n1, n2), strided
    got = probes.permute(view, split=True)
    want = probes.permute_reference(view, split=True)
    err = max(same_bits(g, w, f"relayout plane {i}")
              for i, (g, w) in enumerate(zip(got, want)))
    def kernel():
        return probes.permute(view, split=True)

    def library():
        return xj.permute(1, 2, 0).contiguous()

    rec = record(median_ms(kernel),
                 median_ms(lambda: probes.permute_reference(view, split=True),
                           reps=3),
                 median_ms(library), err, 2 * xj.numel() * xj.element_size(),
                 0, graph_ms(kernel), graph_ms(library))
    return {"chain_ms": chain_ms,
            "msamples_per_s": {k: C * T / v / 1e3 for k, v in chain_ms.items()},
            "record": rec}


if __name__ == "__main__":
    main(run)
