"""Could the chain's frame prefix run inside a kernel on the card?

Port of ``tools/probe_mosaic.py``, whose four Pallas kernels asked whether
Mosaic could lower the building blocks of the frame prefix, and how fast:

- k1 (:36, call :44): (r, j, e) x (j, e, p, d) -> (r, p, d) at HIGHEST,
  (64, 32, 10) x (32, 10, 32, 10): a (64, 320) x (320, 320) product, the
  shape of the prepass's block-Toeplitz combine;
- k2 (:62, call :74): kx = x kt^T over 128 lanes, (64, 32, 128) x
  (10, 128), then concat(sf[:, None], kx[:, :31]) -> (64, 32, 10): the
  per-sub-block projection with its shift;
- k3 (:97, call :101): row sums of (16384, 32, 10) -> (16384, 1), the read
  rate of the packed prefix buffer;
- k4 (:129, call :133, ``main_transpose``): (32, 4096, 128) ->
  (4096, 128, 32), the (1, 2, 0) transpose.

Here k1 and k2 are ``kernels.probes.contract`` (IEEE float32 FMAs on the
CUDA cores, k2 with its shift-in epilogue), k3 ``row_sum`` and k4
``permute``, at the JAX probe's sizes and inputs (numpy seed 0).  k1-k3
are held to their float64 plain versions (>= 120 dB SNR, and no more than
6 dB below the float32 plain version's SNR); k4 bit for bit.  Each is
timed against its float32 plain version and one PyTorch call
(``torch.einsum`` in IEEE float32, ``torch.sum``,
``.permute(1, 2, 0).contiguous()``): ms, the median of 5 CUDA-event
timings, of 20 calls replayed from a CUDA graph for k1-k3 (a few
microseconds of work each, which the host's launch cost would hide); k4
of one call, and of 20 in a CUDA graph as its device time.

To answer the question for the chain: the same pieces are timed at the
64 x 2^20 chain's own sizes (16384 frames at N = 4096: k1 as a (16384, 320)
x (320, 320) product, k2 on (16384 x 32, 128) x (128, 10), k3 as above),
beside ``chain_prepass`` on that chain, which runs them through cuBLAS
(windows of 10 calls); and the two products alone, ``contract`` against
``torch.matmul`` of the same operands in IEEE float32 (cuBLAS), as
CUDA-graph replays of 10 calls: device time.

    python -m simpledsp_tpu_torch.tools.probe_mosaic
"""

from __future__ import annotations

import numpy as np
import torch

from simpledsp_tpu_torch.kernels import chain as kchain
from simpledsp_tpu_torch.kernels import probes
from simpledsp_tpu_torch.models.northstar import default_design
from simpledsp_tpu_torch.precision import ieee_fp32
from simpledsp_tpu_torch.tools._common import (cuda_device, graph_ms, main,
                                               median_ms, randn, record,
                                               require, same_bits)

NB, D = 32, 10
MIN_DB, MAX_DB_BELOW_F32 = 120.0, 6.0


def snr_db(ref: torch.Tensor, got: torch.Tensor) -> float:
    err = float(((got.double() - ref) ** 2).sum())
    return float(10 * np.log10(float((ref ** 2).sum()) / max(err, 1e-300)))


def inputs(device) -> dict:
    """The JAX probe's operands: numpy seed 0, drawn in its order."""
    rng = np.random.default_rng(0)
    shapes = {"kxx": (64, NB, D), "u4": (NB, D, NB, D), "x": (64, NB, 128),
              "sf": (64, D), "kt": (D, 128), "big": (16384, NB, D)}
    return {k: torch.as_tensor(rng.standard_normal(s), dtype=torch.float32,
                               device=device) for k, s in shapes.items()}


def k1(a: dict, plain: bool = False) -> torch.Tensor:
    """k1 on the operands ``a``; ``plain``: through the plain version."""
    f = probes.contract_reference if plain else probes.contract
    return f(a["kxx"].reshape(64, NB * D),
             a["u4"].reshape(NB * D, NB * D)).view(64, NB, D)


def k2(a: dict, plain: bool = False) -> torch.Tensor:
    f = probes.contract_reference if plain else probes.contract
    r = a["x"].shape[0]
    return f(a["x"].reshape(r * NB, 128), a["kt"].T, sf=a["sf"],
             group=NB).view(r, NB, D)


def k3(a: dict, plain: bool = False) -> torch.Tensor:
    f = probes.row_sum_reference if plain else probes.row_sum
    big = a["big"]
    return f(big.reshape(big.shape[0], -1)).view(-1, 1)


def k4(big4: torch.Tensor) -> torch.Tensor:
    return probes.permute(big4.permute(1, 0, 2))


# The one PyTorch call that computes each of k1-k3 (IEEE float32).
LIBRARY = {
    "k1": lambda a: torch.einsum("rje,jepd->rpd", a["kxx"], a["u4"]),
    "k2": lambda a: torch.einsum("rjt,dt->rjd", a["x"], a["kt"]),
    "k3": lambda a: torch.sum(a["big"], dim=(1, 2)),
}


def _library(name: str, a: dict) -> torch.Tensor:
    with ieee_fp32():
        return LIBRARY[name](a)


def run(device=None) -> dict:
    dev = cuda_device(device)
    a32 = inputs(dev)
    a64 = {k: v.double() for k, v in a32.items()}
    out = {}
    for name, fn, moved, flops in (
            ("k1", k1, 4 * (64 * 320 * 2 + 320 * 320), 2 * 64 * 320 * 320),
            ("k2", k2, 4 * (64 * NB * 128 + D * 128 + 64 * D + 64 * NB * D),
             2 * 64 * NB * 128 * D),
            ("k3", k3, 4 * (16384 * NB * D + 16384), 16384 * NB * D)):
        got = fn(a32)
        ref = fn(a64, plain=True)
        require(got.shape == ref.shape and bool(torch.isfinite(got).all()),
                f"{name}: shape {tuple(got.shape)} or values")
        snr, snr32 = snr_db(ref, got), snr_db(ref, fn(a32, plain=True))
        require(snr >= MIN_DB and snr >= snr32 - MAX_DB_BELOW_F32,
                f"{name}: {snr:.2f} dB against the float64 plain version "
                f"(float32 plain {snr32:.2f} dB)")
        out[name] = {"snr_db": snr, "plain_f32_snr_db": snr32,
                     **record(graph_ms(lambda fn=fn: fn(a32)),
                              graph_ms(lambda fn=fn: fn(a32, plain=True)),
                              graph_ms(lambda name=name: _library(name, a32)),
                              float((got.double() - ref).abs().max()),
                              moved, flops)}
    big4 = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (32, 4096, 128)), dtype=torch.float32, device=dev)
    err = same_bits(k4(big4), probes.permute_reference(big4.permute(1, 0, 2)),
                    "k4 (1, 2, 0) transpose")
    out["k4"] = record(median_ms(lambda: k4(big4)),
                       median_ms(lambda: probes.permute_reference(
                           big4.permute(1, 0, 2))),
                       median_ms(lambda: big4.permute(1, 2, 0).contiguous()),
                       err, 2 * big4.numel() * 4, 0,
                       graph_ms(lambda: k4(big4)),
                       graph_ms(lambda: big4.permute(1, 2, 0).contiguous()))
    return {**out, "prefix": prefix_at_chain_size(dev)}


def prefix_at_chain_size(dev) -> dict:
    """The pieces at the 64 x 2^20 chain's sizes (N = 4096) beside
    ``chain_prepass`` on that chain, ms."""
    ops = kchain.FusedNorthStarOperators(default_design(), 4096, device=dev)
    x = randn((64, 1 << 20), 0, dev)
    s0 = torch.zeros(64, ops.state_dim, device=dev)
    prepass_ms = median_ms(lambda: kchain.chain_prepass(ops, x, s0), per=10)
    f = x.numel() // 4096
    d = ops.state_dim
    big = {"kxx": randn((f, ops.n1 * d), 1, dev),
           "u4": randn((ops.n1 * d, ops.n1 * d), 2, dev),
           "x": x.view(f, ops.n1, ops.n2), "kt": randn((d, ops.n2), 3, dev),
           "sf": randn((f, d), 4, dev), "big": randn((f, ops.n1, d), 5, dev)}
    k1_ab = (big["kxx"], big["u4"])
    k2_ab = (big["x"].reshape(f * ops.n1, ops.n2), big["kt"].T)

    def k1_run():
        return probes.contract(*k1_ab)

    def k2_run():
        return probes.contract(*k2_ab, sf=big["sf"], group=ops.n1)

    def matmul(a, b):
        with ieee_fp32():
            return torch.matmul(a, b)

    pieces = {
        "k1": median_ms(k1_run, per=10), "k2": median_ms(k2_run, per=10),
        "k3": median_ms(lambda: probes.row_sum(big["big"].reshape(f, -1)),
                        per=10)}
    device = {"k1": {"contract": graph_ms(k1_run, per=10),
                     "matmul": graph_ms(lambda: matmul(*k1_ab), per=10)},
              "k2": {"contract": graph_ms(k2_run, per=10),
                     "matmul": graph_ms(lambda: matmul(*k2_ab), per=10)}}
    return {"frames": f, "chain_prepass_ms": prepass_ms, "pieces_ms": pieces,
            "pieces_sum_ms": sum(pieces.values()),
            "products_device_ms": device}


if __name__ == "__main__":
    main(run)
