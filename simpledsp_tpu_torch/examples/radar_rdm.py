"""End-to-end radar scenario through the public API: an LFM pulse train
with two moving targets -> matched filter -> range-Doppler map -> CA-CFAR.

Port of the JAX package's ``examples/radar_rdm.py``, at its sizes: 64
pulses x 512 samples of complex noise (seed 0, sigma 0.05 a plane), a
64-sample ``lfm_chirp(64, 0.8)`` and two targets at (range bin, Doppler
bin, amplitude) (140, +10, 1.0) and (300, -18, 0.7), through
``range_doppler_map`` and ``cfar_ca(guard=2, train=12, pfa=1e-5)``, one
CPI a batch.  Checked: both targets detected within a cell or two of
their (Doppler row, range bin), and detections on fewer than 5e-3 of the
cells.  The JAX script's ``jax.jit`` pipeline is a plain function here.

    python -m simpledsp_tpu_torch.examples.radar_rdm [--device cpu]

On the card the matched filter's 1024-point range transforms run the
frames FFT kernel; the 64-point Doppler transform is the FFT engine's
small-DFT route (fixed-shape products).
"""

from __future__ import annotations

import numpy as np
import torch

from simpledsp_tpu_torch.examples import Laps, parse_device

__all__ = ["run", "check", "main", "scene", "OK", "pipeline", "TARGETS"]

# The line main prints last, once the ground truth held.
OK = "radar end-to-end OK"

N_PULSES, N_SAMP, N_CHIRP = 64, 512, 64
TARGETS = ((140, 10, 1.0), (300, -18, 0.7))   # (delay, Doppler bin, amp)


def scene():
    """(z, tx_re, tx_im): the (pulses, samples) complex128 returns and the
    float64 chirp planes."""
    from simpledsp_tpu_torch.models.radar import lfm_chirp

    rng = np.random.default_rng(0)
    tx_re, tx_im = lfm_chirp(N_CHIRP, 0.8)
    tx = np.asarray(tx_re) + 1j * np.asarray(tx_im)
    z = (rng.standard_normal((N_PULSES, N_SAMP))
         + 1j * rng.standard_normal((N_PULSES, N_SAMP))) * 0.05
    p = np.arange(N_PULSES)
    for delay, dop, amp in TARGETS:
        phase = np.exp(2j * np.pi * dop * p / N_PULSES)[:, None]
        z[:, delay: delay + N_CHIRP] += amp * phase * tx[None, :]
    return z, tx_re, tx_im


def pipeline(ar, ai, tx_re, tx_im):
    """(CPIs, pulses, samples) planes -> (power map, detections)."""
    from simpledsp_tpu_torch.models.radar import cfar_ca, range_doppler_map

    rdm = range_doppler_map(ar, ai, tx_re, tx_im)
    det, _ = cfar_ca(rdm, guard=2, train=12, pfa=1e-5)
    return rdm, det


def run(device=None) -> dict:
    from simpledsp_tpu_torch.device import resolve_device

    laps = Laps()
    dev = resolve_device(device)
    z, tx_re, tx_im = scene()
    xr = torch.as_tensor(z.real, dtype=torch.float32, device=dev)[None]
    xi = torch.as_tensor(z.imag, dtype=torch.float32, device=dev)[None]
    rdm, det = pipeline(xr, xi, tx_re, tx_im)
    rdm = rdm.cpu().numpy()[0]
    det = det.cpu().numpy()[0]
    laps(f"range-Doppler map {rdm.shape}, {int(det.sum())} CFAR detections")

    # Ground truth: each target gives a detection cluster at its (Doppler
    # row, range bin); the matched filter is delay-aligned, so the
    # compressed peak sits at the target's delay bin.
    hits = []
    for delay, dop, _ in TARGETS:
        row = (dop + N_PULSES // 2) % N_PULSES
        patch = det[max(0, row - 1): row + 2, max(0, delay - 2): delay + 3]
        peak_db = float(10 * np.log10(rdm[row, delay] / np.median(rdm)))
        hits.append((bool(patch.any()), peak_db))
    return {"z": z, "tx": (tx_re, tx_im), "rdm": rdm, "det": det,
            "hits": hits, "far": float(det.sum() / det.size), "laps": laps}


def check(out: dict) -> None:
    """The scenario's ground truth."""
    assert all(hit for hit, _ in out["hits"]), "missed target"
    # False-alarm sanity: detections are sparse, clustered on the targets.
    assert out["far"] < 5e-3, out["far"]


def main(argv=None) -> None:
    out = run(parse_device(argv, __doc__.split("\n\n")[0]))
    for line in out["laps"]:
        print(line)
    for (delay, dop, _), (hit, peak_db) in zip(TARGETS, out["hits"]):
        print(f"  target (delay={delay}, doppler={dop:+d}): detected={hit} "
              f"peak {peak_db:.1f} dB over median noise", flush=True)
    print(f"  detection-cell fraction {out['far']:.2e} (pfa 1e-5 + target "
          f"clusters)")
    check(out)
    print(OK)


if __name__ == "__main__":
    main()
