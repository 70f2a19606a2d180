"""The port's pulse-Doppler radar (``models/radar.py``: ``range_doppler_map``
then ``cfar_ca`` along range) against the benchmark's plain reference
(``dspbench/reference/pulse_doppler.py``: ``torch.fft`` in float64, box sums
by a cumulative sum) on seeded scenes, on the CPU: 2 beams x 16 pulses x
256 range samples with a 16-tap chirp, and 2 x 128 x 256, whose 128-point
Doppler transform is the small-DFT route's (``ops/fft._dft_last``).

Tolerances:

- float64: the map to 1e-12 of its largest cell, the thresholds to 1e-12
  of the largest threshold (the reference's cumulative sums cancel terms
  as large as the map's whole row), the detections equal wherever the
  reference's power lies outside 1e-9 of its threshold.
- float32: each beam's map at a relative RMS error of at most 2e-5, the
  benchmark's limit ``rdm_rel_err``.  Float32 transforms of a few thousand
  points read 2.2e-7 here (2.3e-7 at 2 x 128 x 4096 with 128 taps); products
  with TF32's 10-bit significand (unit roundoff 4.9e-4) read 5e-4, so the
  limit lies about 90x above the one and 25x below the other.  The
  detections equal wherever the reference's power lies outside 1e-4 of its
  threshold, the benchmark's ``det_band``: closer than that, float32
  rounding may decide either way.
"""

import math

import numpy as np
import pytest
import torch

from dspbench.reference import pulse_doppler as ref
from simpledsp_tpu_torch.models import radar
from simpledsp_tpu_torch.ops.spectral import window_taps

GUARD, TRAIN, PFA = 2, 12, 1e-5
BANDWIDTH = 0.8
F32_MAP = 2e-5
F32_BAND = 1e-4

SHAPES = [(2, 16, 256, 16), (2, 128, 256, 16)]   # beams, pulses, N, taps
SEEDS = [3, 2 ** 31 + 11]


def scene(seed, beams, pulses, samples, taps, targets=4):
    """(B, P, N) complex128 CPIs: unit-power complex Gaussian noise and
    ``targets`` chirp echoes a beam, each at a delay below N - K, on a
    Doppler bin, at a per-sample SNR of -20 to +10 dB and a phase, all
    drawn from the seed."""
    g = torch.Generator().manual_seed(seed)
    shape = (beams, pulses, samples)
    z = torch.complex(torch.randn(shape, generator=g, dtype=torch.float64),
                      torch.randn(shape, generator=g, dtype=torch.float64))
    z = z * math.sqrt(0.5)
    tx = ref.chirp(taps, BANDWIDTH)
    p = torch.arange(pulses, dtype=torch.float64)[:, None]
    for b in range(beams):
        for _ in range(targets):
            u = torch.rand(4, generator=g, dtype=torch.float64).tolist()
            delay = int(u[0] * (samples - taps))
            dop = int(u[1] * pulses)
            amp = 10.0 ** ((-20.0 + 30.0 * u[2]) / 20.0)
            turn = torch.polar(torch.full_like(p, amp),
                               2 * math.pi * (dop * p / pulses + u[3]))
            z[b, :, delay:delay + taps] += turn * tx
    return z


def port(z, taps, dtype):
    tx_re, tx_im = radar.lfm_chirp(taps, BANDWIDTH)
    power = radar.range_doppler_map(z.real.to(dtype), z.imag.to(dtype),
                                    tx_re, tx_im, window="hann")
    det, thresh = radar.cfar_ca(power, guard=GUARD, train=TRAIN, pfa=PFA)
    return power.double(), det, thresh.double()


def reference(z, taps, tf32=False):
    return ref.detect(z, taps=taps, bandwidth=BANDWIDTH, guard=GUARD,
                      train=TRAIN, pfa=PFA, tf32=tf32)


def beam_errors(got, want):
    """Each beam's relative RMS error of its map."""
    err = ((got - want) ** 2).sum(dim=(-2, -1))
    return torch.sqrt(err / (want ** 2).sum(dim=(-2, -1)))


def mismatches(got_det, power, det, thresh, band):
    outside = (power - thresh).abs() > band * thresh
    return int(((got_det != det) & outside).sum())


def test_the_chirp_and_the_window_are_the_ports():
    for taps, bw in ((16, 0.8), (128, 0.8), (511, 1.0)):
        tx_re, tx_im = radar.lfm_chirp(taps, bw)
        tx = ref.chirp(taps, bw)
        np.testing.assert_allclose(tx.real.numpy(), tx_re, rtol=0,
                                   atol=1e-15)
        np.testing.assert_allclose(tx.imag.numpy(), tx_im, rtol=0,
                                   atol=1e-15)
    for n in (16, 128, 255):
        np.testing.assert_allclose(ref.hann(n).numpy(),
                                   window_taps("hann", n), rtol=0,
                                   atol=1e-15)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_float64_map_and_detections_match_the_reference(shape, seed):
    beams, pulses, samples, taps = shape
    z = scene(seed, *shape)
    power, det, thresh = port(z, taps, torch.float64)
    want, want_det, want_thresh = reference(z, taps)
    assert power.shape == want.shape == (beams, pulses, samples)
    assert float((power - want).abs().max()) <= 1e-12 * float(want.max())
    assert float((thresh - want_thresh).abs().max()) <= 1e-12 * float(
        want_thresh.max())
    assert mismatches(det, want, want_det, want_thresh, 1e-9) == 0
    assert int(want_det.sum()) > 0


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_float32_map_and_detections_within_the_benchmarks_limits(shape,
                                                                  seed):
    _, _, _, taps = shape
    z = scene(seed, *shape)
    power, det, _ = port(z, taps, torch.float32)
    want, want_det, want_thresh = reference(z, taps)
    assert float(beam_errors(power, want).max()) <= F32_MAP
    assert mismatches(det, want, want_det, want_thresh, F32_BAND) == 0


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_tf32_products_fail_the_float32_tolerance(shape, seed):
    _, _, _, taps = shape
    z = scene(seed, *shape)
    want, _, _ = reference(z, taps)
    low, _, _ = reference(z, taps, tf32=True)
    assert float(beam_errors(low, want).min()) > F32_MAP


def test_the_tf32_rounding_keeps_ten_bits_to_nearest_even():
    one = 1.0
    ulp = 2.0 ** -10
    a = torch.tensor([one, one + ulp / 4, one + ulp / 2, one + 3 * ulp / 2,
                      -(one + 3 * ulp / 4), 3.0e-3], dtype=torch.float32)
    got = ref.round_tf32(a).tolist()
    assert got[:5] == [one, one, one, one + 2 * ulp, -(one + ulp)]
    mant = math.frexp(got[5])[0] * 2 ** 11
    assert mant == round(mant) and abs(got[5] - 3.0e-3) <= 3.0e-3 * 2 ** -11
