"""The work of one pulse-Doppler call, counted from its shapes: the
algorithm's, whatever kernels, formulations or launches implement it
(``roofline.py`` holds the card's peaks).

A call maps B beams of P pulses of N complex range samples with a K-tap
chirp: a forward and an inverse FFT of L points a pulse (L the power of two
at or above N + K - 1), the spectral product, the window, a P-point FFT a
(beam, range cell), the power, and the CFAR's sum over 2 T training cells,
its scale and its compare.
"""

from __future__ import annotations

import math

from dspbench.roofline import F32


def fft_flops(n: int) -> float:
    """The usual count of one complex N-point transform: 5 N log2 N."""
    return 5.0 * n * math.log2(n)


def range_length(samples: int, taps: int) -> int:
    """The transform length of the linear correlation: the power of two at
    or above N + K - 1."""
    return 1 << (samples + taps - 2).bit_length()


def range_transforms_work(beams: int, pulses: int, samples: int,
                          taps: int) -> dict:
    """The range transforms alone (the frames FFT kernel's share): a forward
    and an inverse L-point FFT of each pulse, each reading its L complex
    input values and writing its L output values once."""
    length = range_length(samples, taps)
    rows = beams * pulses
    return {"flops": 2.0 * rows * fft_flops(length),
            "bytes": 2.0 * rows * length * 2 * 2 * F32}


def pulse_doppler_work(beams: int, pulses: int, samples: int, taps: int,
                       train: int) -> dict:
    """One call: B x P x N complex samples as (re, im) float32 in, the
    float32 power map and the one-byte detection mask out.

    Operations: the two range transforms of each pulse, the spectral
    product (6 a bin), the window (2 a complex sample), the P-point Doppler
    FFT of each (beam, range cell), the power (3 a cell), and the CFAR's
    2 T - 1 adds of its training cells, its scale and its compare (2 T + 1
    a cell).  Bytes: the I/Q read once, the map and the mask written
    once.  ``range_flops`` and ``range_bytes`` are
    :func:`range_transforms_work`'s."""
    length = range_length(samples, taps)
    rows = beams * pulses
    cells = rows * samples
    rng = range_transforms_work(beams, pulses, samples, taps)
    flops = (rng["flops"] + 6.0 * rows * length + 2.0 * cells
             + beams * samples * fft_flops(pulses) + 3.0 * cells
             + (2.0 * train + 1.0) * cells)
    nbytes = cells * (2 * F32 + F32 + 1)
    return {"flops": float(flops), "bytes": float(nbytes),
            "range_flops": rng["flops"], "range_bytes": rng["bytes"]}
