"""Plain float64 reference of the north-star chain: a Butterworth low-pass
biquad cascade, then a real FFT of every frame.

It imports nothing of the program.  The sections are designed again here
from the configuration's parameters, by the closed form of the C++ library
the package was modelled on (``casc_2o_iir.h`` ``set_lp_coeff``), which
equals scipy's ``butter`` + ``zp2sos`` to about 1e-15.  The recursion is
scipy's ``sosfilt`` (the direct-form recursion in C, float64) and the
transform numpy's ``rfft``.

The IIR state that the program carries from call to call is worked out
again from the inputs: the cascade forgets its past geometrically (its
slowest pole has radius :func:`slowest_pole`), so running it over the last
``warm`` samples before a call, from rest, gives the state entering the
call to far below float64 rounding (``tests/test_dspbench_reference.py``
bounds the radius to the power ``warm``).
"""

from __future__ import annotations

import math

import numpy as np
import scipy.signal


def lowpass_sos(sections: int, f0: float, fs: float) -> np.ndarray:
    """(sections, 6) second-order sections of the order-2M Butterworth
    low-pass, the overall gain in the first section's numerator."""
    e0 = 2.0 * math.pi * f0 / fs
    sos = np.zeros((sections, 6))
    gain = 1.0
    for k in range(sections):
        dk = 2.0 * math.sin((2 * k + 1) * math.pi / (4.0 * sections))
        t = dk * math.sin(e0) / 2.0
        beta = (1.0 - t) / (1.0 + t) / 2.0
        gamma = (0.5 + beta) * math.cos(e0)
        gain *= 2.0 * (0.5 + beta - gamma) / 4.0
        sos[k] = (1.0, 2.0, 1.0, 1.0, -2.0 * gamma, 2.0 * beta)
    sos[0, :3] *= gain
    return sos


def slowest_pole(sos: np.ndarray) -> float:
    """The largest pole radius of the cascade."""
    return float(max(np.abs(np.roots(row[3:])).max() for row in sos))


def spectra(sos: np.ndarray, x: np.ndarray, fft_size: int,
            warm: np.ndarray) -> tuple:
    """The packed one-sided spectra of one call.

    x: (C, T) float64, the call's samples; warm: (C, W) the samples just
    before them (W may be 0 at the start of a stream).  Returns (re, im),
    each (C, T / fft_size, fft_size / 2): bins 0 .. N/2 - 1, with the real
    Nyquist bin X[N/2] in the imaginary plane's bin 0 (where Im X[0] is 0).
    """
    c, t = x.shape
    w = warm.shape[1]
    y = scipy.signal.sosfilt(sos, np.concatenate([warm, x], axis=1),
                             axis=1)[:, w:]
    spec = np.fft.rfft(y.reshape(c, t // fft_size, fft_size), axis=-1)
    half = fft_size // 2
    re = spec[..., :half].real.copy()
    im = spec[..., :half].imag.copy()
    im[..., 0] = spec[..., half].real
    return re, im
