"""Pulse-Doppler radar processing: matched filter, range-Doppler map,
CA-CFAR detection.

Port of ``simpledsp_tpu/models/radar.py``:

    IQ pulses (..., n_pulses, n_samples)
      -> pulse compression   (the product with the TX waveform's conjugate
                              spectrum between a forward and an inverse FFT
                              of the pulses, zero-padded to a power of two)
      -> Doppler processing  (windowed FFT across the pulse axis)
      -> CA-CFAR             (cell-averaging constant false alarm rate
                              detector; box sums, no gathers)

(re, im) float planes end to end, batched over leading axes.  The
transforms run on the FFT engine (``ops/fft``).  On a CUDA float32 tensor
the range FFTs (4096 + 511 samples pad to 8192) run the frames FFT kernel,
one launch forward and one inverse, and so does a Doppler FFT of 256
pulses or more, a third.  A Doppler FFT of 128 pulses or fewer is below
the kernel's gate (n = 128 m, m >= 2) and takes the small-DFT route
(``ops/fft._dft_last``): fixed-shape products of 2^20 values each, one a
plane and a block of 2^20 / n rows, so that a row's bits do not depend on
its batch.  At 64 beams x 128 pulses x 4096 range cells that is 262,144
rows, 32 blocks and 64 products a call, not one matmul.  The TX spectrum
is a host float64 constant per waveform, as in the JAX package.

:func:`cfar_ca` takes one of two routes (``kernels/cfar``).  A plain
``torch.Tensor`` in float32 on a CUDA device, with guard + train at most
``MAX_SPAN``, runs the CFAR kernel: one launch that reads each row of the
CFAR axis once and writes the threshold and the mask once (another axis is
moved last in one copy first).  The CPU, float64, a ``DTensor`` and a wider
window take the rolled route, 2 train shifted adds on rolled copies, which
the CPU tests hold to the JAX package.  Both give the same bits.

Spans (``utils/tracing``): ``sdsp.radar.map`` around
:func:`range_doppler_map`, with ``sdsp.radar.range`` (the matched filter)
and ``sdsp.radar.doppler`` (the window, the transposes, the Doppler
transform, the power and the roll) inside it; ``sdsp.radar.cfar`` around
:func:`cfar_ca`.  Counters: ``radar.maps`` (calls of
:func:`range_doppler_map`), ``radar.cells`` (range-Doppler cells mapped)
and ``radar.cfars`` (calls of :func:`cfar_ca`, either route); over
``radar.cfars``, the kernel's ``kernel.cfar.launches`` is the share of
CFARs on the kernel.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from simpledsp_tpu_torch.kernels import cfar as _cfar
from simpledsp_tpu_torch.ops import fft as _fft
from simpledsp_tpu_torch.ops.fft import _table
from simpledsp_tpu_torch.ops.spectral import window_taps
from simpledsp_tpu_torch.utils import tracing

__all__ = ["matched_filter_ri", "range_doppler_map", "cfar_ca", "lfm_chirp"]


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def lfm_chirp(n: int, bandwidth: float = 1.0
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Unit-amplitude baseband linear-FM pulse of ``n`` samples sweeping
    ``bandwidth`` of the sample rate, as host float64 (re, im)."""
    if not 0.0 < bandwidth <= 1.0:
        raise ValueError(f"bandwidth must be in (0, 1], got {bandwidth}")
    t = np.arange(n, dtype=np.float64)
    phase = np.pi * bandwidth * (t - n / 2.0) ** 2 / n
    return np.cos(phase), np.sin(phase)


@functools.lru_cache(maxsize=None)
def _tx_spectrum_f64(tx_bytes: bytes, length: int, nfft: int):
    """conj(FFT(tx, nfft)) as float64 (re, im) planes, per waveform."""
    tx = np.frombuffer(tx_bytes, dtype=np.complex128)
    assert tx.size == length
    spec = np.conj(np.fft.fft(tx, nfft))
    return np.ascontiguousarray(spec.real), np.ascontiguousarray(spec.imag)


def matched_filter_ri(xr: torch.Tensor, xi: torch.Tensor,
                      tx_re, tx_im) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pulse compression: correlate each row of (..., n_samples) IQ with the
    known TX waveform (host taps).  Output bin r is the correlation at delay
    r, y[r] = sum_t x[t + r] conj(tx[t]), linear (no circular wrap), length
    n_samples: a point target at delay d compresses to a peak of about L at
    bin d (L the TX length)."""
    n = xr.shape[-1]
    tx = np.asarray(tx_re, dtype=np.float64) \
        + 1j * np.asarray(tx_im, dtype=np.float64)
    if tx.ndim != 1:
        raise ValueError("TX waveform must be 1-D")
    length = tx.size
    if length > n:
        raise ValueError(f"TX length {length} exceeds pulse length {n}")
    m = _next_pow2(n + length - 1)
    with tracing.span("sdsp.radar.range"):
        hr64, hi64 = _tx_spectrum_f64(tx.tobytes(), length, m)
        pad = (0, m - n)
        fr, fi = _fft.fft_ri(torch.nn.functional.pad(xr, pad),
                             torch.nn.functional.pad(xi, pad))
        hr, hi = _table(hr64, xr), _table(hi64, xr)
        yr, yi = _fft.ifft_ri(fr * hr - fi * hi, fr * hi + fi * hr)
        return yr[..., :n], yi[..., :n]


def range_doppler_map(xr: torch.Tensor, xi: torch.Tensor, tx_re, tx_im, *,
                      window: str = "hann") -> torch.Tensor:
    """(..., n_pulses, n_samples) IQ pulse train -> (..., n_pulses,
    n_samples) range-Doppler POWER map: pulse compression along samples,
    windowed FFT across pulses, the Doppler axis shifted so zero velocity
    sits at row n_pulses // 2."""
    if xr.dim() < 2:
        raise ValueError("need (..., n_pulses, n_samples) input")
    with tracing.span("sdsp.radar.map"):
        tracing.count("radar.maps")
        tracing.count("radar.cells", xr.numel())
        yr, yi = matched_filter_ri(xr, xi, tx_re, tx_im)
        with tracing.span("sdsp.radar.doppler"):
            n_pulses = yr.shape[-2]
            w = _table(window_taps(window, n_pulses), yr)[:, None]
            # Doppler FFT across the pulse axis: pulses to the last axis
            # and back.
            dr, di = _fft.fft_ri((yr * w).transpose(-1, -2),
                                 (yi * w).transpose(-1, -2))
            dr, di = dr.transpose(-1, -2), di.transpose(-1, -2)
            return torch.roll(dr * dr + di * di, n_pulses // 2, -2)


def cfar_ca(power: torch.Tensor, *, guard: int = 2, train: int = 8,
            pfa: float = 1e-4,
            axis: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cell-averaging CFAR along ``axis``: each cell's noise level is the
    mean of 2 train training cells flanking a 2 guard + 1 guard region; the
    threshold is alpha noise, alpha = N (pfa^(-1/N) - 1), N = 2 train (the
    exact CA-CFAR constant for exponentially distributed noise power).

    Returns (detections bool mask, threshold map) of ``power``'s shape.
    Edges wrap around (the Doppler axis is circular; for range, a ring
    buffer CFAR).  Two routes with the same bits (module docstring): the
    CFAR kernel for a float32 ``torch.Tensor`` on a CUDA device and a
    window of at most ``kernels/cfar.MAX_SPAN`` cells a side, else 2 train
    shifted adds on rolled copies (``kernels/cfar.cfar_rolled``)."""
    if guard < 0 or train < 1:
        raise ValueError(f"need guard >= 0, train >= 1, got ({guard}, "
                         f"{train})")
    if not 0.0 < pfa < 1.0:
        raise ValueError(f"pfa must be in (0, 1), got {pfa}")
    n = power.shape[axis]
    span = guard + train
    if 2 * span + 1 > n:
        raise ValueError(f"CFAR window 2*(guard+train)+1 = {2 * span + 1} "
                         f"exceeds the axis length {n}")
    with tracing.span("sdsp.radar.cfar"):
        tracing.count("radar.cfars")
        n_train = 2 * train
        alpha = n_train * (pfa ** (-1.0 / n_train) - 1.0)
        x = power.movedim(axis, -1)
        if _cfar.cfar_kernel_supported(power, guard, train):
            det, thresh = _cfar.cfar_kernel(x.contiguous(), guard, train,
                                            alpha)
        else:
            det, thresh = _cfar.cfar_rolled(x, guard, train, alpha)
        return det.movedim(-1, axis), thresh.movedim(-1, axis)
