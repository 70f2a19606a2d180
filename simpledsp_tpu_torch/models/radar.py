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

(re, im) float planes end to end, batched over leading axes.  The range
transforms run on the FFT engine (``ops/fft``): on a CUDA float32 tensor
(4096 + 511 samples pad to 8192) the frames FFT kernel, one launch forward
and one inverse.  The TX spectrum is a host float64 constant per waveform,
as in the JAX package.

The Doppler stage (window, FFT across the pulses, power, roll) takes one of
two routes (``kernels/doppler``).  A plain ``torch.Tensor`` in float32 on a
CUDA device, with a power-of-two number of pulses from 16 to 512, runs the
Doppler kernel: one launch that reads the matched filter's output where it
lies and writes the power map once.  The CPU, float64, a ``DTensor`` and
other pulse counts take the plain route (``doppler_power_plain``): the
window, the pulses moved last, the FFT engine across them (the small-DFT
route's fixed-shape products at 128 pulses or fewer; on a card in float32
the frames FFT kernel at 128 m pulses, m >= 2), the power and the roll,
which the CPU tests hold to the JAX package.  The routes agree to float32
rounding, not bit for bit (a radix-2 FFT in registers against the engine's
transforms); each gives a beam, and a range cell, the same bits alone as
inside a batch.

:func:`cfar_ca` takes one of two routes (``kernels/cfar``).  A plain
``torch.Tensor`` in float32 on a CUDA device, with guard + train at most
``MAX_SPAN``, runs the CFAR kernel: one launch that reads each row of the
CFAR axis once and writes the threshold and the mask once (another axis is
moved last in one copy first).  The CPU, float64, a ``DTensor`` and a wider
window take the rolled route, 2 train shifted adds on rolled copies, which
the CPU tests hold to the JAX package.  Both give the same bits.

Spans (``utils/tracing``): ``sdsp.radar.map`` around
:func:`range_doppler_map`, with ``sdsp.radar.range`` (the matched filter)
and ``sdsp.radar.doppler`` (the Doppler stage, either route) inside it;
``sdsp.radar.cfar`` around :func:`cfar_ca`.  Counters: ``radar.maps``
(calls of :func:`range_doppler_map`), ``radar.cells`` (range-Doppler cells
mapped) and ``radar.cfars`` (calls of :func:`cfar_ca`, either route); over
``radar.maps``, ``kernel.doppler.launches`` is the share of maps on the
Doppler kernel, and over ``radar.cfars``, ``kernel.cfar.launches`` the
share of CFARs on the CFAR kernel.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from simpledsp_tpu_torch.kernels import cfar as _cfar
from simpledsp_tpu_torch.kernels import doppler as _doppler
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
            if _doppler.doppler_kernel_supported(yr, n_pulses):
                return _doppler.doppler_power(yr, yi, w)
            return _doppler.doppler_power_plain(yr, yi, w)


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
