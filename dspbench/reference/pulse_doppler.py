"""Plain reference of the pulse-Doppler radar: pulse compression, a
windowed Doppler transform across pulses, the power map and a cell-averaging
CFAR along range, in float64 on the CPU.

It imports nothing of the program and builds the chirp and the window again
from their formulas.  For one CPI z[p, t] of P pulses of N range samples and
a transmitted pulse tx[k] of K samples:

    tx[k]      = exp(i pi B (k - K/2)^2 / K)                 (LFM chirp)
    y[p, r]    = sum_k z[p, r + k] conj(tx[k])               (z = 0 past N)
    w[p]       = 0.5 - 0.5 cos(2 pi p / P)                   (periodic Hann)
    d[q, r]    = sum_p w[p] y[p, r] exp(-2 pi i q p / P)
    power[(q + P // 2) mod P, r] = |d[q, r]|^2               (zero Doppler at
                                                              row P // 2)
    noise[q, r] = (1 / 2T) sum_{g < |j| <= g + T} power[q, (r + j) mod N]
    thresh     = alpha noise,   alpha = 2T (pfa^(-1 / 2T) - 1)
    det        = power > thresh

with g guard cells and T training cells on each side.  The correlation is
taken with ``torch.fft`` at the power of two L >= N + K - 1, so that it does
not wrap; the Doppler transform is ``torch.fft.fft`` over pulses.  The box
sums are differences of one cumulative sum over the range axis extended
circularly by g + T cells on each side, not shifted copies.

Departures from the port's docstrings (``models/radar.py``:
``matched_filter_ri``, ``range_doppler_map``, ``cfar_ca`` along range,
``lfm_chirp``; ``ops/spectral.window_taps``'s periodic Hann): none.

``tf32=True`` computes the same in float32 with every product's operands
rounded to TF32 (10 bits of significand, to nearest, ties to even), the
precision a matmul takes on the card where TF32 is allowed: each DFT is then
dense products (split four-step above 128 points), the twiddles, the
spectral product, the window, the power and the threshold's scale each
multiply rounded operands, and sums stay float32 (the box sums are taken in
float64 from the rounded power).  It is the control that the comparison has
to fail.
"""

from __future__ import annotations

import math

import torch

__all__ = ["chirp", "hann", "round_tf32", "range_doppler", "cfar", "detect"]

_DENSE = 128        # largest DFT taken as one dense product under tf32


def chirp(taps: int, bandwidth: float) -> torch.Tensor:
    """The unit-amplitude LFM pulse of ``taps`` samples sweeping
    ``bandwidth`` of the sample rate, complex128."""
    t = torch.arange(taps, dtype=torch.float64)
    phase = math.pi * bandwidth * (t - taps / 2.0) ** 2 / taps
    return torch.polar(torch.ones_like(phase), phase)


def hann(n: int) -> torch.Tensor:
    """The periodic Hann window of ``n`` points, float64."""
    p = torch.arange(n, dtype=torch.float64)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * p / n)


def round_tf32(a: torch.Tensor) -> torch.Tensor:
    """Values rounded to TF32's 10-bit significand, to nearest, ties to
    even, as float32 (a complex tensor part by part)."""
    if a.is_complex():
        return torch.complex(round_tf32(a.real), round_tf32(a.imag))
    u = a.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    u = u & 0xFFFFFFFF
    u = (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000
    u = torch.where(u >= 1 << 31, u - (1 << 32), u)
    return u.to(torch.int32).view(torch.float32)


def _dft_tf32(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """The unscaled DFT of complex64 ``x`` along its last axis as products
    of TF32-rounded operands with float32 sums: one dense product up to
    128 points, else n = n1 n2 split four-step (t = n2 t1 + t2, k = k1 +
    n1 k2)."""
    n = x.shape[-1]
    sign = 1.0 if inverse else -1.0
    if n <= _DENSE:
        k = torch.arange(n, dtype=torch.int64)
        ang = (sign * 2.0 * math.pi / n) * ((k[:, None] * k[None, :]) % n)
        w = torch.polar(torch.ones_like(ang), ang).to(torch.complex64)
        return round_tf32(x) @ round_tf32(w)
    n2 = next(d for d in range(_DENSE, 0, -1) if n % d == 0)
    n1 = n // n2
    a = x.reshape(x.shape[:-1] + (n1, n2)).transpose(-1, -2)
    a = _dft_tf32(a, inverse)                                # (.., t2, k1)
    t2 = torch.arange(n2, dtype=torch.int64)[:, None]
    k1 = torch.arange(n1, dtype=torch.int64)[None, :]
    ang = (sign * 2.0 * math.pi / n) * ((t2 * k1) % n)
    tw = torch.polar(torch.ones_like(ang), ang).to(torch.complex64)
    a = round_tf32(a) * round_tf32(tw)
    a = _dft_tf32(a.transpose(-1, -2), inverse)              # (.., k1, k2)
    return a.transpose(-1, -2).reshape(x.shape)


def _fft(x: torch.Tensor, tf32: bool) -> torch.Tensor:
    return _dft_tf32(x, False) if tf32 else torch.fft.fft(x)


def _ifft(x: torch.Tensor, tf32: bool) -> torch.Tensor:
    if not tf32:
        return torch.fft.ifft(x)
    n = x.shape[-1]
    return round_tf32(_dft_tf32(x, True)) * round_tf32(
        torch.tensor(1.0 / n, dtype=torch.float32))


def range_doppler(z: torch.Tensor, tx: torch.Tensor, *,
                  tf32: bool = False) -> torch.Tensor:
    """The power map (..., P, N) float64 of the CPIs ``z`` (..., P, N)
    complex, for the transmitted pulse ``tx`` (K,) complex."""
    n, k = z.shape[-1], tx.shape[-1]
    if k > n:
        raise ValueError(f"a pulse of {k} samples is longer than the "
                         f"{n} range samples")
    length = 1 << (n + k - 2).bit_length()
    ctype = torch.complex64 if tf32 else torch.complex128
    zp = torch.zeros(z.shape[:-1] + (length,), dtype=ctype)
    zp[..., :n] = z
    tp = torch.zeros(length, dtype=ctype)
    tp[:k] = tx
    spec_z, spec_t = _fft(zp, tf32), _fft(tp, tf32).conj()
    if tf32:
        spec_z, spec_t = round_tf32(spec_z), round_tf32(spec_t)
    y = _ifft(spec_z * spec_t, tf32)[..., :n]
    p = z.shape[-2]
    w = hann(p)[:, None]
    if tf32:
        y = round_tf32(y) * round_tf32(w)
    else:
        y = y * w
    d = _fft(y.transpose(-1, -2), tf32).transpose(-1, -2)
    if tf32:
        d = round_tf32(d)
    power = d.real * d.real + d.imag * d.imag
    return torch.roll(power, p // 2, -2).to(torch.float64)


def cfar(power: torch.Tensor, *, guard: int, train: int, pfa: float,
         tf32: bool = False) -> tuple:
    """(detections, thresholds) of the power map along its last axis,
    wrapping around its ends."""
    n = power.shape[-1]
    span = guard + train
    if guard < 0 or train < 1 or 2 * span + 1 > n:
        raise ValueError(f"a window of guard {guard}, train {train} does "
                         f"not fit {n} cells")
    ext = torch.cat([power[..., n - span:], power, power[..., :span]], -1)
    c = torch.nn.functional.pad(torch.cumsum(ext.to(torch.float64), -1),
                                (1, 0))
    # Cell r sits at ext index r + span: its lagging cells are ext[r, r +
    # train) and its leading cells ext[r + span + guard + 1, r + 2 span].
    r = torch.arange(n)
    lag = c[..., r + train] - c[..., r]
    lead = c[..., r + 2 * span + 1] - c[..., r + span + guard + 1]
    n_train = 2 * train
    alpha = n_train * (pfa ** (-1.0 / n_train) - 1.0)
    noise = (lag + lead) / n_train
    if tf32:
        thresh = (round_tf32(torch.tensor(alpha)) * round_tf32(noise)).to(
            torch.float64)
    else:
        thresh = alpha * noise
    return power > thresh, thresh


def detect(z: torch.Tensor, *, taps: int, bandwidth: float, guard: int,
           train: int, pfa: float, tf32: bool = False) -> tuple:
    """(power, detections, thresholds) of the CPIs ``z`` (..., P, N)
    complex: the map and the CFAR along range, for the chirp of ``taps``
    samples and ``bandwidth``."""
    power = range_doppler(z, chirp(taps, bandwidth), tf32=tf32)
    det, thresh = cfar(power, guard=guard, train=train, pfa=pfa, tf32=tf32)
    return power, det, thresh
