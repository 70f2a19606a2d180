"""Closed-form digital Butterworth biquad-cascade design (host float64 NumPy).

``simpledsp_tpu/design/biquad.py`` carried over unchanged: design runs once on
the host in float64 and yields a frozen :class:`BiquadCascadeDesign` whose
operators the torch ops build as buffers.  Per second-order section,

    beta  = (1 - t) / (2 (1 + t)),   t = d_k sin(e0) / 2
    gamma = (1/2 + beta) cos(e0)
    a = (1, -2 gamma, 2 beta)

with d_k = 2 sin((2k+1) pi / 4M) the Butterworth pole-pair spacing, and the
numerator absorbed into a single input gain (b rows are fixed integer
patterns: LP (1,2,1), HP (1,-2,1), BP (1,0,-1), BS (1, -2cos(e0), 1)).

Beside the Butterworth cascades it holds ``design_bandstop`` (on the port's
own ``design/iir``), ``design_cheby1_lowpass``, ``design_cheby2_lowpass``,
``bp_cutoff_freqs``, ``ba_coefficients``, ``freq_response`` and
``group_delay``, all NumPy and SciPy, so both packages design bit-identical
cascades.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Tuple

import numpy as np

__all__ = [
    "FilterType",
    "BiquadCascadeDesign",
    "design_lowpass",
    "design_highpass",
    "design_bandpass",
    "design_bandstop",
    "design_cheby1_lowpass",
    "design_cheby2_lowpass",
    "bp_cutoff_freqs",
    "freq_response",
    "group_delay",
    "sos_matrix",
    "ba_coefficients",
]


def bp_cutoff_freqs(f0: float, q: float, fs: float) -> Tuple[float, float]:
    """-3 dB band edges (f1, f2) for a band-pass/stop of center f0, quality q.

    Same contract as the reference's solver (reference:
    test_data/findIIRCutoffFreq.m): f2 - f1 = f0/q, with the edges centered
    so the bilinear-transform response is symmetric about f0 — geometric
    symmetry in the tan-prewarped domain,
    tan(pi f1/fs) * tan(pi f2/fs) == tan(pi f0/fs)^2.  Solved by bracketed
    root finding on the closed-form centering condition instead of the
    reference's progressive step-refinement scan.
    """
    from scipy.optimize import brentq

    bw = f0 / q
    t0sq = math.tan(math.pi * f0 / fs) ** 2

    def centering(f1):
        return (math.tan(math.pi * f1 / fs)
                * math.tan(math.pi * (f1 + bw) / fs) - t0sq)

    hi = min(f0, fs / 2.0 - bw) - 1e-12 * fs
    f1 = brentq(centering, 1e-9 * fs, hi, xtol=1e-12, rtol=1e-15)
    return f1, f1 + bw


class FilterType(enum.IntEnum):
    """Filter family tag.

    Numeric values match the reference's enum (reference:
    include/sdsp/filter_type.h:6) and the golden-fixture CSV header field.
    ``band_stop`` extends the set (reference TODO, README.md:15).
    """

    none = 0
    low_pass = 1
    high_pass = 2
    band_pass = 3
    band_stop = 4


@dataclasses.dataclass(frozen=True)
class BiquadCascadeDesign:
    """Immutable design for a cascade of M second-order sections.

    The runtime op layer (simpledsp_tpu_torch.ops.iir) consumes this; filter
    *state* is an ``IIRState`` tensor passed into and returned from each call
    (the reference's carried m_mem/m_pos, include/sdsp/casc_2o_iir.h:11-15).

    Attributes:
      b: (M, 3) float64 numerator rows, b0 == 1 by construction.
      a: (M, 3) float64 denominator rows, a0 == 1.
      gain: single scalar input gain (all per-section numerator scaling folded
        in, as the reference does at casc_2o_iir.h:122,156,184).
      ftype: filter family tag.
      f0, fs, q: design parameters (q is NaN when not applicable).
    """

    b: np.ndarray
    a: np.ndarray
    gain: float
    ftype: FilterType
    f0: float
    fs: float
    q: float = float("nan")

    def __post_init__(self):
        b = np.asarray(self.b, dtype=np.float64)
        a = np.asarray(self.a, dtype=np.float64)
        if b.ndim != 2 or b.shape[1] != 3 or a.shape != b.shape:
            raise ValueError(f"bad coefficient shapes: b {b.shape}, a {a.shape}")
        object.__setattr__(self, "b", b)
        object.__setattr__(self, "a", a)

    @property
    def nsections(self) -> int:
        return int(self.b.shape[0])

    @property
    def order(self) -> int:
        return 2 * self.nsections

    def dc_gain(self) -> float:
        """DC gain of the full cascade (including input gain)."""
        g = self.gain
        for k in range(self.nsections):
            g *= self.b[k].sum() / self.a[k].sum()
        return g


def _butterworth_pole_spacing(k: int, m: int, full: bool) -> float:
    """d_k = 2 sin((2k+1) pi / (4M)) for LP/HP (half-plane poles, M sections);
    2 sin((2k+1) pi / (2M)) for BP/BS (M/2 pole pairs -> M sections)."""
    denom = 2.0 * m if full else 4.0 * m
    return 2.0 * math.sin((2 * k + 1) * math.pi / denom)


def _lp_hp_sections(m: int, f0: float, fs: float, highpass: bool):
    """Shared LP/HP section recipe (reference math: casc_2o_iir.h:140-194)."""
    e0 = 2.0 * math.pi * f0 / fs
    b_rows = np.empty((m, 3), dtype=np.float64)
    a_rows = np.empty((m, 3), dtype=np.float64)
    scale = 1.0
    sign = -1.0 if highpass else 1.0
    for k in range(m):
        dk = _butterworth_pole_spacing(k, m, full=False)
        t = dk * math.sin(e0) / 2.0
        beta = (1.0 - t) / (1.0 + t) / 2.0
        gamma = (0.5 + beta) * math.cos(e0)
        alpha = (0.5 + beta + (gamma if highpass else -gamma)) / 4.0
        scale *= 2.0 * alpha
        b_rows[k] = (1.0, 2.0 * sign, 1.0)
        a_rows[k] = (1.0, -2.0 * gamma, 2.0 * beta)
    return b_rows, a_rows, scale


def design_lowpass(m: int, f0: float, fs: float, gain: float = 1.0) -> BiquadCascadeDesign:
    """Butterworth low-pass of order 2M as M cascaded biquads.

    Matches the reference's set_lp_coeff (casc_2o_iir.h:168-194) and scipy's
    butter+zp2sos to ~1e-15.
    """
    _check_args(m, f0, fs)
    b, a, scale = _lp_hp_sections(m, f0, fs, highpass=False)
    return BiquadCascadeDesign(b=b, a=a, gain=gain * scale,
                               ftype=FilterType.low_pass, f0=f0, fs=fs)


def design_highpass(m: int, f0: float, fs: float, gain: float = 1.0) -> BiquadCascadeDesign:
    """Butterworth high-pass of order 2M (reference: casc_2o_iir.h:140-166)."""
    _check_args(m, f0, fs)
    b, a, scale = _lp_hp_sections(m, f0, fs, highpass=True)
    return BiquadCascadeDesign(b=b, a=a, gain=gain * scale,
                               ftype=FilterType.high_pass, f0=f0, fs=fs)


def design_bandpass(m: int, f0: float, fs: float, q: float,
                    gain: float = 1.0) -> BiquadCascadeDesign:
    """Butterworth band-pass: M/2 analog pole pairs split into M biquads.

    Bandwidth is set by Q via the tan-warped fractional bandwidth; each LP
    prototype pole pair maps to two resonant sections at e1/e2
    (reference math: casc_2o_iir.h:82-138).
    """
    _check_args(m, f0, fs, need_even=True)
    e0 = 2.0 * math.pi * f0 / fs
    de = 2.0 * math.tan(e0 / (2.0 * q)) / math.sin(e0)

    b_rows = np.empty((m, 3), dtype=np.float64)
    a_rows = np.empty((m, 3), dtype=np.float64)
    scale = 1.0
    for k in range(m // 2):
        d = _butterworth_pole_spacing(k, m, full=True)
        acoef = (1.0 + de * de / 4.0) * 2.0 / d / de
        dk = math.sqrt(de * d / (acoef + math.sqrt(acoef * acoef - 1.0)))

        bcoef = d * de / dk / 2.0
        w = bcoef + math.sqrt(bcoef * bcoef - 1.0)

        t = math.tan(e0 / 2.0)
        e1 = 2.0 * math.atan(t / w)
        e2 = 2.0 * math.atan(w * t)

        beta1 = _beta(dk, e1)
        beta2 = _beta(dk, e2)
        gamma1 = (0.5 + beta1) * math.cos(e1)
        gamma2 = (0.5 + beta2) * math.cos(e2)

        t = math.sqrt(1.0 + ((w - 1.0 / w) / dk) ** 2)
        alpha1 = (0.5 - beta1) * t / 2.0
        alpha2 = (0.5 - beta2) * t / 2.0
        scale *= 4.0 * alpha1 * alpha2

        for idx, (beta, gamma) in ((2 * k, (beta1, gamma1)),
                                   (2 * k + 1, (beta2, gamma2))):
            b_rows[idx] = (1.0, 0.0, -1.0)
            a_rows[idx] = (1.0, -2.0 * gamma, 2.0 * beta)
    return BiquadCascadeDesign(b=b_rows, a=a_rows, gain=gain * scale,
                               ftype=FilterType.band_pass, f0=f0, fs=fs, q=q)


def design_bandstop(m: int, f0: float, fs: float, q: float,
                    gain: float = 1.0) -> BiquadCascadeDesign:
    """Butterworth band-stop (notch) of order 2M — net-new vs the reference
    (its README lists band-stop as TODO).

    Derived via the framework's own analog prototype + bilinear transform
    pipeline (design.iir), then normalized to the cascade convention used
    here (b0 == 1 absorbed into the single input gain).  Cross-validated
    against scipy.signal.butter(..., 'bandstop') in tests.
    """
    _check_args(m, f0, fs, need_even=True)
    from simpledsp_tpu_torch.design import iir as _iir

    # Band edges: width f0/q, centered so the bilinear-transform notch lands
    # exactly at f0 (shared solver; reference: findIIRCutoffFreq.m).
    f1, f2 = bp_cutoff_freqs(f0, q, fs)
    # butter(N, 'bandstop') yields a 2N-pole filter -> N biquads, so
    # N == m gives exactly m sections (order 2m, matching the BP convention).
    sos = _iir.butter(m, (f1, f2), btype="bandstop", fs=fs, output="sos")
    b_rows = np.empty((sos.shape[0], 3), dtype=np.float64)
    a_rows = np.empty((sos.shape[0], 3), dtype=np.float64)
    scale = 1.0
    for i, row in enumerate(sos):
        b0 = row[0]
        scale *= b0
        b_rows[i] = row[:3] / b0
        a_rows[i] = row[3:]
    if sos.shape[0] != m:
        # scipy pairs zeros/poles into exactly m sections for bandstop of
        # order 2m when N = m//1... guard against mismatch explicitly.
        raise ValueError(
            f"band-stop section count {sos.shape[0]} != requested {m}")
    return BiquadCascadeDesign(b=b_rows, a=a_rows, gain=gain * scale,
                               ftype=FilterType.band_stop, f0=f0, fs=fs, q=q)


def design_cheby1_lowpass(m: int, ripple_db: float, f0: float, fs: float,
                          gain: float = 1.0) -> BiquadCascadeDesign:
    """Chebyshev type-I low-pass of order 2M as M cascaded biquads.

    Closed-form analog prototype + prewarped bilinear transform (all
    float64 host math, no scipy):

        eps   = sqrt(10^(rp/10) - 1)
        mu    = asinh(1/eps) / n,      n = 2M
        p_k   = wa (-sinh(mu) sin(th_k) + i cosh(mu) cos(th_k)),
                th_k = (2k+1) pi / (2n),   wa = 2 fs tan(pi f0 / fs)
        z_k   = (2 fs + p_k) / (2 fs - p_k)       (poles; zeros all at -1)

    The even-order prototype is normalized so the PASSBAND RIPPLE TOP is
    unity (DC gain 1/sqrt(1+eps^2)) — scipy.signal.cheby1's convention,
    validated against it in tests to 1e-12.  f0 is the passband-edge
    frequency (where the response leaves the ripple band), not -3 dB.

    Extends the framework's Butterworth-only design layer (the reference
    has no Chebyshev family); needed by :func:`ops.fir.decimate`, whose
    scipy-parity anti-alias filter is cheby1(8, 0.05).
    """
    _check_args(m, f0, fs)
    n = 2 * m
    eps = math.sqrt(10.0 ** (ripple_db / 10.0) - 1.0)
    mu = math.asinh(1.0 / eps) / n
    wa = 2.0 * fs * math.tan(math.pi * f0 / fs)
    fs2 = 2.0 * fs
    # Left-half-plane prototype poles, scaled to the warped cutoff.
    k_idx = np.arange(n, dtype=np.float64)
    theta = (2.0 * k_idx + 1.0) * math.pi / (2.0 * n)
    poles = wa * (-math.sinh(mu) * np.sin(theta)
                  + 1j * math.cosh(mu) * np.cos(theta))
    # Analog gain: unity ripple-top for even order.
    k_analog = np.real(np.prod(-poles)) / math.sqrt(1.0 + eps * eps)
    # Bilinear: digital poles; all n zeros at z = -1.
    zp = (fs2 + poles) / (fs2 - poles)
    k_digital = k_analog / np.real(np.prod(fs2 - poles))
    # Pair conjugate poles (k and n-1-k) into biquads: b = (1, 2, 1).
    b_rows = np.tile((1.0, 2.0, 1.0), (m, 1))
    a_rows = np.empty((m, 3), dtype=np.float64)
    for k in range(m):
        a_rows[k] = (1.0, -2.0 * zp[k].real, abs(zp[k]) ** 2)
    return BiquadCascadeDesign(b=b_rows, a=a_rows,
                               gain=gain * float(k_digital),
                               ftype=FilterType.low_pass, f0=f0, fs=fs)


def design_cheby2_lowpass(m: int, atten_db: float, f0: float, fs: float,
                          gain: float = 1.0) -> BiquadCascadeDesign:
    """Chebyshev type-II (inverse Chebyshev) low-pass of order 2M as M
    cascaded biquads: maximally flat passband, equiripple stopband at
    least ``atten_db`` down past the stopband-edge frequency ``f0``
    (scipy.signal.cheby2's convention).

    Closed-form analog prototype + prewarped bilinear (host float64, no
    scipy): prototype poles are the reciprocals of the Chebyshev-I
    layout, zeros sit on the imaginary axis at j/cos(th_k); finite zeros
    give each section a non-trivial (1, b1, 1) numerator, unlike the
    all-(1,2,1) Butterworth/Cheby-I families.  Validated against
    scipy.signal.cheby2 to 1e-12 in tests.
    """
    _check_args(m, f0, fs)
    n = 2 * m
    de = 1.0 / math.sqrt(10.0 ** (atten_db / 10.0) - 1.0)
    mu = math.asinh(1.0 / de) / n
    k_idx = np.arange(n, dtype=np.float64)
    theta = (2.0 * k_idx + 1.0) * math.pi / (2.0 * n)
    poles = 1.0 / (-math.sinh(mu) * np.sin(theta)
                   + 1j * math.cosh(mu) * np.cos(theta))
    zeros = 1j / np.cos(theta)                    # all finite for even n
    k_analog = np.real(np.prod(-poles) / np.prod(-zeros))
    wa = 2.0 * fs * math.tan(math.pi * f0 / fs)
    poles = poles * wa
    zeros = zeros * wa
    fs2 = 2.0 * fs
    zp = (fs2 + poles) / (fs2 - poles)
    zz = (fs2 + zeros) / (fs2 - zeros)
    k_digital = k_analog * np.real(np.prod(fs2 - zeros)
                                   / np.prod(fs2 - poles))
    b_rows = np.empty((m, 3), dtype=np.float64)
    a_rows = np.empty((m, 3), dtype=np.float64)
    for k in range(m):
        b_rows[k] = (1.0, -2.0 * zz[k].real, abs(zz[k]) ** 2)
        a_rows[k] = (1.0, -2.0 * zp[k].real, abs(zp[k]) ** 2)
    return BiquadCascadeDesign(b=b_rows, a=a_rows,
                               gain=gain * float(k_digital),
                               ftype=FilterType.low_pass, f0=f0, fs=fs)


def ba_coefficients(design: BiquadCascadeDesign
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Expand the cascade into single (b, a) transfer-function polynomials
    (float64 host math) for use with :func:`ops.lfilter.lfilter` /
    `filtfilt`.  Fine up to order ~8-10; prefer the SOS form
    (ops.iir.sosfilt) beyond that."""
    b = np.array([design.gain])
    a = np.array([1.0])
    for k in range(design.nsections):
        b = np.convolve(b, design.b[k])
        a = np.convolve(a, design.a[k])
    return b, a


def _beta(dk: float, e: float) -> float:
    t = dk * math.sin(e) / 2.0
    return (1.0 - t) / (1.0 + t) / 2.0


def _check_args(m: int, f0: float, fs: float,
                need_even: bool = False) -> None:
    if m <= 0:
        raise ValueError(f"M must be a positive integer, got {m}")
    if need_even and m % 2 != 0:
        # Band filters split M/2 analog pole pairs into M sections; the
        # reference requires even M for ALL types (casc_2o_iir.h:25) but
        # that is only mathematically necessary here.
        raise ValueError(f"M must be a positive even integer, got {m}")
    if not (0.0 < f0 < fs / 2.0):
        raise ValueError(f"need 0 < f0 < fs/2, got f0={f0}, fs={fs}")


def sos_matrix(design: BiquadCascadeDesign) -> np.ndarray:
    """Export to scipy's (M, 6) SOS format with the gain folded into the
    first section — for cross-validation against scipy.signal.sosfilt."""
    m = design.nsections
    sos = np.concatenate([design.b, design.a], axis=1).astype(np.float64)
    sos[0, :3] *= design.gain
    return sos


def freq_response(design: BiquadCascadeDesign, freqs=None, *, n: int = 512):
    """Complex frequency response H(f) of the cascade (including gain).

    freqs: frequencies in the same units as design.fs (default: n points
    from 0 to fs/2).  Returns (freqs, H).  Host-side analysis helper
    (scipy.sosfreqz on the exported SOS matrix).
    """
    import scipy.signal as sig

    worN = n if freqs is None else np.asarray(freqs, dtype=np.float64)
    w, h = sig.sosfreqz(sos_matrix(design), worN=worN, fs=design.fs)
    return w, h


def group_delay(design: BiquadCascadeDesign, freqs=None, *, n: int = 512):
    """Group delay in samples over frequency (host-side analysis helper)."""
    import scipy.signal as sig

    worN = n if freqs is None else np.asarray(freqs, dtype=np.float64)
    total = None
    w = None
    for k in range(design.nsections):
        b = design.b[k] * (design.gain if k == 0 else 1.0)
        w, gd = sig.group_delay((b, design.a[k]), w=worN, fs=design.fs)
        total = gd if total is None else total + gd
    return w, total
