"""Closed-form digital Butterworth biquad-cascade design (host float64 NumPy).

The low-pass, high-pass and band-pass part of ``simpledsp_tpu/design/biquad.py``,
carried over unchanged: design runs once on the host in float64 and yields a
frozen :class:`BiquadCascadeDesign` whose operators the torch ops build as
buffers.  Per second-order section,

    beta  = (1 - t) / (2 (1 + t)),   t = d_k sin(e0) / 2
    gamma = (1/2 + beta) cos(e0)
    a = (1, -2 gamma, 2 beta)

with d_k = 2 sin((2k+1) pi / 4M) the Butterworth pole-pair spacing, and the
numerator absorbed into a single input gain (b rows are fixed integer
patterns: LP (1,2,1), HP (1,-2,1), BP (1,0,-1)).
"""

from __future__ import annotations

import dataclasses
import enum
import math

import numpy as np

__all__ = [
    "FilterType",
    "BiquadCascadeDesign",
    "design_lowpass",
    "design_highpass",
    "design_bandpass",
    "sos_matrix",
]


class FilterType(enum.IntEnum):
    """Filter family tag (same numeric values as the JAX package's)."""

    none = 0
    low_pass = 1
    high_pass = 2
    band_pass = 3
    band_stop = 4


@dataclasses.dataclass(frozen=True)
class BiquadCascadeDesign:
    """Immutable design for a cascade of M second-order sections.

    Attributes:
      b: (M, 3) float64 numerator rows, b0 == 1 by construction.
      a: (M, 3) float64 denominator rows, a0 == 1.
      gain: single scalar input gain (all per-section numerator scaling
        folded in).
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
    2 sin((2k+1) pi / (2M)) for BP (M/2 pole pairs -> M sections)."""
    denom = 2.0 * m if full else 4.0 * m
    return 2.0 * math.sin((2 * k + 1) * math.pi / denom)


def _lp_hp_sections(m: int, f0: float, fs: float, highpass: bool):
    """Shared LP/HP section recipe."""
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
    """Butterworth low-pass of order 2M as M cascaded biquads."""
    _check_args(m, f0, fs)
    b, a, scale = _lp_hp_sections(m, f0, fs, highpass=False)
    return BiquadCascadeDesign(b=b, a=a, gain=gain * scale,
                               ftype=FilterType.low_pass, f0=f0, fs=fs)


def design_highpass(m: int, f0: float, fs: float, gain: float = 1.0) -> BiquadCascadeDesign:
    """Butterworth high-pass of order 2M."""
    _check_args(m, f0, fs)
    b, a, scale = _lp_hp_sections(m, f0, fs, highpass=True)
    return BiquadCascadeDesign(b=b, a=a, gain=gain * scale,
                               ftype=FilterType.high_pass, f0=f0, fs=fs)


def design_bandpass(m: int, f0: float, fs: float, q: float,
                    gain: float = 1.0) -> BiquadCascadeDesign:
    """Butterworth band-pass: M/2 analog pole pairs split into M biquads.

    Bandwidth is set by Q via the tan-warped fractional bandwidth; each LP
    prototype pole pair maps to two resonant sections at e1/e2.
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


def _beta(dk: float, e: float) -> float:
    t = dk * math.sin(e) / 2.0
    return (1.0 - t) / (1.0 + t) / 2.0


def _check_args(m: int, f0: float, fs: float,
                need_even: bool = False) -> None:
    if m <= 0:
        raise ValueError(f"M must be a positive integer, got {m}")
    if need_even and m % 2 != 0:
        raise ValueError(f"M must be a positive even integer, got {m}")
    if not (0.0 < f0 < fs / 2.0):
        raise ValueError(f"need 0 < f0 < fs/2, got f0={f0}, fs={fs}")


def sos_matrix(design: BiquadCascadeDesign) -> np.ndarray:
    """Export to scipy's (M, 6) SOS format with the gain folded into the
    first section — for cross-validation against scipy.signal.sosfilt."""
    sos = np.concatenate([design.b, design.a], axis=1).astype(np.float64)
    sos[0, :3] *= design.gain
    return sos
