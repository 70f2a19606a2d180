"""Carried verbatim from ``simpledsp_tpu/design/fir.py``: NumPy
only, so both packages design bit-identical taps.

FIR filter design (host-side float64) — net-new components beyond the
reference's FFT+IIR pair, required by the north star (BASELINE.json configs:
"polyphase FIR decimate/interpolate + overlap-save block filtering" and the
channelizer/resampler chain; SURVEY.md §2b).

Design is pure NumPy float64 run once at trace time; taps become constants in
the jitted HLO, mirroring how the reference bakes twiddle tables into the
binary (reference: include/sdsp/fft.h:264-265).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

__all__ = [
    "lowpass_taps",
    "firwin2",
    "highpass_taps",
    "bandpass_taps",
    "bandstop_taps",
    "kaiser_beta",
    "resampler_taps",
    "pfb_prototype_taps",
]


def kaiser_beta(atten_db: float) -> float:
    """Kaiser window beta for a target stopband attenuation (standard
    Kaiser formula)."""
    if atten_db > 50.0:
        return 0.1102 * (atten_db - 8.7)
    if atten_db >= 21.0:
        return 0.5842 * (atten_db - 21.0) ** 0.4 + 0.07886 * (atten_db - 21.0)
    return 0.0


def lowpass_taps(num_taps: int, cutoff: float, fs: float = 2.0,
                 window: str = "kaiser", atten_db: float = 80.0) -> np.ndarray:
    """Windowed-sinc linear-phase low-pass FIR.

    cutoff is the -6 dB edge in the same units as fs.  Normalized to unity DC
    gain.  Validated against scipy.signal.firwin in tests.
    """
    if num_taps < 2:
        raise ValueError("num_taps must be >= 2")
    fc = cutoff / fs  # cycles per sample, passband (0, 0.5)
    if not (0.0 < fc < 0.5):
        raise ValueError(f"need 0 < cutoff < fs/2, got {cutoff} @ fs={fs}")
    n = np.arange(num_taps, dtype=np.float64) - (num_taps - 1) / 2.0
    h = 2.0 * fc * np.sinc(2.0 * fc * n)
    if window == "kaiser":
        w = np.kaiser(num_taps, kaiser_beta(atten_db))
    elif window == "hamming":
        w = np.hamming(num_taps)
    elif window == "blackman":
        w = np.blackman(num_taps)
    elif window == "rect":
        w = np.ones(num_taps)
    else:
        raise ValueError(f"unknown window {window!r}")
    h *= w
    return h / h.sum()


def _window_taps(window: str, num_taps: int, atten_db: float) -> np.ndarray:
    if window == "kaiser":
        return np.kaiser(num_taps, kaiser_beta(atten_db))
    if window == "hamming":
        return np.hamming(num_taps)
    if window == "blackman":
        return np.blackman(num_taps)
    if window == "rect":
        return np.ones(num_taps)
    raise ValueError(f"unknown window {window!r}")


def _firwin_bands(num_taps: int, bands, window: str,
                  atten_db: float) -> np.ndarray:
    """Windowed-sinc multi-band linear-phase FIR (scipy.signal.firwin
    construction): band edges normalized to Nyquist = 1; response scaled
    to unity at DC (if passed), else Nyquist (if passed), else the first
    passband's midpoint."""
    if num_taps < 2:
        raise ValueError("num_taps must be >= 2")
    for left, right in bands:
        if not (0.0 <= left < right <= 1.0):
            raise ValueError(f"bad band ({left}, {right}) — edges must be "
                             "ascending within (0, fs/2)")
    if bands[-1][1] == 1.0 and num_taps % 2 == 0:
        raise ValueError("a filter passing Nyquist needs odd num_taps "
                         "(even-length type-II FIRs are zero there)")
    m = np.arange(num_taps, dtype=np.float64) - (num_taps - 1) / 2.0
    h = np.zeros(num_taps)
    for left, right in bands:
        h += right * np.sinc(right * m) - left * np.sinc(left * m)
    h *= _window_taps(window, num_taps, atten_db)
    c = np.cos(np.pi * m * _scale_frequency(bands))
    return h / np.sum(h * c)


def _scale_frequency(bands) -> float:
    """scipy.signal.firwin's unity-response point: decided by the FIRST
    band alone — DC if it starts at 0, Nyquist if it (itself) ends
    there, else its midpoint."""
    left, right = bands[0]
    if left == 0.0:
        return 0.0
    if right == 1.0:
        return 1.0
    return 0.5 * (left + right)


def highpass_taps(num_taps: int, cutoff: float, fs: float = 2.0,
                  window: str = "kaiser",
                  atten_db: float = 80.0) -> np.ndarray:
    """Windowed-sinc linear-phase high-pass FIR (unity gain at Nyquist;
    odd num_taps required).  Validated against scipy.signal.firwin."""
    return _firwin_bands(num_taps, [(2.0 * cutoff / fs, 1.0)], window,
                         atten_db)


def bandpass_taps(num_taps: int, f_lo: float, f_hi: float, fs: float = 2.0,
                  window: str = "kaiser",
                  atten_db: float = 80.0) -> np.ndarray:
    """Windowed-sinc linear-phase band-pass FIR (unity gain at the band
    midpoint).  Validated against scipy.signal.firwin."""
    return _firwin_bands(num_taps, [(2.0 * f_lo / fs, 2.0 * f_hi / fs)],
                         window, atten_db)


def bandstop_taps(num_taps: int, f_lo: float, f_hi: float, fs: float = 2.0,
                  window: str = "kaiser",
                  atten_db: float = 80.0) -> np.ndarray:
    """Windowed-sinc linear-phase band-stop FIR (unity DC gain; odd
    num_taps required) — the FIR complement of design/biquad's band-stop,
    itself the reference's TODO item (reference: README.md:15)."""
    return _firwin_bands(
        num_taps, [(0.0, 2.0 * f_lo / fs), (2.0 * f_hi / fs, 1.0)],
        window, atten_db)


def rrc_taps(sps: int, span: int, beta: float) -> np.ndarray:
    """Root-raised-cosine pulse-shaping filter (host f64): ``sps`` samples
    per symbol, TOTAL ``span`` symbols (the MATLAB ``rcosdesign``
    convention — length ``span * sps + 1``, odd, group delay the integer
    ``span * sps / 2`` samples; ``span * sps`` must be even), roll-off
    ``beta`` in (0, 1].

    Standard closed form with the removable singularities at t = 0 and
    |t| = 1/(4 beta) evaluated by their limits; normalized to unit energy
    so a TX RRC -> matched RX RRC cascade yields a raised-cosine with
    unity gain and (asymptotically) zero ISI at symbol-spaced samples —
    the property tests/test_comms.py gates."""
    if sps < 1 or span < 1:
        raise ValueError("sps and span must be >= 1")
    if not 0.0 < beta <= 1.0:
        raise ValueError(f"beta must be in (0, 1], got {beta}")
    if (span * sps) % 2:
        raise ValueError(f"span * sps must be even, got {span}*{sps}")
    n = span * sps // 2
    t = (np.arange(-n, n + 1, dtype=np.float64)) / sps   # in symbols
    h = np.empty_like(t)
    for i, ti in enumerate(t):
        if abs(ti) < 1e-12:
            h[i] = 1.0 + beta * (4.0 / np.pi - 1.0)
        elif abs(abs(ti) - 1.0 / (4.0 * beta)) < 1e-12:
            h[i] = (beta / np.sqrt(2.0)) * (
                (1.0 + 2.0 / np.pi) * np.sin(np.pi / (4.0 * beta))
                + (1.0 - 2.0 / np.pi) * np.cos(np.pi / (4.0 * beta)))
        else:
            num = (np.sin(np.pi * ti * (1.0 - beta))
                   + 4.0 * beta * ti * np.cos(np.pi * ti * (1.0 + beta)))
            den = np.pi * ti * (1.0 - (4.0 * beta * ti) ** 2)
            h[i] = num / den
    return h / np.sqrt(np.sum(h * h))


def firwin(num_taps: int, cutoff, *, window="hamming",
           pass_zero=True, fs: float = 2.0,
           atten_db: float = 80.0) -> np.ndarray:
    """scipy.signal.firwin-compatible windowed-sinc FIR design — the
    familiar entry point over the same :func:`_firwin_bands` machinery
    as the typed helpers ({low,high,band}pass_taps / bandstop_taps).

    ``cutoff``: scalar or ascending edge list (units of ``fs``).
    ``pass_zero``: True/'lowpass'/'bandstop' put a passband at DC;
    False/'highpass'/'bandpass' start with a stopband.  ``window`` takes
    any design/windows.get_window spec (plus 'kaiser', which uses
    ``atten_db`` via the Kaiser formula).  Validated tap-for-tap against
    scipy.signal.firwin in tests/test_design_fir.py.
    """
    edges = np.atleast_1d(np.asarray(cutoff, dtype=np.float64))
    if np.any(np.diff(edges) <= 0):
        raise ValueError("cutoff edges must be strictly ascending")
    norm = list(2.0 * edges / fs)
    if isinstance(pass_zero, str):
        if pass_zero in ("lowpass", "bandstop"):
            pass_zero = True
        elif pass_zero in ("highpass", "bandpass"):
            pass_zero = False
        else:
            raise ValueError(f"unknown pass_zero {pass_zero!r}")
    pts = ([0.0] if pass_zero else []) + norm
    if len(pts) % 2 == 1:
        pts = pts + [1.0]
    bands = [(pts[i], pts[i + 1]) for i in range(0, len(pts), 2)]
    if window in ("kaiser", "hamming", "blackman", "rect"):
        return _firwin_bands(num_taps, bands, window, atten_db)
    # Arbitrary get_window specs (tuples, names): reuse the multi-band
    # sinc construction with the framework's own symmetric window.
    m = np.arange(num_taps, dtype=np.float64) - (num_taps - 1) / 2.0
    h = np.zeros(num_taps)
    for left, right in bands:
        h += right * np.sinc(right * m) - left * np.sinc(left * m)
    h *= _window_taps_sym(window, num_taps)
    c = np.cos(np.pi * m * _scale_frequency(bands))
    return h / np.sum(h * c)


def firwin_2d(hsize, window, *, fc=None, fs: float = 2.0,
              circular: bool = False) -> np.ndarray:
    """2-D windowed-sinc FIR design (scipy.signal.firwin_2d semantics):
    separable outer product of two 1-D :func:`firwin` kernels, or an
    approximately circularly symmetric kernel by radial interpolation of
    an 8x-oversampled 1-D design (scipy's construction, replicated
    exactly)."""
    if len(hsize) != 2:
        raise ValueError("hsize must be a 2-element tuple or list")
    if circular:
        if fc is None:
            raise ValueError("fc must be provided when circular=True")
        n_r = max(hsize[0], hsize[1]) * 8
        win_r = firwin(n_r, fc, window=window, fs=fs)
        f1, f2 = np.meshgrid(np.linspace(-1, 1, hsize[0]),
                             np.linspace(-1, 1, hsize[1]))
        r = np.sqrt(f1 ** 2 + f2 ** 2)
        return np.interp(r, np.linspace(0, 1, n_r), win_r)
    if len(window) != 2 or isinstance(window, str):
        raise ValueError("window must be a 2-element tuple or list for "
                         "the separable form")
    row = firwin(hsize[0], fc, window=window[0], fs=fs)
    col = firwin(hsize[1], fc, window=window[1], fs=fs)
    return np.outer(row, col)


def resampler_taps(up: int, down: int, taps_per_phase: int = 24,
                   atten_db: float = 80.0) -> np.ndarray:
    """Anti-alias prototype for rational up/down resampling.

    Cutoff at min(1/up, 1/down)/2 of the upsampled rate; gain `up` so the
    interpolated signal keeps unit amplitude.  Length is a multiple of `up`
    for clean polyphase decomposition.
    """
    if up < 1 or down < 1:
        raise ValueError("up/down must be positive")
    g = math.gcd(up, down)
    up, down = up // g, down // g
    num_taps = taps_per_phase * up
    if num_taps % 2 == 0:
        num_taps += up  # keep multiple of up, make odd-ish center acceptable
    fc = 0.5 / max(up, down)  # cycles/sample at the upsampled rate
    h = lowpass_taps(num_taps, fc, fs=1.0, atten_db=atten_db)
    return h * up


def pfb_prototype_taps(num_channels: int, taps_per_channel: int = 16,
                       atten_db: float = 80.0, design: str = "kaiser",
                       rolloff: float = 0.7,
                       stop_weight: float = 10.0) -> np.ndarray:
    """Prototype low-pass for a polyphase filter-bank channelizer.

    Cutoff at half the channel spacing fc = 0.5/M; length = num_channels *
    taps_per_channel for exact polyphase reshaping; unity DC gain.

    ``design="kaiser"`` (default) is the windowed-sinc family;
    ``design="remez"`` is the Parks-McClellan equiripple optimum over
    passband [0, rolloff*fc] / stopband [(2-rolloff)*fc, 0.5] with the
    stopband weighted ``stop_weight``: — at equal taps it buys 16-34 dB
    more adjacent-channel rejection (measured −90 vs −65 dB at M=16, K=16)
    at comparable passband ripple (6e-4 vs 5e-4).
    """
    num_taps = num_channels * taps_per_channel
    fc = 0.5 / num_channels
    if design == "kaiser":
        return lowpass_taps(num_taps, fc, fs=1.0, atten_db=atten_db)
    if design == "remez":
        from simpledsp_tpu_torch.design.optimal_fir import remez
        if not (0.0 < rolloff < 1.0):
            raise ValueError(f"need 0 < rolloff < 1, got {rolloff}")
        h = remez(num_taps, [0.0, rolloff * fc, (2.0 - rolloff) * fc, 0.5],
                  [1.0, 0.0], weight=[1.0, stop_weight])
        return h / h.sum()
    raise ValueError(f"unknown design {design!r}")


def firwin2(num_taps: int, freq, gain, *,
            nfreqs: Optional[int] = None,
            window: str = "hamming", antisymmetric: bool = False
            ) -> np.ndarray:
    """Frequency-sampled FIR design (scipy.signal.firwin2 semantics):
    linear-phase taps whose magnitude response tracks the piecewise-linear
    (freq, gain) spec, freq normalized to Nyquist = 1.  A frequency may be
    repeated once to encode a step discontinuity.  ``antisymmetric``
    selects the type-III/IV (odd-symmetric) families for differentiators
    and Hilbert transformers.  Host float64; validated against scipy.
    """
    freq = np.asarray(freq, dtype=np.float64).copy()
    gain = np.asarray(gain, dtype=np.float64)
    if freq.ndim != 1 or freq.shape != gain.shape:
        raise ValueError("freq and gain must be 1-D of equal length")
    if freq[0] != 0.0 or freq[-1] != 1.0:
        raise ValueError("freq must start at 0 and end at 1 (Nyquist)")
    d = np.diff(freq)
    if (d < 0).any():
        raise ValueError("freq must be nondecreasing")
    if num_taps < 3:
        raise ValueError("num_taps must be >= 3")
    # Linear-phase type constraints (zeros forced at band edges).
    ftype = (3 if num_taps % 2 else 4) if antisymmetric else \
        (1 if num_taps % 2 else 2)
    if ftype == 2 and gain[-1] != 0.0:
        raise ValueError("even num_taps (type II) forces zero gain at "
                         "Nyquist — end the spec with gain 0")
    if ftype == 3 and (gain[0] != 0.0 or gain[-1] != 0.0):
        raise ValueError("odd antisymmetric taps (type III) force zero "
                         "gain at 0 and Nyquist")
    if ftype == 4 and gain[0] != 0.0:
        raise ValueError("even antisymmetric taps (type IV) force zero "
                         "gain at DC")
    if nfreqs is None:
        nfreqs = 1 + 2 ** int(math.ceil(math.log2(num_taps)))
    if num_taps >= nfreqs:
        raise ValueError("nfreqs must exceed num_taps")
    # A repeated frequency encodes a step: nudge the pair apart by eps so
    # the interpolation grid sees both values (scipy's rule).
    eps = np.finfo(np.float64).eps
    dup = np.nonzero(d == 0.0)[0]
    if dup.size and (np.diff(dup) == 1).any():
        raise ValueError("a frequency may be repeated at most once")
    for k in dup:
        freq[k] = freq[k] - eps * (k + 1)
        freq[k + 1] = freq[k + 1] + eps * (k + 1)
    if (np.diff(freq) <= 0).any():
        raise ValueError("a frequency may be repeated at most once")
    x = np.linspace(0.0, 1.0, nfreqs)
    fx = np.interp(x, freq, gain)
    shift = np.exp(-(num_taps - 1) / 2.0 * 1j * np.pi * x)
    if ftype > 2:
        shift *= 1j
    out_full = np.fft.irfft(fx * shift)
    taps = out_full[:num_taps] * _window_taps_sym(window, num_taps)
    if ftype == 3:
        taps[num_taps // 2] = 0.0
    return taps


def _window_taps_sym(window, num_taps: int) -> np.ndarray:
    """Symmetric (filter-design) window, get_window spec or None — served
    by the framework's own window library (design/windows.py)."""
    if window is None:
        return np.ones(num_taps)
    from .windows import get_window

    return get_window(window, num_taps, fftbins=False)
