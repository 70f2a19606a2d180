"""Carried verbatim from ``simpledsp_tpu/design/windows.py``: NumPy
only, so both packages design bit-identical taps.

Window functions (host-side float64).

The reference has no window machinery at all — its FFT consumes raw blocks
(reference: include/sdsp/fft.h:258-360) — but every spectral estimator the
framework adds on top (Welch, spectrogram, STFT, firwin design) needs one.
This module is the framework's own window library: every window is computed
from its closed form here, so the design layer carries no scipy dependency;
scipy.signal.get_window is used only in tests as the validation oracle.

All windows follow the scipy conventions: ``sym=True`` gives the symmetric
(filter-design) window, ``sym=False`` the periodic (spectral-analysis, DFT
grid) variant computed as the (M+1)-point symmetric window with the last
point dropped.  ``get_window(spec, M)`` accepts the scipy spec forms — a
name string, a ``(name, arg...)`` tuple, or a bare float (kaiser beta) —
and defaults to the periodic variant like scipy.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np

__all__ = [
    "get_window",
    "boxcar",
    "triang",
    "bartlett",
    "barthann",
    "hann",
    "hamming",
    "general_hamming",
    "general_cosine",
    "blackman",
    "blackmanharris",
    "nuttall",
    "flattop",
    "bohman",
    "parzen",
    "cosine",
    "lanczos",
    "tukey",
    "kaiser",
    "gaussian",
    "general_gaussian",
    "chebwin",
    "exponential",
    "taylor",
    "dpss",
]


def _extend(m: int, sym: bool):
    """Periodic windows are the (m+1)-point symmetric window minus the
    wrap-around endpoint."""
    if m < 0:
        raise ValueError("window length must be non-negative")
    if sym:
        return m, False
    return m + 1, True


def _trim(w: np.ndarray, trim: bool) -> np.ndarray:
    return w[:-1] if trim else w


def _small(m: int):
    """Degenerate lengths shared by every window."""
    if m == 0:
        return np.empty(0, dtype=np.float64)
    if m == 1:
        return np.ones(1, dtype=np.float64)
    return None


# ---------------------------------------------------------------------------
# cosine-sum family


def general_cosine(m: int, a: Sequence[float], sym: bool = True) -> np.ndarray:
    """Window as a cosine series sum_k a_k cos(k * t), t in [-pi, pi]."""
    w0 = _small(m)
    if w0 is not None:
        return w0
    m, trim = _extend(m, sym)
    fac = np.linspace(-np.pi, np.pi, m)
    w = np.zeros(m)
    for k, ak in enumerate(a):
        w += ak * np.cos(k * fac)
    return _trim(w, trim)


def general_hamming(m: int, alpha: float, sym: bool = True) -> np.ndarray:
    return general_cosine(m, [alpha, 1.0 - alpha], sym)


def hann(m: int, sym: bool = True) -> np.ndarray:
    return general_hamming(m, 0.5, sym)


def hamming(m: int, sym: bool = True) -> np.ndarray:
    return general_hamming(m, 0.54, sym)


def blackman(m: int, sym: bool = True) -> np.ndarray:
    return general_cosine(m, [0.42, 0.50, 0.08], sym)


def blackmanharris(m: int, sym: bool = True) -> np.ndarray:
    return general_cosine(m, [0.35875, 0.48829, 0.14128, 0.01168], sym)


def nuttall(m: int, sym: bool = True) -> np.ndarray:
    return general_cosine(
        m, [0.3635819, 0.4891775, 0.1365995, 0.0106411], sym)


def flattop(m: int, sym: bool = True) -> np.ndarray:
    a = [0.21557895, 0.41663158, 0.277263158, 0.083578947, 0.006947368]
    return general_cosine(m, a, sym)


# ---------------------------------------------------------------------------
# piecewise / shape windows


def boxcar(m: int, sym: bool = True) -> np.ndarray:
    del sym  # identical either way
    return np.ones(max(m, 0), dtype=np.float64)


def triang(m: int, sym: bool = True) -> np.ndarray:
    w0 = _small(m)
    if w0 is not None:
        return w0
    m, trim = _extend(m, sym)
    n = np.arange(1, (m + 1) // 2 + 1, dtype=np.float64)
    if m % 2 == 0:
        w = (2 * n - 1.0) / m
        w = np.concatenate([w, w[::-1]])
    else:
        w = 2 * n / (m + 1.0)
        w = np.concatenate([w, w[-2::-1]])
    return _trim(w, trim)


def bartlett(m: int, sym: bool = True) -> np.ndarray:
    w0 = _small(m)
    if w0 is not None:
        return w0
    m, trim = _extend(m, sym)
    n = np.arange(m, dtype=np.float64)
    w = np.where(n <= (m - 1) / 2.0, 2.0 * n / (m - 1),
                 2.0 - 2.0 * n / (m - 1))
    return _trim(w, trim)


def barthann(m: int, sym: bool = True) -> np.ndarray:
    w0 = _small(m)
    if w0 is not None:
        return w0
    m, trim = _extend(m, sym)
    n = np.arange(m, dtype=np.float64)
    fac = np.abs(n / (m - 1.0) - 0.5)
    w = 0.62 - 0.48 * fac + 0.38 * np.cos(2 * np.pi * fac)
    return _trim(w, trim)


def bohman(m: int, sym: bool = True) -> np.ndarray:
    w0 = _small(m)
    if w0 is not None:
        return w0
    m, trim = _extend(m, sym)
    fac = np.abs(np.linspace(-1.0, 1.0, m)[1:-1])
    mid = (1 - fac) * np.cos(np.pi * fac) + np.sin(np.pi * fac) / np.pi
    w = np.concatenate([[0.0], mid, [0.0]])
    return _trim(w, trim)


def parzen(m: int, sym: bool = True) -> np.ndarray:
    w0 = _small(m)
    if w0 is not None:
        return w0
    m, trim = _extend(m, sym)
    n = np.arange(-(m - 1) / 2.0, (m - 1) / 2.0 + 0.5, 1.0)
    na = np.extract(n < -(m - 1) / 4.0, n)
    nb = np.extract(abs(n) <= (m - 1) / 4.0, n)
    wa = 2 * (1 - np.abs(na) / (m / 2.0)) ** 3.0
    wb = (1 - 6 * (np.abs(nb) / (m / 2.0)) ** 2.0
          + 6 * (np.abs(nb) / (m / 2.0)) ** 3.0)
    w = np.concatenate([wa, wb, wa[::-1]])
    return _trim(w, trim)


def cosine(m: int, sym: bool = True) -> np.ndarray:
    w0 = _small(m)
    if w0 is not None:
        return w0
    m, trim = _extend(m, sym)
    w = np.sin(np.pi / m * (np.arange(m) + 0.5))
    return _trim(w, trim)


def lanczos(m: int, sym: bool = True) -> np.ndarray:
    w0 = _small(m)
    if w0 is not None:
        return w0
    m, trim = _extend(m, sym)
    n = np.arange(m, dtype=np.float64)
    w = np.sinc(2.0 * n / (m - 1) - 1.0)
    return _trim(w, trim)


def tukey(m: int, alpha: float = 0.5, sym: bool = True) -> np.ndarray:
    w0 = _small(m)
    if w0 is not None:
        return w0
    if alpha <= 0:
        return np.ones(m)
    if alpha >= 1.0:
        return hann(m, sym=sym)
    m, trim = _extend(m, sym)
    n = np.arange(m, dtype=np.float64)
    width = int(np.floor(alpha * (m - 1) / 2.0))
    n1, n2, n3 = n[: width + 1], n[width + 1: m - width - 1], n[m - width - 1:]
    w1 = 0.5 * (1 + np.cos(np.pi * (-1 + 2.0 * n1 / alpha / (m - 1))))
    w2 = np.ones(n2.shape)
    w3 = 0.5 * (1 + np.cos(np.pi * (-2.0 / alpha + 1
                                    + 2.0 * n3 / alpha / (m - 1))))
    return _trim(np.concatenate([w1, w2, w3]), trim)


# ---------------------------------------------------------------------------
# parametric windows


def kaiser(m: int, beta: float, sym: bool = True) -> np.ndarray:
    w0 = _small(m)
    if w0 is not None:
        return w0
    m, trim = _extend(m, sym)
    # np.kaiser is the symmetric i0 form.
    return _trim(np.kaiser(m, beta), trim)


def gaussian(m: int, std: float, sym: bool = True) -> np.ndarray:
    w0 = _small(m)
    if w0 is not None:
        return w0
    m, trim = _extend(m, sym)
    n = np.arange(m, dtype=np.float64) - (m - 1) / 2.0
    w = np.exp(-(n ** 2) / (2.0 * std * std))
    return _trim(w, trim)


def general_gaussian(m: int, p: float, sig: float,
                     sym: bool = True) -> np.ndarray:
    w0 = _small(m)
    if w0 is not None:
        return w0
    m, trim = _extend(m, sym)
    n = np.arange(m, dtype=np.float64) - (m - 1) / 2.0
    w = np.exp(-0.5 * np.abs(n / sig) ** (2 * p))
    return _trim(w, trim)


def exponential(m: int, center: float = None, tau: float = 1.0,
                sym: bool = True) -> np.ndarray:
    if sym and center is not None:
        raise ValueError("a symmetric window is centered — give no center")
    w0 = _small(m)
    if w0 is not None:
        return w0
    m, trim = _extend(m, sym)
    if center is None:
        center = (m - 1) / 2.0
    n = np.arange(m, dtype=np.float64)
    w = np.exp(-np.abs(n - center) / tau)
    return _trim(w, trim)


def chebwin(m: int, at: float, sym: bool = True) -> np.ndarray:
    """Dolph-Chebyshev window with ``at`` dB equiripple sidelobes.

    Standard construction: the window's DFT is the order-(M-1) Chebyshev
    polynomial evaluated on the cosine frequency grid; one inverse DFT and
    peak normalization give the taps.
    """
    w0 = _small(m)
    if w0 is not None:
        return w0
    if np.abs(10 ** (np.abs(at) / 20.0)) < 1:
        raise ValueError("attenuation must be positive dB")
    m, trim = _extend(m, sym)
    order = m - 1.0
    beta = np.cosh(1.0 / order * np.arccosh(10 ** (np.abs(at) / 20.0)))
    k = np.arange(m, dtype=np.float64)
    x = beta * np.cos(np.pi * k / m)
    # T_order(x) evaluated stably on all three branches of |x| vs 1.
    p = np.zeros(x.shape)
    gt, lt = x > 1, x < -1
    mid = ~(gt | lt)
    p[gt] = np.cosh(order * np.arccosh(x[gt]))
    p[lt] = (2 * (m % 2) - 1) * np.cosh(order * np.arccosh(-x[lt]))
    p[mid] = np.cos(order * np.arccos(x[mid]))
    if m % 2:
        w = np.real(np.fft.fft(p))
        n = (m + 1) // 2
        w = w[:n]
        w = np.concatenate([w[n - 1: 0: -1], w])
    else:
        p = p * np.exp(1j * np.pi / m * np.arange(m))
        w = np.real(np.fft.fft(p))
        n = m // 2 + 1
        w = np.concatenate([w[n - 1: 0: -1], w[1:n]])
    w = w / np.max(w)
    return _trim(w, trim)


def taylor(m: int, nbar: int = 4, sll: float = 30.0, norm: bool = True,
           sym: bool = True) -> np.ndarray:
    """Taylor window (radar mainstay): near-Chebyshev sidelobe level
    ``sll`` dB with only ``nbar-1`` shaped sidelobes."""
    w0 = _small(m)
    if w0 is not None:
        return w0
    m, trim = _extend(m, sym)
    b = 10 ** (sll / 20.0)
    a = np.arccosh(b) / np.pi
    s2 = nbar ** 2 / (a ** 2 + (nbar - 0.5) ** 2)
    ma = np.arange(1, nbar, dtype=np.float64)

    fm = np.empty(nbar - 1)
    signs = np.empty_like(ma)
    signs[::2] = 1.0
    signs[1::2] = -1.0
    m2 = ma ** 2
    for mi, _ in enumerate(ma):
        numer = signs[mi] * np.prod(
            1 - m2[mi] / s2 / (a ** 2 + (ma - 0.5) ** 2))
        denom = 2 * np.prod(1 - m2[mi] / m2[:mi]) * np.prod(
            1 - m2[mi] / m2[mi + 1:])
        fm[mi] = numer / denom

    def win(n):
        return 1 + 2 * np.dot(
            fm, np.cos(2 * np.pi * ma[:, None] * (n - m / 2.0 + 0.5) / m))

    w = win(np.arange(m, dtype=np.float64))
    if norm:
        w /= win((m - 1) / 2.0)
    return _trim(w, trim)


def dpss(m: int, nw: float, sym: bool = True) -> np.ndarray:
    """First discrete prolate spheroidal (Slepian) sequence for
    time-half-bandwidth product ``nw`` — the window that maximizes energy
    concentration in band.  Computed from the classic symmetric
    tridiagonal eigenproblem; peak-normalized like scipy's windowed form.
    """
    w0 = _small(m)
    if w0 is not None:
        return w0
    m, trim = _extend(m, sym)
    wb = float(nw) / m  # half-bandwidth in cycles/sample
    n = np.arange(m, dtype=np.float64)
    diag = ((m - 1 - 2 * n) / 2.0) ** 2 * np.cos(2 * np.pi * wb)
    off = n[1:] * (m - n[1:]) / 2.0
    try:
        from scipy.linalg import eigh_tridiagonal

        _, vecs = eigh_tridiagonal(
            diag, off, select="i", select_range=(m - 1, m - 1))
        v = vecs[:, 0]
    except ImportError:  # dense fallback
        t = np.diag(diag) + np.diag(off, 1) + np.diag(off, -1)
        _, vecs = np.linalg.eigh(t)
        v = vecs[:, -1]
    if v.sum() < 0:
        v = -v
    # scipy's 'approximate' peak norm: even lengths get the interlacing
    # correction M^2/(M^2 + NW) because the true peak falls between samples.
    v /= np.max(np.abs(v))
    if m % 2 == 0:
        v *= m ** 2 / float(m ** 2 + nw)
    return _trim(v, trim)


# ---------------------------------------------------------------------------
# dispatch

_NO_ARG = {
    "boxcar": boxcar, "rect": boxcar, "rectangular": boxcar, "ones": boxcar,
    "triang": triang, "triangle": triang, "tri": triang,
    "bartlett": bartlett, "bart": bartlett, "brt": bartlett,
    "barthann": barthann, "brthan": barthann, "bth": barthann,
    "hann": hann, "han": hann,
    "hamming": hamming, "hamm": hamming, "ham": hamming,
    "blackman": blackman, "black": blackman, "blk": blackman,
    "blackmanharris": blackmanharris, "blackharr": blackmanharris,
    "bkh": blackmanharris,
    "nuttall": nuttall, "nutl": nuttall, "nut": nuttall,
    "flattop": flattop, "flat": flattop, "flt": flattop,
    "bohman": bohman, "bman": bohman, "bmn": bohman,
    "parzen": parzen, "parz": parzen, "par": parzen,
    "cosine": cosine, "halfcosine": cosine,
    "lanczos": lanczos, "sinc": lanczos,
}

_WITH_ARG = {
    "kaiser": (kaiser, 1), "ksr": (kaiser, 1),
    "gaussian": (gaussian, 1), "gauss": (gaussian, 1), "gss": (gaussian, 1),
    "general gaussian": (general_gaussian, 2),
    "general_gaussian": (general_gaussian, 2),
    "general gauss": (general_gaussian, 2), "ggs": (general_gaussian, 2),
    "general hamming": (general_hamming, 1),
    "general_hamming": (general_hamming, 1),
    "chebwin": (chebwin, 1), "cheb": (chebwin, 1),
    "exponential": (exponential, -1), "poisson": (exponential, -1),
    "tukey": (tukey, -1), "tuk": (tukey, -1),
    "taylor": (taylor, -1), "taylorwin": (taylor, -1),
    "dpss": (dpss, 1),
    "general cosine": (general_cosine, 1),
    "general_cosine": (general_cosine, 1),
}

_NEEDS_ARG_MSG = {"kaiser", "ksr", "gaussian", "gauss", "gss",
                  "general gaussian", "general_gaussian", "general gauss",
                  "ggs", "chebwin", "cheb", "dpss", "general cosine",
                  "general_cosine", "general hamming", "general_hamming"}

WindowSpec = Union[str, float, tuple]


def get_window(window: WindowSpec, nx: int, fftbins: bool = True
               ) -> np.ndarray:
    """scipy.signal.get_window-compatible dispatcher over this module's own
    window implementations.  ``fftbins=True`` (default) returns the
    periodic variant for spectral analysis; ``False`` the symmetric
    filter-design variant."""
    sym = not fftbins
    args: tuple = ()
    if isinstance(window, (float, int)) and not isinstance(window, bool):
        name, args = "kaiser", (float(window),)
    elif isinstance(window, tuple):
        if not window or not isinstance(window[0], str):
            raise ValueError("tuple window spec must start with the name")
        name, args = window[0].lower(), tuple(window[1:])
    elif isinstance(window, str):
        name = window.lower()
        if name in _NEEDS_ARG_MSG:
            raise ValueError(
                f"window {name!r} requires parameters — pass a tuple like "
                f"('{name}', arg)")
    else:
        raise ValueError(f"cannot parse window spec {window!r}")

    if name in _NO_ARG:
        if args:
            raise ValueError(f"window {name!r} takes no parameters")
        return _NO_ARG[name](nx, sym=sym)
    if name in _WITH_ARG:
        fn, nargs = _WITH_ARG[name]
        if nargs >= 0 and len(args) != nargs:
            raise ValueError(
                f"window {name!r} takes {nargs} parameter(s), got {len(args)}")
        return fn(nx, *args, sym=sym)
    raise ValueError(f"unknown window {name!r}")


def kaiser_atten(numtaps: int, width: float) -> float:
    """Stopband attenuation (dB) a Kaiser-window FIR of ``numtaps`` taps
    achieves for transition width ``width`` (fraction of Nyquist) —
    scipy.signal.kaiser_atten's inverse-of-kaiserord formula."""
    return 2.285 * (numtaps - 1) * np.pi * width + 7.95


def kaiserord(ripple_db: float, width: float) -> tuple:
    """Kaiser-window FIR order estimate (scipy.signal.kaiserord semantics):
    taps count and beta for ``ripple_db`` dB ripple/attenuation and a
    transition width ``width`` in normalized frequency (Nyquist = 1)."""
    a = abs(ripple_db)
    if a < 8:
        raise ValueError("ripple/attenuation below ~8 dB is not achievable "
                         "with a Kaiser window")
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    numtaps = (a - 7.95) / 2.285 / (np.pi * width) + 1
    return int(math.ceil(numtaps)), beta
