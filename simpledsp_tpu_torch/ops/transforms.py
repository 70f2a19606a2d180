"""Extended spectral transforms: chirp-z / Bluestein, zoom FFT, DCT,
Hilbert / analytic signal, Goertzel.

Port of ``simpledsp_tpu/ops/transforms.py``.  Every transform reduces to
the port's FFT engine (``ops/fft.py``; on a CUDA float32 tensor its sizes
n = 128 m run the frames FFT kernel) plus elementwise chirp multiplies,
with the chirp and phase tables built on the host in float64 and held in
the input's dtype on its device:

* ``czt`` / ``czt_ri``: the chirp-z transform by Bluestein's algorithm,
  ``X[k] = sum_n x[n] a^{-n} w^{nk}``; with ``w = exp(-2j pi / n), a = 1``
  the arbitrary-length DFT, which ``ops.fft`` uses for sizes with a prime
  factor above 128.
* ``zoom_fft``: the CZT on a unit-circle arc (scipy.signal.zoom_fft).
* ``dct`` / ``idct``: DCT-II / III (norms ``None`` / ``"ortho"``) by
  Makhoul's length-N real-FFT method.
* ``hilbert`` / ``analytic_ri``, ``hilbert2`` / ``hilbert2_ri``: the
  analytic signal.
* ``goertzel`` / ``goertzel_ri``: selected DFT bins as one matmul.

:class:`CZT` and :class:`ZoomFFT` are plans built from their arguments
alone (the JAX objects carry no other state); ``device=None`` puts them on
the card (:func:`simpledsp_tpu_torch.device.resolve_device`).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from simpledsp_tpu_torch.device import resolve_device
from simpledsp_tpu_torch.ops.fft import (_as_ri, _pick_real_dtype, _table,
                                         fft2_ri, fft_ri, ifft2_ri, ifft_ri,
                                         rfft_ri)
from simpledsp_tpu_torch.precision import ieee_fp32

__all__ = [
    "czt", "czt_ri", "czt_points", "zoom_fft", "zoom_fft_ri",
    "CZT", "ZoomFFT",
    "dct", "idct", "hilbert", "analytic_ri", "hilbert2", "hilbert2_ri",
    "goertzel", "goertzel_ri",
]


class CZT:
    """Callable chirp-z transform plan for fixed (n, m, w, a)
    (scipy.signal.CZT semantics) on ``device`` (None: CUDA)."""

    def __init__(self, n: int, m: "int | None" = None, w=None,
                 a: complex = 1.0 + 0.0j, *, device=None):
        self.n = int(n)
        if self.n < 1:
            raise ValueError("n must be positive")
        self.m = self.n if m is None else int(m)
        if self.m < 1:
            raise ValueError("m must be positive")
        if w is None:
            w = np.exp(-2j * np.pi / self.m)
        self.w = complex(w)
        self.a = complex(a)
        self.device = resolve_device(device)

    def __call__(self, x, *, axis: int = -1):
        x = torch.as_tensor(x, device=self.device)
        if x.shape[axis] != self.n:
            raise ValueError(
                f"CZT defined for length {self.n}, got {x.shape[axis]}")
        last = axis in (-1, x.dim() - 1)
        if not last:
            x = x.movedim(axis, -1)
        y = czt(x, self.m, w=self.w, a=self.a)
        return y if last else y.movedim(-1, axis)

    def points(self) -> np.ndarray:
        """The m z-plane evaluation points of this plan."""
        return czt_points(self.m, self.w, self.a)


class ZoomFFT(CZT):
    """Callable zoom-FFT plan (scipy.signal.ZoomFFT semantics): the CZT
    on the band [f1, f2] of the fs-periodic spectrum."""

    def __init__(self, n: int, fn, m: "int | None" = None, *,
                 fs: float = 2.0, endpoint: bool = False, device=None):
        n = int(n)
        fn = np.atleast_1d(np.asarray(fn, dtype=np.float64))
        if fn.size == 2:
            f1, f2 = float(fn[0]), float(fn[1])
        elif fn.size == 1:
            f1, f2 = 0.0, float(fn[0])
        else:
            raise ValueError("fn must be one or two frequencies")
        m = n if m is None else int(m)
        # endpoint=True stretches the span so f2 lands on the last sample.
        span = ((f2 - f1) * m / (m - 1)) if (endpoint and m > 1) \
            else (f2 - f1)
        w = np.exp(-2j * np.pi * span / (fs * m))
        a = np.exp(2j * np.pi * f1 / fs)
        super().__init__(n, m, w=w, a=a, device=device)
        self.f1, self.f2, self.fs = f1, f2, float(fs)


def czt_points(m: int, w=None, a: complex = 1.0 + 0.0j) -> np.ndarray:
    """The m z-plane evaluation points a * w**(-k) of a CZT
    (scipy.signal.czt_points semantics; host metadata)."""
    m = int(m)
    if m < 1:
        raise ValueError(f"m must be positive, got {m}")
    k = np.arange(m)
    if w is None:
        return a * np.exp(2j * np.pi * k / m)
    return a * np.asarray(w, dtype=np.complex128) ** -k


# ---------------------------------------------------------------------------
# Chirp-z transform (Bluestein)
# ---------------------------------------------------------------------------

def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


@functools.lru_cache(maxsize=None)
def _czt_tables_f64(n: int, m: int, wre: float, wim: float,
                    are: float, aim: float,
                    exact_denom: Optional[int]):
    """Host float64 chirp tables for an (n -> m) CZT with ratio w, start a:
    (qr, qi, Br, Bi, pr, pi, L) with q[j] = a^{-j} w^{+j^2/2} (j < n),
    B = fft(b, L) of the circularly wrapped filter b[k] = w^{-k^2/2},
    k in (-n, m), and p[k] = w^{+k^2/2} (k < m).

    With ``exact_denom = N``, w is exp(sign i pi / N) and the squared
    indices are reduced mod 2N in exact integers before the one trig
    evaluation (the arbitrary-N DFT's path)."""
    j = np.arange(max(n, m), dtype=np.int64)
    if exact_denom is not None:
        sign = 1.0 if wim > 0 else -1.0
        red = (j * j) % (2 * exact_denom)
        ang = (sign * np.pi / exact_denom) * red
        chr_, chi = np.cos(ang), np.sin(ang)          # w^{+j^2/2}
        mag_pow = np.ones_like(chr_)
    else:
        wang = np.arctan2(wim, wre)
        wmag = np.hypot(wre, wim)
        half_sq = 0.5 * (j.astype(np.float64) ** 2)
        ang = wang * half_sq
        chr_, chi = np.cos(ang), np.sin(ang)
        mag_pow = wmag ** half_sq
    wp_r, wp_i = chr_ * mag_pow, chi * mag_pow
    with np.errstate(divide="ignore"):
        inv_mag = np.where(mag_pow > 0, 1.0 / mag_pow, 0.0)
    wm_r, wm_i = chr_ * inv_mag, -chi * inv_mag

    aang = np.arctan2(aim, are)
    amag = np.hypot(are, aim)
    ja = np.arange(n, dtype=np.float64)
    aa = -aang * ja
    with np.errstate(divide="ignore"):
        am = amag ** (-ja)
    ar_, ai_ = np.cos(aa) * am, np.sin(aa) * am
    qr = ar_ * wp_r[:n] - ai_ * wp_i[:n]
    qi = ar_ * wp_i[:n] + ai_ * wp_r[:n]

    L = _next_pow2(n + m - 1)
    br = np.zeros(L)
    bi = np.zeros(L)
    br[:m], bi[:m] = wm_r[:m], wm_i[:m]
    if n > 1:
        br[L - n + 1:] = wm_r[1:n][::-1]
        bi[L - n + 1:] = wm_i[1:n][::-1]
    B = np.fft.fft(br + 1j * bi)
    return (qr, qi, np.ascontiguousarray(B.real),
            np.ascontiguousarray(B.imag), wp_r[:m], wp_i[:m], L)


def czt_ri(xr: torch.Tensor, xi: torch.Tensor, m: Optional[int] = None, *,
           w: Optional[complex] = None, a: complex = 1.0 + 0.0j,
           _exact_denom: Optional[int] = None,
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chirp-z transform over the last axis on (re, im) float planes
    (scipy.signal.czt semantics): chirp premultiply, a length-L circular
    convolution with the host filter spectrum (one forward and one inverse
    power-of-two FFT), chirp postmultiply."""
    n = xr.shape[-1]
    if m is None:
        m = n
    if w is None:
        # exactly exp(-2j pi / m): the exact-integer phase tables
        w = np.exp(-2j * np.pi / m)
        if _exact_denom is None:
            _exact_denom = m
    qr64, qi64, Br64, Bi64, pr64, pi64, L = _czt_tables_f64(
        n, m, float(np.real(w)), float(np.imag(w)),
        float(np.real(a)), float(np.imag(a)), _exact_denom)
    qr, qi = _table(qr64, xr), _table(qi64, xr)
    yr = torch.nn.functional.pad(xr * qr - xi * qi, (0, L - n))
    yi = torch.nn.functional.pad(xr * qi + xi * qr, (0, L - n))
    fr, fi = fft_ri(yr, yi)
    Br, Bi = _table(Br64, xr), _table(Bi64, xr)
    cr, ci = ifft_ri(fr * Br - fi * Bi, fr * Bi + fi * Br)
    cr, ci = cr[..., :m], ci[..., :m]
    pr, pi_ = _table(pr64, xr), _table(pi64, xr)
    return cr * pr - ci * pi_, cr * pi_ + ci * pr


def czt(x: torch.Tensor, m: Optional[int] = None, *,
        w: Optional[complex] = None, a: complex = 1.0 + 0.0j,
        dtype=None) -> torch.Tensor:
    """Complex-dtype wrapper over :func:`czt_ri` (scipy.signal.czt API)."""
    xr, xi = _as_ri(x, _pick_real_dtype(x, dtype))
    return torch.complex(*czt_ri(xr, xi, m, w=w, a=a))


def zoom_fft_ri(xr: torch.Tensor, xi: torch.Tensor,
                fn: Union[float, Sequence[float]], m: Optional[int] = None,
                *, fs: float = 2.0, endpoint: bool = False,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """m DFT samples on the unit-circle arc [f1, f2] (scipy.signal.zoom_fft
    semantics; ``fn`` a scalar means [0, fn]): a CZT with |w| = |a| = 1."""
    n = xr.shape[-1]
    if m is None:
        m = n
    f1, f2 = (0.0, float(fn)) if np.isscalar(fn) else map(float, fn)
    span = ((f2 - f1) * m / (m - 1)) if (endpoint and m > 1) else (f2 - f1)
    w = np.exp(-2j * np.pi * span / (fs * m))
    a = np.exp(2j * np.pi * f1 / fs)
    return czt_ri(xr, xi, m, w=w, a=a)


def zoom_fft(x: torch.Tensor, fn, m: Optional[int] = None, *,
             fs: float = 2.0, endpoint: bool = False,
             dtype=None) -> torch.Tensor:
    """Complex-dtype wrapper over :func:`zoom_fft_ri`."""
    xr, xi = _as_ri(x, _pick_real_dtype(x, dtype))
    return torch.complex(*zoom_fft_ri(xr, xi, fn, m, fs=fs,
                                      endpoint=endpoint))


# ---------------------------------------------------------------------------
# DCT-II / DCT-III (Makhoul single-FFT method)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _dct_phase_f64(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """cos/sin of pi k / (2 n), k < n, exact-integer phase reduction."""
    k = np.arange(n, dtype=np.int64) % (4 * n)
    ang = (np.pi / (2 * n)) * k
    return np.cos(ang), np.sin(ang)


def _full_spectrum_from_rfft(vr, vi, n):
    """Mirror one-sided (n//2+1) real-input FFT planes to all n bins."""
    lo = n // 2 + 1
    tr = vr[..., 1:n - lo + 1].flip(-1)
    ti = -vi[..., 1:n - lo + 1].flip(-1)
    return torch.cat([vr, tr], -1), torch.cat([vi, ti], -1)


def dct(x: torch.Tensor, type: int = 2, *, norm: Optional[str] = None
        ) -> torch.Tensor:
    """DCT over the last axis of a REAL tensor (scipy.fft.dct types 2 and 3,
    norm ``None`` or ``"ortho"``), any length.

    Type 2 (Makhoul): v = [x[0::2]; reversed(x[1::2])], one length-N real
    FFT, then ``X[k] = 2 (cos(pi k/2N) Re V[k] + sin(pi k/2N) Im V[k])``.
    Type 3 is the transpose, run as the inverse chain."""
    if x.is_complex():
        raise ValueError("dct expects a real array")
    n = x.shape[-1]
    cos64, sin64 = _dct_phase_f64(n)
    cosk, sink = _table(cos64, x), _table(sin64, x)
    half = (n + 1) // 2
    if type == 2:
        v = torch.cat([x[..., 0::2], x[..., 1::2].flip(-1)], -1)
        vr, vi = _full_spectrum_from_rfft(*rfft_ri(v), n)
        y = 2.0 * (cosk * vr + sink * vi)
        if norm == "ortho":
            s = np.full(n, np.sqrt(1.0 / (2 * n)))
            s[0] = np.sqrt(1.0 / (4 * n))
            y = y * _table(s, x)
        elif norm is not None:
            raise ValueError(f"unsupported norm {norm!r}")
        return y
    if type == 3:
        y = x
        if norm == "ortho":
            # Transpose of the ortho DCT-II: z[0] = y[0]/sqrt(N),
            # z[k>=1] = y[k]/sqrt(2N) feed the unnormalized type-3 chain.
            s = np.full(n, np.sqrt(1.0 / (2 * n)))
            s[0] = np.sqrt(1.0 / n)
            y = y * _table(s, x)
        elif norm is not None:
            raise ValueError(f"unsupported norm {norm!r}")
        # U[k] = (y[k] - i y_rev[k]) e^{i pi k / 2N}, y_rev = [0, -y[N-1:0:-1]]
        yrev = torch.cat([torch.zeros_like(y[..., :1]),
                          -y[..., 1:].flip(-1)], -1)
        ur = y * cosk - yrev * sink
        ui = y * sink + yrev * cosk
        vr, _ = fft_ri(ur, -ui)          # ifft * N == conj(fft(conj(U)))
        out = torch.empty_like(y)
        out[..., 0::2] = vr[..., :half]
        out[..., 1::2] = vr[..., half:].flip(-1)
        return out
    raise ValueError(f"unsupported DCT type {type} (have 2, 3)")


def idct(x: torch.Tensor, type: int = 2, *, norm: Optional[str] = None
         ) -> torch.Tensor:
    """Inverse DCT (scipy.fft.idct): idct(type=2) = dct(type=3) scaled."""
    n = x.shape[-1]
    if type == 2:
        if norm == "ortho":
            return dct(x, type=3, norm="ortho")
        return dct(x, type=3) * (1.0 / (2.0 * n))
    if type == 3:
        if norm == "ortho":
            return dct(x, type=2, norm="ortho")
        return dct(x, type=2) * (1.0 / (2.0 * n))
    raise ValueError(f"unsupported IDCT type {type} (have 2, 3)")


# ---------------------------------------------------------------------------
# Analytic signal / Hilbert transform
# ---------------------------------------------------------------------------

def analytic_ri(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Analytic signal of a real tensor over the last axis as (re, im)
    planes (scipy.signal.hilbert): keep DC and (even N) Nyquist, double
    bins 0 < k < N/2, zero the negative half, inverse FFT."""
    if x.is_complex():
        raise ValueError("analytic_ri expects a real array")
    n = x.shape[-1]
    vr, vi = rfft_ri(x)
    nb = vr.shape[-1]
    scale = np.full(nb, 2.0)
    scale[0] = 1.0
    if n % 2 == 0:
        scale[-1] = 1.0
    sc = _table(scale, x)
    pad = (0, n - nb)
    return ifft_ri(torch.nn.functional.pad(vr * sc, pad),
                   torch.nn.functional.pad(vi * sc, pad))


def hilbert(x: torch.Tensor) -> torch.Tensor:
    """Complex analytic signal (scipy.signal.hilbert semantics)."""
    return torch.complex(*analytic_ri(x))


def hilbert2_ri(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """2-D analytic signal over the last two axes as (re, im) planes
    (scipy.signal.hilbert2): fft2, the separable one-sided weights
    h1[u] h2[v] (1 at DC, 2 for 1 <= k < (N+1)//2, 0 elsewhere: the
    even-N Nyquist bin is zeroed, unlike the 1-D hilbert), inverse fft2."""
    if x.is_complex():
        raise ValueError("hilbert2_ri expects a real array")
    if x.dim() < 2:
        raise ValueError("hilbert2_ri needs at least 2 dims")

    def axis_weights(n: int) -> np.ndarray:
        w = np.zeros(n)
        w[0] = 1.0
        w[1:(n + 1) // 2] = 2.0
        return w

    h, w_ = x.shape[-2:]
    g = _table(np.outer(axis_weights(h), axis_weights(w_)), x)
    ur, ui = fft2_ri(x, torch.zeros_like(x))
    return ifft2_ri(ur * g, ui * g)


def hilbert2(x: torch.Tensor) -> torch.Tensor:
    """Complex 2-D analytic signal (scipy.signal.hilbert2 semantics)."""
    return torch.complex(*hilbert2_ri(x))


# ---------------------------------------------------------------------------
# Goertzel (selected-bin DFT)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _goertzel_rows_f64(n: int, bins: Tuple[int, ...]):
    k = np.asarray(bins, dtype=np.int64).reshape(-1, 1)
    j = np.arange(n, dtype=np.int64).reshape(1, -1)
    ang = (-2.0 * np.pi / n) * ((k * j) % n)
    return np.cos(ang), np.sin(ang)


def goertzel_ri(x: torch.Tensor, bins: Sequence[int]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DFT at selected bins of a REAL signal: (..., n) -> (..., len(bins)),
    one matmul against host cos / -sin rows with exact mod-n phases."""
    n = x.shape[-1]
    cr64, si64 = _goertzel_rows_f64(n, tuple(int(b) for b in bins))
    with ieee_fp32():
        return x @ _table(cr64.T, x), x @ _table(si64.T, x)


def goertzel(x: torch.Tensor, bins: Sequence[int]) -> torch.Tensor:
    """Complex DFT values at selected bins (see :func:`goertzel_ri`)."""
    return torch.complex(*goertzel_ri(x, bins))
