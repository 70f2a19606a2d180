"""Spectral analysis built on the batched FFT engine.

Port of ``simpledsp_tpu/ops/spectral.py``: spectrograms and the short-time
Fourier transform and its inverse, Welch and cross spectral densities,
coherence, periodograms, Lomb-Scargle, envelopes, and the host helpers
(windows, COLA / NOLA checks, STFT dual windows, vector strength).  Windows
are host float64 constants; transforms run through ``ops/fft`` (on a CUDA
float32 tensor, sizes n = 128 m run the frames FFT kernel).  Frames are
``unfold`` views of the signal, the JAX package's gather-free framing.

``method="auto"`` keeps the JAX package's crossover: nfft <= 2048 takes the
direct route, one large matmul against the window-folded DFT table
(``torch.matmul`` in IEEE float32), larger nfft the FFT engine.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from simpledsp_tpu_torch.ops import fft as _fft
from simpledsp_tpu_torch.ops.fft import _cached_table, _table
from simpledsp_tpu_torch.precision import ieee_fp32

__all__ = ["spectrogram_ri", "welch_psd", "window_taps",
           "stft_ri", "istft_ri", "csd_ri", "coherence", "periodogram",
           "lombscargle", "check_COLA", "check_NOLA", "vectorstrength",
           "envelope", "envelope_ri", "stft_dual_window",
           "closest_STFT_dual_window"]


def _hop_fold(x: np.ndarray, hop: int) -> np.ndarray:
    """sum_k x shifted by every nonzero multiple of hop, added to x: the
    periodization in every STFT dual-window identity."""
    out = x.copy()
    for k in range(hop, x.size, hop):
        out[k:] += x[:-k]
        out[:-k] += x[k:]
    return out


def stft_dual_window(win, hop: int) -> np.ndarray:
    """Canonical dual window of ``win`` at time step ``hop`` (scipy's
    ShortTimeFFT.dual_win semantics; host float64).  Raises if the STFT is
    not invertible (NOLA violated)."""
    win = np.asarray(win)
    if np.issubdtype(win.dtype, np.integer):
        raise ValueError("win cannot be of integer dtype")
    if not (isinstance(hop, (int, np.integer)) and 1 <= hop <= win.size):
        raise ValueError(f"hop={hop} must be an integer in "
                         f"[1, len(win)={win.size}]")
    dd = _hop_fold(win.real ** 2 + win.imag ** 2, hop)
    if not np.all(dd >= np.finfo(win.dtype).resolution * dd.max()):
        raise ValueError("STFT not invertible for this (win, hop) "
                         "(NOLA violated)")
    return win / dd


def closest_STFT_dual_window(win, hop: int, desired_dual=None, *,
                             scaled: bool = True):
    """The valid STFT dual window closest to ``desired_dual``
    (scipy.signal.closest_STFT_dual_window semantics).  Returns
    ``(dual_win, alpha)``."""
    win = np.asarray(win)
    desired = np.ones_like(win) if desired_dual is None \
        else np.asarray(desired_dual)
    if win.ndim != 1 or win.shape != desired.shape:
        raise ValueError("win and desired_dual must be equal-length 1-D")
    if not (np.all(np.isfinite(win)) and np.all(np.isfinite(desired))):
        raise ValueError("win and desired_dual must be finite")
    if not (isinstance(hop, (int, np.integer)) and 1 <= hop <= win.size):
        raise ValueError(f"hop={hop} must be an integer in "
                         f"[1, len(win)={win.size}]")
    w_d = stft_dual_window(win, hop)
    q_d = w_d * _hop_fold(np.conjugate(win) * desired, hop)
    if not scaled:
        return w_d + desired - q_d, 1.0
    num = np.conjugate(q_d) @ w_d
    den = q_d.real @ q_d.real + q_d.imag @ q_d.imag
    if not (abs(num) > 0 and den > np.finfo(w_d.dtype).resolution):
        raise ValueError("scaled closest dual window is numerically "
                         "unstable; try scaled=False")
    alpha = num / den
    return w_d + alpha * (desired - q_d), alpha


def _validate_overlap(nperseg: int, noverlap: int) -> Tuple[int, int]:
    nperseg, noverlap = int(nperseg), int(noverlap)
    if nperseg < 1 or not 0 <= noverlap < nperseg:
        raise ValueError(f"need 0 <= noverlap < nperseg, got "
                         f"{noverlap}/{nperseg}")
    return nperseg, noverlap


def _overlap_sums(w: np.ndarray, step: int) -> np.ndarray:
    acc = np.zeros(step)
    for ofs in range(0, w.size, step):
        seg = w[ofs: ofs + step]
        acc[: seg.size] += seg
    return acc


def check_COLA(window, nperseg: int, noverlap: int,
               tol: float = 1e-10) -> bool:
    """Constant-OverLap-Add check (scipy.signal.check_COLA semantics)."""
    nperseg, noverlap = _validate_overlap(nperseg, noverlap)
    sums = _overlap_sums(window_taps(window, nperseg), nperseg - noverlap)
    return bool(np.max(np.abs(sums - sums[0])) < tol * max(sums[0], 1e-30))


def check_NOLA(window, nperseg: int, noverlap: int,
               tol: float = 1e-10) -> bool:
    """NOnzero-OverLap-Add check (scipy.signal.check_NOLA semantics): the
    exact invertibility condition of :func:`istft_ri`."""
    nperseg, noverlap = _validate_overlap(nperseg, noverlap)
    acc = _overlap_sums(window_taps(window, nperseg) ** 2, nperseg - noverlap)
    return bool(np.min(acc) > tol * max(np.max(acc), 1e-30))


def vectorstrength(events, period):
    """Vector strength of event times against one or more periods
    (scipy.signal.vectorstrength semantics): (strength, phase)."""
    events = np.asarray(events, dtype=np.float64)
    period = np.asarray(period, dtype=np.float64)
    scalar = period.ndim == 0
    per = np.atleast_1d(period)
    if np.any(per <= 0):
        raise ValueError("periods must be positive")
    ang = 2.0 * np.pi * events[None, :] / per[:, None]
    ph = np.exp(1j * ang).mean(axis=-1)
    strength, phase = np.abs(ph), np.angle(ph)
    if scalar:
        return float(strength[0]), float(phase[0])
    return strength, phase


def window_taps(kind, n: int) -> np.ndarray:
    """Host analysis window in its PERIODIC form (float64; the
    scipy.signal.get_window default), from ``design/windows``."""
    if kind in ("rect", "none"):
        return np.ones(n)
    from simpledsp_tpu_torch.design.windows import get_window

    return get_window(kind, n, fftbins=True).astype(np.float64)


def _detrend_frames(frames: torch.Tensor, detrend) -> torch.Tensor:
    """Per-segment detrend (scipy.signal.welch semantics): 'constant'
    removes each segment's mean, 'linear' its least-squares line."""
    if detrend in (False, None, "none"):
        return frames
    if detrend == "constant":
        return frames - frames.mean(-1, keepdim=True)
    if detrend == "linear":
        n = frames.shape[-1]
        t = np.arange(n, dtype=np.float64)
        basis = np.stack([np.ones(n), t], axis=1)          # (n, 2)
        pinv = np.linalg.pinv(basis)                       # (2, n)
        with ieee_fp32():
            coef = frames @ _table(pinv.T, frames)
            return frames - coef @ _table(basis.T, frames)
    raise ValueError(f"unknown detrend {detrend!r}")


def _windowed_frames(x: torch.Tensor, nfft: int, hop: Optional[int],
                     window: str, detrend) -> torch.Tensor:
    hop = hop or nfft
    t = x.shape[-1]
    if (t - nfft) // hop + 1 < 1:
        raise ValueError(f"signal length {t} shorter than nfft={nfft}")
    frames = _detrend_frames(x.unfold(-1, nfft, hop), detrend)
    return frames * _table(window_taps(window, nfft), x)


@functools.lru_cache(maxsize=None)
def _windowed_dft_f64(nfft: int, window: str, onesided: bool):
    """(cos, sin) parts of the window-folded DFT table W[t, k] =
    w[t] e^{-2 pi i t k / nfft} (host float64, exact mod-N phases)."""
    nb = nfft // 2 + 1 if onesided else nfft
    t = np.arange(nfft, dtype=np.int64)[:, None]
    k = np.arange(nb, dtype=np.int64)[None, :]
    ang = (-2.0 * np.pi / nfft) * ((t * k) % nfft)
    w = window_taps(window, nfft)[:, None]
    return np.ascontiguousarray(w * np.cos(ang)), \
        np.ascontiguousarray(w * np.sin(ang))


def spectrogram_ri(x: torch.Tensor, nfft: int = 1024, *,
                   hop: Optional[int] = None, window: str = "hann",
                   detrend=False, onesided: bool = False,
                   method: str = "auto"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Framed windowed FFT of a real signal: (..., T) -> (re, im) planes
    (..., nframes, nfft), or nfft//2 + 1 bins with ``onesided=True``
    (the half-cost real-input transform).  hop defaults to nfft.
    ``detrend`` (False | 'constant' | 'linear') acts before the window.

    method: 'fft' (the engine), 'direct' (one matmul against the
    window-folded DFT table) or 'auto' (direct for nfft <= 2048, the JAX
    package's crossover)."""
    if method not in ("auto", "fft", "direct"):
        raise ValueError(f"unknown method {method!r}")
    if method == "direct" or (method == "auto" and nfft <= 2048):
        frames = _windowed_frames(x, nfft, hop, "rect", detrend)
        wc, ws = _cached_table(_windowed_dft_f64, (nfft, window, onesided),
                               x.dtype, x.device)
        with ieee_fp32():
            return frames @ wc, frames @ ws
    frames = _windowed_frames(x, nfft, hop, window, detrend)
    if onesided:
        return _fft.rfft_ri(frames)
    return _fft.fft_ri(frames, torch.zeros_like(frames))


@functools.lru_cache(maxsize=None)
def _synth_idft_f64(nfft: int, window: str, onesided: bool):
    """(cos, sin) synthesis tables folding the inverse DFT, the Hermitian
    doubling weights, 1/nfft and the synthesis window into one matmul pair:
    frame = sr @ C + si @ S (host float64, exact mod-N phases)."""
    t = np.arange(nfft, dtype=np.int64)[None, :]
    nb = nfft // 2 + 1 if onesided else nfft
    k = np.arange(nb, dtype=np.int64)[:, None]
    ang = (2.0 * np.pi / nfft) * ((t * k) % nfft)
    if onesided:
        ck = np.full((nb, 1), 2.0)
        ck[0] = 1.0
        if nfft % 2 == 0:
            ck[-1] = 1.0
    else:
        ck = np.ones((nb, 1))
    w = window_taps(window, nfft)[None, :] * ck / nfft
    return np.ascontiguousarray(w * np.cos(ang)), \
        np.ascontiguousarray(-w * np.sin(ang))


def stft_ri(x: torch.Tensor, nfft: int = 1024, *,
            hop: Optional[int] = None, window: str = "hann",
            onesided: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Short-time Fourier transform of a real signal (scipy.signal.stft
    with ``boundary=None, padded=False`` times ``sum(w)``): (..., T) ->
    (re, im) planes (..., nframes, nfft//2+1) (nfft bins with
    ``onesided=False``); hop defaults to nfft // 2.  Inverted exactly by
    :func:`istft_ri`."""
    return spectrogram_ri(x, nfft, hop=hop or nfft // 2, window=window,
                          onesided=onesided)


def istft_ri(sr: torch.Tensor, si: torch.Tensor, nfft: int = 1024, *,
             hop: Optional[int] = None, window: str = "hann",
             onesided: bool = True, method: str = "auto") -> torch.Tensor:
    """Inverse STFT by weighted overlap-add: (..., nframes, nbins) planes
    -> (..., (nframes-1)*hop + nfft) real signal, normalized by the
    window-power overlap (the least-squares inverse: any window and hop
    that satisfy NOLA).  The overlap-add is q = nfft // hop shifted pads on
    the frame axis; the normalizer is a host float64 constant.  Requires
    hop | nfft.  method as for :func:`spectrogram_ri`."""
    hop = hop or nfft // 2
    if nfft % hop:
        raise ValueError(f"hop={hop} must divide nfft={nfft}")
    if method not in ("auto", "fft", "direct"):
        raise ValueError(f"unknown method {method!r}")
    q = nfft // hop
    w64 = window_taps(window, nfft)
    if method == "direct" or (method == "auto" and nfft <= 2048):
        cr, ci = _cached_table(_synth_idft_f64, (nfft, window, onesided),
                               sr.dtype, sr.device)
        with ieee_fp32():
            fw = sr @ cr + si @ ci
    elif onesided:
        fw = _fft.irfft_ri(sr, si, nfft) * _table(w64, sr)
    else:
        fw = _fft.ifft_ri(sr, si)[0] * _table(w64, sr)
    nframes = fw.shape[-2]
    fw = fw.reshape(fw.shape[:-1] + (q, hop))     # (..., F, q, hop)
    total = None
    for j in range(q):
        part = torch.nn.functional.pad(fw[..., j, :], (0, 0, j, q - 1 - j))
        total = part if total is None else total + part
    y = total.reshape(total.shape[:-2] + ((nframes + q - 1) * hop,))
    t_out = (nframes - 1) * hop + nfft
    den, = _cached_table(_ola_norm_f64, (nframes, nfft, hop, window),
                         y.dtype, y.device)
    return y[..., :t_out] / den


@functools.lru_cache(maxsize=None)
def _ola_norm_f64(nframes: int, nfft: int, hop: int, window):
    """The window-power overlap of :func:`istft_ri`'s overlap-add (host
    float64, as a 1-tuple): the w^2 chunks summed into the same q output
    blocks, with near-zero sums replaced by 1."""
    w64 = window_taps(window, nfft)
    q = nfft // hop
    w2 = (w64 * w64).reshape(q, hop)
    den = np.zeros((nframes + q - 1, hop))
    for j in range(q):
        den[j: j + nframes] += w2[j]
    den = den.reshape(-1)[: (nframes - 1) * hop + nfft]
    return (np.where(den > 1e-10 * np.max(den), den, 1.0),)


def _onesided_scale(nfft: int, fs: float, w: np.ndarray) -> np.ndarray:
    """Density scaling of a one-sided spectrum: every bin doubled except
    DC and (even nfft) Nyquist, over fs sum(w^2)."""
    top = nfft // 2 if nfft % 2 == 0 else nfft // 2 + 1
    scale = np.ones(nfft // 2 + 1)
    scale[1:top] = 2.0
    return scale / (fs * np.sum(w ** 2))


def csd_ri(x: torch.Tensor, y: torch.Tensor, nfft: int = 1024, *,
           fs: float = 1.0, window: str = "hann", overlap: bool = True,
           detrend="constant"
           ) -> Tuple[np.ndarray, torch.Tensor, torch.Tensor]:
    """Welch-averaged one-sided cross-spectral density of two real signals:
    (freqs, re(Pxy), im(Pxy)) with scipy.signal ``csd(...,
    scaling='density')`` conventions (Pxy = mean over segments of conj(X)
    Y)."""
    hop = nfft // 2 if overlap else nfft
    if x.shape[-1] != y.shape[-1]:
        raise ValueError("csd_ri requires equal signal lengths "
                         f"({x.shape[-1]} vs {y.shape[-1]})")
    xr, xi = spectrogram_ri(x, nfft, hop=hop, window=window,
                            detrend=detrend, onesided=True)
    yr, yi = spectrogram_ri(y, nfft, hop=hop, window=window,
                            detrend=detrend, onesided=True)
    pr = (xr * yr + xi * yi).mean(-2)             # re(conj(X) Y)
    pi = (xr * yi - xi * yr).mean(-2)             # im(conj(X) Y)
    scale = _table(_onesided_scale(nfft, fs, window_taps(window, nfft)), pr)
    return np.fft.rfftfreq(nfft, 1.0 / fs), pr * scale, pi * scale


def coherence(x: torch.Tensor, y: torch.Tensor, nfft: int = 1024, *,
              fs: float = 1.0, window: str = "hann", overlap: bool = True,
              detrend="constant") -> Tuple[np.ndarray, torch.Tensor]:
    """Magnitude-squared coherence |Pxy|^2 / (Pxx Pyy) (scipy.signal
    ``coherence`` conventions): (freqs, Cxy in [0, 1])."""
    freqs, pr, pi = csd_ri(x, y, nfft, fs=fs, window=window,
                           overlap=overlap, detrend=detrend)
    _, pxx = welch_psd(x, nfft, fs=fs, window=window, overlap=overlap,
                       detrend=detrend)
    _, pyy = welch_psd(y, nfft, fs=fs, window=window, overlap=overlap,
                       detrend=detrend)
    return freqs, (pr * pr + pi * pi) / (pxx * pyy)


def lombscargle(x, y, freqs, *, precenter: bool = False,
                normalize: bool = False) -> torch.Tensor:
    """Lomb-Scargle periodogram of unevenly sampled data
    (scipy.signal.lombscargle semantics: x sample times, y values, freqs in
    rad/s), the tau-shifted form vectorized over frequencies: the sums are
    (..., N) @ (N, F) matmuls and tau comes from the double-angle atan2.
    y may carry leading batch dims over a shared time base x."""
    x = torch.as_tensor(x)
    y = torch.as_tensor(y, device=x.device)
    if x.dim() != 1:
        raise ValueError("x must be 1-D sample times")
    if y.shape[-1] != x.shape[0]:
        raise ValueError(f"y trailing axis {y.shape[-1]} != len(x) "
                         f"{x.shape[0]}")
    freqs = torch.as_tensor(freqs, dtype=x.dtype, device=x.device)
    if precenter:
        y = y - y.mean(-1, keepdim=True)
    ang = freqs[:, None] * x[None, :]                     # (F, N)
    c, s = torch.cos(ang), torch.sin(ang)
    s2 = 2.0 * (s * c).sum(-1)
    c2 = ((c - s) * (c + s)).sum(-1)
    two_wt = torch.atan2(s2, c2)
    ct = torch.cos(0.5 * two_wt)[:, None]                 # cos(w tau)
    st = torch.sin(0.5 * two_wt)[:, None]
    cshift = c * ct + s * st                              # cos w(x - tau)
    sshift = s * ct - c * st
    with ieee_fp32():
        yc = y @ cshift.T
        ys = y @ sshift.T
    cc = (cshift * cshift).sum(-1)
    ss_ = (sshift * sshift).sum(-1)
    pgram = 0.5 * (yc * yc / cc + ys * ys / ss_)
    if normalize:
        pgram = pgram * (2.0 / (y * y).sum(-1, keepdim=True))
    return pgram


def periodogram(x: torch.Tensor, *, fs: float = 1.0,
                window: str = "boxcar", nfft: Optional[int] = None,
                detrend="constant") -> Tuple[np.ndarray, torch.Tensor]:
    """Single-segment one-sided PSD (scipy.signal ``periodogram``
    conventions: the window spans the signal, zero-padding to ``nfft``
    after windowing, 'density' scaling)."""
    n = x.shape[-1]
    nfft = nfft or n
    if nfft < n:
        raise ValueError(f"nfft={nfft} < signal length {n}")
    frames = _windowed_frames(x, n, None, window, detrend)
    if nfft > n:
        frames = torch.nn.functional.pad(frames, (0, nfft - n))
    sr, si = _fft.rfft_ri(frames)
    half = (sr * sr + si * si).squeeze(-2)
    scale = _onesided_scale(nfft, fs, window_taps(window, n))
    return np.fft.rfftfreq(nfft, 1.0 / fs), half * _table(scale, half)


def welch_psd(x: torch.Tensor, nfft: int = 1024, *, fs: float = 1.0,
              window: str = "hann", overlap: bool = True,
              detrend="constant") -> Tuple[np.ndarray, torch.Tensor]:
    """Welch-averaged one-sided PSD of a real signal: (freqs (nfft//2+1,),
    psd (..., nfft//2+1)) with scipy.signal ``welch(...,
    scaling='density')`` conventions, detrend='constant' by default."""
    hop = nfft // 2 if overlap else nfft
    sr, si = spectrogram_ri(x, nfft, hop=hop, window=window,
                            detrend=detrend, onesided=True)
    half = (sr * sr + si * si).mean(-2)
    scale = _onesided_scale(nfft, fs, window_taps(window, nfft))
    return np.fft.rfftfreq(nfft, 1.0 / fs), half * _table(scale, half)


def _band(n: int, bp_in, n_out, residual) -> Tuple[int, int, int]:
    """Validated (lo, hi, n_out) of an envelope call."""
    if n < 1:
        raise ValueError("empty signal")
    if len(bp_in) != 2 or not all(b is None or isinstance(b, int)
                                  for b in bp_in):
        raise ValueError("bp_in must be a 2-tuple of int | None")
    if residual not in ("lowpass", "all", None):
        raise ValueError("residual must be 'lowpass', 'all', or None")
    n_out = n if n_out is None else int(n_out)
    if n_out < 1:
        raise ValueError("n_out must be positive")
    lo = bp_in[0] if bp_in[0] is not None else -(n // 2)
    hi = bp_in[1] if bp_in[1] is not None else (n + 1) // 2
    if not (-n // 2 <= lo < hi <= (n + 1) // 2):
        raise ValueError(f"invalid bp_in={bp_in} for n={n}")
    return lo, hi, n_out


def _residual_mask(n: int, lo: int, hi: int, residual: str) -> np.ndarray:
    """scipy.signal.envelope's zeroing branches as a boolean mask: True
    where the residual's spectrum is zeroed."""
    sl = np.zeros(n, dtype=bool)
    if not (lo <= 0 < hi):
        sl[lo:hi] = True          # python slice: positive OR negative band
    else:
        sl[:hi] = True
        sl[lo:] = True
    if residual == "lowpass":
        if hi > 0:
            sl[hi:(n + 1) // 2] = True
        else:
            sl[lo:] = True
            sl[: (n + 1) // 2] = True
    return sl


def _baseband(spec: torch.Tensor, n: int, lo: int, hi: int, n_out: int
              ) -> torch.Tensor:
    """The in-band bins of the n-bin spectrum, inverse transformed at
    n_out points and scaled by n_out / n."""
    if not (lo <= 0 < hi):
        # python slicing, as scipy: a positive or a negative band
        band = spec[..., lo:hi]
    else:
        band = torch.roll(spec, n // 2, -1)[..., lo + n // 2: hi + n // 2]
    return _ifft_resampled(band, n_out) * (n_out / n)


def envelope(z, bp_in: Tuple = (1, None), *, n_out: Optional[int] = None,
             squared: bool = False, residual: Optional[str] = "lowpass",
             axis: int = -1):
    """Envelope of a signal with optional residual (scipy.signal.envelope
    semantics): the magnitude of the signal restricted to the in-band bins
    ``bp_in = (lo, hi)`` of the length-n DFT, resampled to ``n_out``;
    ``residual`` returns what the band excluded ('lowpass': the bins below
    the band; 'all': everything outside; None: the envelope alone, else
    the two stacked).  Real input follows scipy's analytic-signal branch,
    complex input its full-spectrum branch (:func:`envelope_ri` takes
    (re, im) planes)."""
    z = torch.as_tensor(z)
    if z.is_complex():
        return _envelope_complex(z, bp_in, n_out=n_out, squared=squared,
                                 residual=residual, axis=axis)
    if axis != -1:
        z = z.movedim(axis, -1)
    n = z.shape[-1]
    lo, hi, n_out = _band(n, bp_in, n_out, residual)
    fak = n_out / n
    zr = _fft.rfft(z.to(torch.promote_types(z.dtype, torch.float32)))
    full = torch.zeros(z.shape[:-1] + (n,), dtype=zr.dtype, device=z.device)
    full[..., : n // 2 + 1] = zr
    if lo > 0:
        full[..., lo:hi] *= 2.0
    elif hi > 0:
        full[..., 1:hi] *= 2.0
    z_bb = _baseband(full, n, lo, hi, n_out)
    env = z_bb.real ** 2 + z_bb.imag ** 2 if squared else z_bb.abs()
    if residual is None:
        return env if axis in (-1, z.dim() - 1) else env.movedim(-1, axis)
    keep = _table((~_residual_mask(n, lo, hi, residual)).astype(np.float64),
                  full.real)
    fullr = full * keep
    # scipy's irfft drops the imaginary part of the bin that becomes (or
    # stops being) Nyquist when resampling; take the real part first.
    if n_out != n and (m := min(n, n_out)) % 2 == 0:
        fullr[..., m // 2] = (2.0 if n_out < n else 0.5) * \
            fullr[..., m // 2].real.to(fullr.dtype)
    if n_out <= n:
        spec_half = fullr[..., : n_out // 2 + 1]
    else:
        spec_half = torch.nn.functional.pad(
            fullr[..., : n // 2 + 1], (0, n_out // 2 + 1 - (n // 2 + 1)))
    res = fak * _fft.irfft(spec_half, n_out)
    if axis not in (-1, env.dim() - 1):
        env = env.movedim(-1, axis)
        res = res.movedim(-1, axis)
    return torch.stack([env, res], 0)


def _ifft_resampled(band: torch.Tensor, n_out: int) -> torch.Tensor:
    """ifft(band, n=n_out): numpy's convention, the spectrum's tail cropped
    or zero-padded to n_out before the inverse transform."""
    m = band.shape[-1]
    if n_out < m:
        band = band[..., :n_out]
    elif n_out > m:
        band = torch.nn.functional.pad(band, (0, n_out - m))
    return _fft.ifft(band)


def _envelope_complex(z: torch.Tensor, bp_in: Tuple, *,
                      n_out: Optional[int], squared: bool,
                      residual: Optional[str], axis: int):
    """scipy.signal.envelope's complex-input branch: the full spectrum (no
    analytic doubling), the residual through the frequency-domain
    resample's Nyquist corrections (scipy.signal.resample domain='freq')."""
    if axis != -1:
        z = z.movedim(axis, -1)
    n = z.shape[-1]
    lo, hi, n_out = _band(n, bp_in, n_out, residual)
    fak = n_out / n
    Z = _fft.fft(z)
    z_bb = _baseband(Z, n, lo, hi, n_out)
    env = z_bb.real ** 2 + z_bb.imag ** 2 if squared else z_bb.abs()
    if residual is None:
        return env if axis in (-1, z.dim() - 1) else env.movedim(-1, axis)
    keep = _table((~_residual_mask(n, lo, hi, residual)).astype(np.float64),
                  env)
    Zr = Z * keep
    if n_out == n:
        z_res = _fft.ifft(Zr)
    else:
        m = min(n_out, n)
        nyq = m // 2 + 1
        y_spec = torch.zeros(z.shape[:-1] + (n_out,), dtype=Zr.dtype,
                             device=Zr.device)
        y_spec[..., :nyq] = Zr[..., :nyq]
        if m > 2:
            y_spec[..., nyq - m:] = Zr[..., nyq - m:]
        if m % 2 == 0:
            if n_out < n:       # join the straddled -m/2 bin
                y_spec[..., -(m // 2)] += Zr[..., n - m // 2]
            else:               # split: halve +m/2 and mirror to -m/2
                y_spec[..., m // 2] *= 0.5
                y_spec[..., n_out - m // 2] = y_spec[..., m // 2]
        z_res = _fft.ifft(y_spec) * fak
    if axis not in (-1, env.dim() - 1):
        env = env.movedim(-1, axis)
        z_res = z_res.movedim(-1, axis)
    return torch.stack([env.to(z_res.dtype), z_res], 0)


def envelope_ri(zr, zi, bp_in: Tuple = (1, None), *,
                n_out: Optional[int] = None, squared: bool = False,
                residual: Optional[str] = "lowpass", axis: int = -1):
    """Complex-signal envelope on (re, im) planes (scipy.signal.envelope
    complex semantics).  Returns ``env`` (real) when ``residual`` is None,
    else ``(env, (res_r, res_i))``."""
    zr = torch.as_tensor(zr)
    zi = torch.as_tensor(zi, device=zr.device)
    dt = torch.promote_types(torch.promote_types(zr.dtype, zi.dtype),
                             torch.float32)
    z = torch.complex(zr.to(dt), zi.to(dt))
    out = _envelope_complex(z, bp_in, n_out=n_out, squared=squared,
                            residual=residual, axis=axis)
    if residual is None:
        return out
    return out[0].real, (out[1].real, out[1].imag)
