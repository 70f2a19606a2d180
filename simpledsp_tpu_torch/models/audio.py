"""Audio feature extraction on torch tensors: mel spectrogram, MFCC and
Griffin-Lim.

Port of ``simpledsp_tpu/models/audio.py``: framed STFT (``ops/spectral``)
-> power -> mel filterbank (one dense matmul in IEEE float32) -> log ->
orthonormal DCT-II (``ops/transforms.dct``), batched over leading axes.
The filterbank is host float64 NumPy, carried verbatim;
:class:`MelSpectrogram` holds it as a buffer on ``device`` (``None`` means
CUDA).  :func:`mfcc` and :func:`griffin_lim` follow their input's device.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
from torch import nn

from simpledsp_tpu_torch.device import resolve_device
from simpledsp_tpu_torch.ops.spectral import istft_ri, stft_ri
from simpledsp_tpu_torch.ops.transforms import dct
from simpledsp_tpu_torch.precision import ieee_fp32

__all__ = ["mel_filterbank", "MelSpectrogram", "mfcc", "griffin_lim"]


def _hz_to_mel(f):
    """HTK mel scale: m = 2595 log10(1 + f/700)."""
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=None)
def mel_filterbank(n_mels: int, nfft: int, fs: float,
                   fmin: float = 0.0,
                   fmax: Optional[float] = None) -> np.ndarray:
    """(n_mels, nfft//2 + 1) triangular mel filterbank, HTK convention
    (host float64).

    Triangle m spans mel-uniform points [m, m+2] of the n_mels + 2 grid
    from fmin to fmax, peaking at 1 at point m + 1.
    """
    if fmax is None:
        fmax = fs / 2.0
    if not (0.0 <= fmin < fmax <= fs / 2.0 + 1e-9):
        raise ValueError(f"need 0 <= fmin < fmax <= fs/2, got "
                         f"({fmin}, {fmax}) @ fs={fs}")
    pts_hz = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax),
                                    n_mels + 2))
    freqs = np.fft.rfftfreq(nfft, 1.0 / fs)
    fb = np.zeros((n_mels, freqs.size))
    for m in range(n_mels):
        lo, mid, hi = pts_hz[m], pts_hz[m + 1], pts_hz[m + 2]
        up = (freqs - lo) / max(mid - lo, 1e-12)
        down = (hi - freqs) / max(hi - mid, 1e-12)
        fb[m] = np.clip(np.minimum(up, down), 0.0, None)
    return fb


class MelSpectrogram(nn.Module):
    """Framed power spectrum -> mel-band energies.

    (..., T) real audio -> (..., nframes, n_mels); ``log=True`` returns
    natural-log energies floored at ``eps``.  The projection is one
    (nbins, n_mels) matmul against the buffer ``fbT``.
    """

    def __init__(self, nfft: int = 512, hop: Optional[int] = None,
                 n_mels: int = 64, fs: float = 16000.0, *,
                 fmin: float = 0.0, fmax: Optional[float] = None,
                 window: str = "hann", log: bool = True,
                 eps: float = 1e-10, dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        self.nfft = nfft
        self.hop = hop or nfft // 2
        self.n_mels = n_mels
        self.fs = fs
        self.window = window
        self.log = log
        self.eps = eps
        self.dtype = dtype
        self.register_buffer("fbT", torch.as_tensor(
            np.ascontiguousarray(mel_filterbank(n_mels, nfft, fs, fmin,
                                                fmax).T),
            dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        sr, si = stft_ri(x, self.nfft, hop=self.hop, window=self.window)
        power = sr * sr + si * si                    # (..., F, nbins)
        with ieee_fp32():
            mel = power @ self.fbT
        if self.log:
            mel = torch.log(mel.clamp_min(self.eps))
        return mel


def mfcc(x: torch.Tensor, n_mfcc: int = 13, *, nfft: int = 512,
         hop: Optional[int] = None, n_mels: int = 64, fs: float = 16000.0,
         fmin: float = 0.0, fmax: Optional[float] = None,
         window: str = "hann", dtype=torch.float32) -> torch.Tensor:
    """Mel-frequency cepstral coefficients: (..., T) -> (..., F, n_mfcc).

    log-mel energies -> orthonormal DCT-II over the mel axis, keeping the
    first n_mfcc coefficients (the HTK-style pipeline), on ``x.device``.
    """
    if n_mfcc > n_mels:
        raise ValueError(f"n_mfcc={n_mfcc} exceeds n_mels={n_mels}")
    mel = MelSpectrogram(nfft, hop, n_mels, fs, fmin=fmin, fmax=fmax,
                         window=window, log=True, dtype=dtype,
                         device=x.device)(x)
    return dct(mel, type=2, norm="ortho")[..., :n_mfcc]


def griffin_lim(mag: torch.Tensor, *, nfft: Optional[int] = None,
                hop: Optional[int] = None, window: str = "hann",
                n_iter: int = 50, momentum: float = 0.99,
                length: Optional[int] = None) -> torch.Tensor:
    """Griffin-Lim phase reconstruction: magnitude spectrogram
    (..., nframes, nfft//2 + 1) -> real signal.

    The fast-GL iteration (momentum extrapolation before the magnitude
    projection; momentum=0 is classic Griffin-Lim 1984): alternate istft
    (least-squares weighted-OLA inverse) and stft, keep the rebuilt
    phase, re-impose the target magnitude.  Entirely in RI planes, the
    phase carried as a unit vector renormalized by rsqrt.  ``length``
    crops the output signal (librosa semantics).
    """
    mag = torch.as_tensor(mag)
    nbins = mag.shape[-1]
    nfft = int(nfft or 2 * (nbins - 1))
    if nfft // 2 + 1 != nbins:
        raise ValueError(f"mag has {nbins} bins, inconsistent with "
                         f"nfft={nfft}")
    hop = int(hop or nfft // 2)
    if n_iter < 0:
        raise ValueError(f"n_iter must be >= 0, got {n_iter}")
    eps = 1e-16
    mom = float(momentum)
    sr, si = mag, torch.zeros_like(mag)
    pr, pi = mag, torch.zeros_like(mag)
    for _ in range(int(n_iter)):
        y = istft_ri(sr, si, nfft, hop=hop, window=window)
        tr, ti = stft_ri(y, nfft, hop=hop, window=window)
        er = tr + mom * (tr - pr)          # fast-GL extrapolation
        ei = ti + mom * (ti - pi)
        inv = torch.rsqrt(er * er + ei * ei + eps)
        sr, si, pr, pi = mag * er * inv, mag * ei * inv, tr, ti
    y = istft_ri(sr, si, nfft, hop=hop, window=window)
    return y if length is None else y[..., :length]


def _mel_bin_of_hz(f: float, n_mels: int, fs: float, fmin: float = 0.0,
                   fmax: Optional[float] = None) -> int:
    """Index of the mel band whose peak is nearest f (test/debug helper)."""
    if fmax is None:
        fmax = fs / 2.0
    pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax),
                                 n_mels + 2))
    return int(np.argmin(np.abs(pts[1:-1] - f)))
