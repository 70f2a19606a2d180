"""2-D convolution / cross-correlation (scipy.signal.convolve2d /
correlate2d semantics), batched over leading axes.

Port of ``simpledsp_tpu/ops/conv2d.py``, with its routes:

* ``direct`` — the kernel as kh kw shifted multiply-adds.  Concrete host
  taps (numpy, a list) on a float32 image on the card, at most 169 of them,
  take the direct CUDA kernel (``kernels/conv2d.py``), bit for bit the
  plain loop; tensor taps take the plain loop, as a ``jax.Array`` does there.
* ``fft`` — the rfft2 product on the port's four-step engine
  (``ops/fft.rfft2_ri`` / ``irfft2_ri``), each axis padded to a multiple of
  128 or a power of two, whichever is smaller.
* ``auto`` — direct up to 256 taps.

Boundary handling ('fill' / 'wrap' / 'symm') is one pad before a VALID
convolution, so every mode and boundary shares the same core.  Complex
inputs are carried as (re, im) planes.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from simpledsp_tpu_torch.kernels.conv2d import (conv2d_fused_supported,
                                                conv2d_valid_fused,
                                                conv2d_valid_reference)
from simpledsp_tpu_torch.ops.fft import (_as_ri, _pick_real_dtype, irfft2_ri,
                                         rfft2_ri)

__all__ = ["convolve2d", "correlate2d"]


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


@functools.lru_cache(maxsize=64)
def _extend_index(n: int, p: int, boundary: str,
                  device: torch.device) -> torch.Tensor:
    """Source indices of an axis of n extended by p on both sides:
    numpy.pad's 'wrap' or 'symmetric' rule, for any p; cached on ``device``
    (a fresh copy from the host would wait for the stream to drain)."""
    i = np.arange(-p, n + p)
    if boundary == "wrap":
        i = i % n
    else:                              # symmetric: period 2n, edge repeated
        i = i % (2 * n)
        i = np.where(i < n, i, 2 * n - 1 - i)
    return torch.as_tensor(i, device=device)


def _pad_boundary(x: torch.Tensor, kh: int, kw: int, boundary: str,
                  fillvalue: float) -> torch.Tensor:
    """Extend the image by (kh-1, kw-1) on every side by the boundary rule,
    so a VALID convolution over the result is the FULL output."""
    if boundary == "fill":
        return F.pad(x, (kw - 1, kw - 1, kh - 1, kh - 1), value=fillvalue)
    if boundary in ("wrap", "symm"):
        h, w = x.shape[-2:]
        rule = "wrap" if boundary == "wrap" else "symmetric"
        rows = _extend_index(h, kh - 1, rule, x.device)
        cols = _extend_index(w, kw - 1, rule, x.device)
        return x.index_select(-2, rows).index_select(-1, cols)
    raise ValueError(f"unknown boundary {boundary!r} "
                     "(use 'fill', 'wrap', or 'symm')")


def _crop_mode(y: torch.Tensor, hw: Tuple[int, int], kh: int, kw: int,
               mode: str) -> torch.Tensor:
    """Slice the FULL result down to the requested mode."""
    h, w = hw
    if mode == "full":
        return y
    if mode == "same":
        r0, c0 = (kh - 1) // 2, (kw - 1) // 2
        return y[..., r0: r0 + h, c0: c0 + w]
    if mode == "valid":
        if h < kh or w < kw:
            raise ValueError("valid mode needs an image at least as large "
                             f"as the kernel, got {tuple(hw)} vs ({kh}, {kw})")
        return y[..., kh - 1: h, kw - 1: w]
    raise ValueError(f"unknown mode {mode!r} (use 'full', 'same', 'valid')")


def _fft_size_2d(n: int) -> int:
    """Smallest efficient FFT length >= n: a multiple of 128 (n = k 128,
    k <= 128, splits into two dense steps of the four-step engine) or the
    next power of two, whichever is smaller."""
    if n <= 128:
        return _next_pow2(n)
    return min(-(-n // 128) * 128, _next_pow2(n))


def _conv2d_fft_real(xp: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """VALID convolution of the pre-padded image with the (unflipped)
    kernel: the tight-padded rfft2 product."""
    hp, wp = xp.shape[-2:]
    kh, kw = k.shape
    oh, ow = hp - kh + 1, wp - kw + 1
    fh, fw = _fft_size_2d(hp), _fft_size_2d(wp)
    xr, xi = rfft2_ri(F.pad(xp, (0, fw - wp, 0, fh - hp)))
    kr, ki = rfft2_ri(F.pad(k.to(xp.dtype), (0, fw - kw, 0, fh - kh)))
    yr = xr * kr - xi * ki
    yi = xr * ki + xi * kr
    y = irfft2_ri(yr, yi, fw)
    # Linear-convolution indices [kh-1, hp) of the circular result.
    return y[..., kh - 1: kh - 1 + oh, kw - 1: kw - 1 + ow]


def convolve2d(x: torch.Tensor, h, mode: str = "full", *,
               boundary: str = "fill", fillvalue: float = 0.0,
               method: str = "auto", dtype=None) -> torch.Tensor:
    """2-D convolution over the last two axes (scipy.signal.convolve2d
    semantics for mode / boundary / fillvalue, with batched leading axes).
    method: 'direct', 'fft' or 'auto' (direct up to 256 taps)."""
    if method not in ("auto", "direct", "fft"):
        raise ValueError(f"unknown method {method!r}")
    host = not isinstance(h, torch.Tensor)
    if host:
        h = np.ascontiguousarray(h)
    if h.ndim != 2:
        raise ValueError(f"kernel must be 2-D, got shape {tuple(h.shape)}")
    if x.ndim < 2:
        raise ValueError(f"image must have >= 2 dims, got shape "
                         f"{tuple(x.shape)}")
    kh, kw = h.shape
    hw = x.shape[-2:]
    cplx = x.is_complex() or (np.iscomplexobj(h) if host else h.is_complex())
    rdt = _pick_real_dtype(x, dtype) if cplx else (dtype or x.dtype)
    use_fft = method == "fft" or (method == "auto" and kh * kw > 256)
    # Concrete host taps on a float32 image on the card take the fused
    # kernel, which reads the taps from the host; only the other routes
    # move them to the device.
    fused = (host and not use_fft and rdt == torch.float32
             and x.device.type == "cuda" and conv2d_fused_supported(kh, kw))
    if fused:
        planes = [np.ascontiguousarray(part(h)[::-1, ::-1], dtype=np.float64)
                  for part in (np.real, np.imag)]
    else:
        hd = torch.as_tensor(h).to(x.device)
        planes = list(_as_ri(hd, rdt)) if cplx else [hd.to(rdt)]

    def conv_real(img, part):
        imgp = _pad_boundary(img, kh, kw, boundary, fillvalue)
        if fused:
            return conv2d_valid_fused(imgp, planes[part])
        if use_fft:
            return _conv2d_fft_real(imgp, planes[part])
        return conv2d_valid_reference(imgp, planes[part].flip(-2, -1))

    if not cplx:
        return _crop_mode(conv_real(x.to(rdt), 0), hw, kh, kw, mode)
    xr, xi = _as_ri(x, rdt)
    yr = conv_real(xr, 0) - conv_real(xi, 1)
    yi = conv_real(xr, 1) + conv_real(xi, 0)
    return _crop_mode(torch.complex(yr, yi), hw, kh, kw, mode)


def correlate2d(x: torch.Tensor, h, mode: str = "full", *,
                boundary: str = "fill", fillvalue: float = 0.0,
                method: str = "auto", dtype=None) -> torch.Tensor:
    """2-D cross-correlation (scipy.signal.correlate2d semantics):
    convolution with the conjugated, 180-degree-rotated kernel on the same
    full-output grid.  Tensor kernels are rotated on their device, host
    kernels on the host (so :func:`convolve2d` still sees host taps)."""
    if isinstance(h, torch.Tensor):
        if h.ndim != 2:
            raise ValueError(f"kernel must be 2-D, got shape {tuple(h.shape)}")
        hf = h.flip(-2, -1)
        hf = torch.conj_physical(hf) if hf.is_complex() else hf
    else:
        hnp = np.asarray(h)
        if hnp.ndim != 2:
            raise ValueError(f"kernel must be 2-D, got shape {hnp.shape}")
        hf = np.conj(hnp[::-1, ::-1])
    if mode == "same":
        # Correlation centres 'same' at kh // 2 (convolution at (kh-1) // 2):
        # they differ for even kernel dims only.
        kh, kw = hf.shape
        hc, wc = x.shape[-2:]
        full = convolve2d(x, hf, "full", boundary=boundary,
                          fillvalue=fillvalue, method=method, dtype=dtype)
        return full[..., kh // 2: kh // 2 + hc, kw // 2: kw // 2 + wc]
    return convolve2d(x, hf, mode, boundary=boundary, fillvalue=fillvalue,
                      method=method, dtype=dtype)
