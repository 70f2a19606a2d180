"""1-D convolution and cross-correlation (numpy/scipy semantics), batched.

Port of ``simpledsp_tpu/ops/conv.py``: ``full`` / ``same`` / ``valid`` over
batched leading axes, real or complex inputs, with the JAX package's routes
and thresholds:

  * ``direct`` (``min(n, m) <= 96`` under ``auto``): one ``F.conv1d`` with
    flipped taps in IEEE float32 (no TF32).
  * overlap-save, for a long real signal with concrete real taps
    (``n >= 4 m`` and ``n + m - 1 >= 8192``): the CUDA overlap-save kernel
    (``kernels/ols.py``) for a float32 signal on the card, the plain
    :class:`~simpledsp_tpu_torch.ops.fir.OverlapSaveFIR` blocks elsewhere,
    as the JAX package does off the TPU.
  * otherwise ``fft``: the zero-padded power-of-2 FFT product on the port's
    four-step engine.

"Concrete taps" are host taps (numpy, a list, a Python scalar) or a torch
tensor, as a non-traced ``jax.Array`` is there.  Complex inputs are carried
as (re, im) planes and recombined at the boundary.

``deconvolve`` is polynomial long division run as the IIR recurrence of
``ops/lfilter``.
"""

from __future__ import annotations

import functools
import statistics
import time
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from simpledsp_tpu_torch.ops.fft import (_as_ri, _pick_real_dtype, fft_ri,
                                         ifft_ri)
from simpledsp_tpu_torch.precision import ieee_fp32

__all__ = ["choose_conv_method", "convolve", "correlate", "correlation_lags",
           "deconvolve", "fftconvolve", "oaconvolve"]


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


@functools.lru_cache(maxsize=64)
def _cached_ols(taps_bytes: bytes, m: int, block: int, dtype: torch.dtype,
                device: torch.device):
    from simpledsp_tpu_torch.ops.fir import OverlapSaveFIR
    taps = np.frombuffer(taps_bytes, dtype=np.float64, count=m)
    return OverlapSaveFIR(taps, block_size=block, dtype=dtype, device=device)


def _conv_ols_full(x: torch.Tensor, h64: np.ndarray,
                   dtype: torch.dtype) -> torch.Tensor:
    """Full linear convolution of a long real signal with real taps by
    overlap-save blocks: zero initial history makes the causal output the
    full convolution.  A float32 signal on the card takes the fused kernel
    (one read of the signal, one write of the valid samples); other signals
    take :class:`OverlapSaveFIR`'s blocks."""
    n = x.shape[-1]
    m = h64.size
    total = n + m - 1
    if dtype == torch.float32 and x.device.type == "cuda" and m - 1 <= 4096:
        from simpledsp_tpu_torch.kernels.ols import (convolve_ols_fused,
                                                     ols_supported)
        # nfft ~ 8 m keeps the discarded overlap under about 13 %.
        nfft = max(4096, _next_pow2(8 * m))
        if ols_supported(nfft):
            return convolve_ols_fused(x.to(dtype), h64, nfft=nfft)
    block = max(4096, _next_pow2(4 * m))
    pad_tail = (m - 1) + (-total % block)
    ols = _cached_ols(h64.tobytes(), m, block, dtype, x.device)
    xp = F.pad(x.to(dtype), (m - 1, pad_tail))
    return ols._run(xp)[..., :total]


def _conv_real_full(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Full linear convolution of real planes: (..., n) * (m,) ->
    (..., n + m - 1), one ``F.conv1d`` (a correlation, so taps flipped)."""
    n = x.shape[-1]
    m = h.shape[-1]
    with ieee_fp32():
        y = F.conv1d(x.reshape(-1, 1, n), h.flip(0).reshape(1, 1, m).to(x.dtype),
                     padding=m - 1)
    return y.reshape(x.shape[:-1] + (n + m - 1,))


def _conv_fft_full(xr, xi, hr, hi) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full linear convolution via the zero-padded power-of-2 FFT."""
    n = xr.shape[-1]
    m = hr.shape[-1]
    L = _next_pow2(n + m - 1)
    fxr, fxi = fft_ri(F.pad(xr, (0, L - n)), F.pad(xi, (0, L - n)))
    fhr, fhi = fft_ri(F.pad(hr, (0, L - m)), F.pad(hi, (0, L - m)))
    yr = fxr * fhr - fxi * fhi
    yi = fxr * fhi + fxi * fhr
    zr, zi = ifft_ri(yr, yi)
    return zr[..., : n + m - 1], zi[..., : n + m - 1]


def _apply_mode(y: torch.Tensor, n: int, m: int, mode: str) -> torch.Tensor:
    if mode == "full":
        return y
    if mode == "same":
        start = (m - 1) // 2
        return y[..., start: start + n]
    if mode == "valid":
        lo, hi = sorted((n, m))
        start = lo - 1
        return y[..., start: start + hi - lo + 1]
    raise ValueError(f"unknown mode {mode!r} (use 'full', 'same', 'valid')")


def _elapsed_ms(fn, device: torch.device, reps: int = 3) -> float:
    """Median of ``reps`` timings of ``fn`` after one warm-up call, in ms:
    CUDA events on a CUDA device, the host clock elsewhere."""
    fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def choose_conv_method(in1, in2, mode: str = "full", measure: bool = False):
    """Which method :func:`convolve`'s ``method='auto'`` picks for these
    operands (scipy.signal.choose_conv_method API): 'fft' when the shorter
    operand is longer than 96, else 'direct'.  With ``measure=True`` both
    methods are timed (median of 3, CUDA events on a CUDA input) and
    (method, {method: ms}) is returned."""
    x1 = torch.as_tensor(in1)
    x2 = torch.as_tensor(in2)
    method = "fft" if min(x1.shape[-1], x2.shape[-1]) > 96 else "direct"
    if not measure:
        return method
    times = {meth: _elapsed_ms(lambda meth=meth: convolve(x1, x2, mode,
                                                          method=meth),
                               x1.device)
             for meth in ("fft", "direct")}
    return ("fft" if times["fft"] < times["direct"] else "direct"), times


def convolve(x: torch.Tensor, h, mode: str = "full", *,
             method: str = "auto", dtype=None) -> torch.Tensor:
    """Linear convolution over the last axis (numpy.convolve semantics for
    1-D inputs; x may carry leading batch axes, h is 1-D).

    The output is complex iff either input is.  ``method``: 'direct' |
    'fft' | 'auto'.  ``dtype`` is the real working dtype (default float64
    for float64/complex128 x, else float32).
    """
    if method not in ("auto", "direct", "fft"):
        raise ValueError(f"unknown method {method!r}")
    if not isinstance(h, torch.Tensor):
        h = np.ascontiguousarray(h)
    if h.ndim != 1:
        raise ValueError(f"h must be 1-D, got shape {tuple(h.shape)}")
    n = x.shape[-1]
    m = h.shape[-1]
    if n == 0 or m == 0:
        raise ValueError("convolve requires non-empty inputs")
    h_complex = h.is_complex() if isinstance(h, torch.Tensor) \
        else np.iscomplexobj(h)
    complex_out = x.is_complex() or h_complex
    rdt = _pick_real_dtype(x, dtype)
    use_fft = method == "fft" or (method == "auto" and min(n, m) > 96)
    if use_fft and not complex_out and n >= 4 * m and n + m - 1 >= 8192:
        # A long real signal: overlap-save blocks beat one giant 2x-padded
        # FFT and skip the power-of-2 over-padding.  The taps stay on the
        # host: the blocks' tables are built from them there.
        h64 = (h.detach().cpu().numpy() if isinstance(h, torch.Tensor)
               else h).astype(np.float64)
        return _apply_mode(_conv_ols_full(x.to(rdt), h64, rdt), n, m, mode)
    # Host taps go to the device only on the routes that read them there
    # (a copy from pageable memory waits for the stream to drain).
    h = torch.as_tensor(h).to(x.device)
    if not complex_out:
        xr, hr = x.to(rdt), h.to(rdt)
        yr = (_conv_fft_full(xr, torch.zeros_like(xr), hr,
                             torch.zeros_like(hr))[0]
              if use_fft else _conv_real_full(xr, hr))
        return _apply_mode(yr, n, m, mode)
    xr, xi = _as_ri(x, rdt)
    hr, hi = _as_ri(h, rdt)
    if use_fft:
        yr, yi = _conv_fft_full(xr, xi, hr, hi)
    else:
        yr = _conv_real_full(xr, hr) - _conv_real_full(xi, hi)
        yi = _conv_real_full(xr, hi) + _conv_real_full(xi, hr)
    return torch.complex(_apply_mode(yr, n, m, mode),
                         _apply_mode(yi, n, m, mode))


def correlate(x: torch.Tensor, h, mode: str = "full", *,
              method: str = "auto", dtype=None) -> torch.Tensor:
    """Cross-correlation over the last axis (scipy.signal.correlate
    semantics: ``z[k] = sum_j x[j + k - (m - 1)] conj(h[j])``), i.e.
    ``convolve(x, conj(h[::-1]))``.  Tensor taps are flipped on their
    device; host taps on the host, so :func:`convolve` still sees host taps."""
    if isinstance(h, torch.Tensor):
        h = torch.conj_physical(h).flip(-1) if h.is_complex() else h.flip(-1)
    else:
        h = np.conj(np.asarray(h))[::-1]
    return convolve(x, h, mode, method=method, dtype=dtype)


def fftconvolve(x: torch.Tensor, h, mode: str = "full", *,
                dtype=None) -> torch.Tensor:
    """scipy.signal.fftconvolve semantics for 1-D taps over the last axis:
    :func:`convolve` on the transform route (the overlap-save kernel for a
    long real float32 signal on the card)."""
    return convolve(x, h, mode, method="fft", dtype=dtype)


def oaconvolve(x: torch.Tensor, h, mode: str = "full", *,
               dtype=None) -> torch.Tensor:
    """scipy.signal.oaconvolve's use case (one long signal against short
    taps) by :func:`convolve`'s overlap-save blocks: the same outputs as
    :func:`fftconvolve`."""
    return convolve(x, h, mode, method="fft", dtype=dtype)


def correlation_lags(in1_len: int, in2_len: int,
                     mode: str = "full") -> np.ndarray:
    """Lag indices of :func:`correlate`'s output
    (scipy.signal.correlation_lags semantics), as a numpy array."""
    if mode == "full":
        return np.arange(-in2_len + 1, in1_len)
    if mode == "same":
        lags = np.arange(-in2_len + 1, in1_len)
        mid = lags.size // 2
        lo = mid - in1_len // 2
        return lags[lo: lo + in1_len]
    if mode == "valid":
        lo, hi = sorted((in1_len, in2_len))
        return np.arange(hi - lo + 1) + min(0, in1_len - in2_len)
    raise ValueError(f"unknown mode {mode!r}")


def deconvolve(signal: torch.Tensor, divisor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Polynomial deconvolution (scipy.signal.deconvolve semantics):
    quotient q and remainder r with ``signal = convolve(divisor, q) + r``.
    Long division is the IIR recurrence
    ``q[k] = (s[k] - sum_{j>=1} div[j] q[k-j]) / div[0]``, i.e.
    ``lfilter([1], divisor, signal[:n])``, batched over leading axes.
    ``divisor`` is a concrete 1-D tap vector."""
    from simpledsp_tpu_torch.ops.lfilter import lfilter

    div = np.asarray(divisor, dtype=np.float64)
    if div.ndim != 1 or div.size == 0 or div[0] == 0.0:
        raise ValueError("divisor must be 1-D with a nonzero leading tap")
    n = signal.shape[-1] - div.size + 1
    if n < 1:
        return signal.new_zeros(signal.shape[:-1] + (0,)), signal
    quot, _ = lfilter(np.ones(1), div, signal[..., :n])
    rem = signal - convolve(quot, div, mode="full")[..., : signal.shape[-1]]
    return quot, rem
