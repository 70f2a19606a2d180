"""Streaming FIR filtering, polyphase resampling and overlap-save blocks.

Port of ``simpledsp_tpu/ops/fir.py``.  One engine,
:class:`PolyphaseResampler`, covers the plain FIR (up = down = 1),
decimation (up = 1), interpolation (down = 1) and rational resampling.
Output m of y = upfirdn(h, x, up, down) is

    y[m] = sum_k h[k up + r_m] x[q_m - k],  q_m = floor(m down / up),
                                            r_m = (m down) mod up,

so each of the ``up`` output phases is a K-tap (K = ceil(L / up)) strided
1-D correlation, run as one ``F.conv1d`` with stride ``down`` in IEEE
float32 (:func:`simpledsp_tpu_torch.precision.ieee_fp32` also pins cuDNN's
TF32 switch).  Streaming: the carried state is the last K - 1 input
samples, and splitting a stream at multiples of ``down`` is exact.

Long taps take :class:`OverlapSaveFIR`: FFT-domain blocks on the port's
four-step FFT (``ops/fft.fft_ri`` / ``ifft_ri``), plain torch as in the
JAX package (the fused overlap-save kernel is ``kernels/ols.py``, reached
from ``ops/conv.py``).  :func:`fir_filter` picks between the two.

The filter objects hold their taps on ``device``; ``device=None`` means CUDA
and raises where there is none (``device="cpu"`` for the CPU).

The one-shot whole-signal functions follow their input's device:
:func:`upfirdn` and :func:`resample_poly` run the polyphase engine,
:func:`resample` one ``rfft_ri`` / ``irfft_ri`` pair, and :func:`decimate`
the Chebyshev-I cascade (``ops/iir.sosfiltfilt`` / ``sosfilt``) or a
windowed-sinc FIR through ``ops/conv.convolve``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from simpledsp_tpu_torch.device import resolve_device
from simpledsp_tpu_torch.ops import fft as _fft
from simpledsp_tpu_torch.precision import ieee_fp32

__all__ = ["FIRState", "fir_init", "PolyphaseResampler", "FIRFilter",
           "PolyphaseDecimator", "PolyphaseInterpolator", "OverlapSaveFIR",
           "fir_filter", "resample", "decimate", "upfirdn", "resample_poly"]


def upfirdn(h, x: torch.Tensor, up: int = 1, down: int = 1) -> torch.Tensor:
    """Upsample -> FIR -> downsample (scipy.signal.upfirdn semantics over
    the last axis, including the full tail-flushed output length
    ceil(((T-1) up + len(h)) / down)): the streaming
    :class:`PolyphaseResampler` fed a zero-extended input, sliced to
    scipy's length."""
    h = np.asarray(h, dtype=np.float64)
    up, down = int(up), int(down)
    if up < 1 or down < 1:
        raise ValueError("up and down must be >= 1")
    t = x.shape[-1]
    out_len = -(-((t - 1) * up + h.size) // down)
    need_in = -(-out_len * down // up)
    pad = max(0, need_in - t)
    pad += (-(t + pad)) % down
    if pad:
        x = F.pad(x, (0, pad))
    y, _ = PolyphaseResampler(h, up=up, down=down, dtype=x.dtype,
                              device=x.device)(x)
    return y[..., :out_len]


def resample(x: torch.Tensor, num: int) -> torch.Tensor:
    """Fourier-method resampling of a real signal over the last axis to
    exactly ``num`` samples (scipy.signal.resample semantics, including
    the even-length Nyquist-bin fold/halve rules): one ``rfft_ri``, a bin
    copy and one ``irfft_ri``, batched over leading axes.  Assumes the
    signal is periodic over the window."""
    if x.is_complex():
        raise ValueError("resample expects a real tensor (the streaming "
                         "PolyphaseResampler handles IQ via RI planes)")
    n = x.shape[-1]
    if num < 1:
        raise ValueError(f"num must be positive, got {num}")
    xr, xi = _fft.rfft_ri(x)
    nb_new = num // 2 + 1
    nb = min(xr.shape[-1], nb_new)
    yr = xr.new_zeros(xr.shape[:-1] + (nb_new,))
    yi = xi.new_zeros(xi.shape[:-1] + (nb_new,))
    yr[..., :nb] = xr[..., :nb]
    yi[..., :nb] = xi[..., :nb]
    if num < n and num % 2 == 0:
        # Downsampling onto an even grid folds the +/- old bins at the new
        # Nyquist: Y[num/2] = 2 Re X[num/2].
        yr[..., num // 2] = 2.0 * xr[..., num // 2]
        yi[..., num // 2] = 0.0
    if num > n and n % 2 == 0:
        # Upsampling splits the old Nyquist bin symmetrically.
        yr[..., n // 2] *= 0.5
        yi[..., n // 2] *= 0.5
    y = _fft.irfft_ri(yr, yi, num)
    return y * (num / n)


class FIRState(NamedTuple):
    """Carried input history (the last ``hist_len`` input samples)."""

    hist: torch.Tensor  # (..., hist_len)


def fir_init(hist_len: int, batch_shape: Tuple[int, ...] = (),
             dtype=torch.float32, device=None) -> FIRState:
    return FIRState(torch.zeros(batch_shape + (hist_len,), dtype=dtype,
                                device=device))


class PolyphaseResampler(nn.Module):
    """Rational-rate FIR resampler y = upfirdn(h, x, up, down), streaming.

    Call with x (..., T), T % down == 0; returns (y (..., T up / down),
    state).  The taps are designed in float64 and held as a buffer in
    ``dtype``.
    """

    def __init__(self, taps: np.ndarray, up: int = 1, down: int = 1,
                 dtype=torch.float32, device=None):
        super().__init__()
        if up < 1 or down < 1:
            raise ValueError("up/down must be >= 1")
        device = resolve_device(device)
        taps = np.asarray(taps, dtype=np.float64)
        if taps.ndim != 1:
            raise ValueError("taps must be 1-D")
        self.up = int(up)
        self.down = int(down)
        self.dtype = dtype
        L = taps.size
        K = -(-L // up)  # taps per phase
        hpad = np.zeros(K * up)
        hpad[:L] = taps
        # phase_taps[r, j] = h[j*up + r]
        self._phase_taps = hpad.reshape(K, up).T.copy()
        self.taps_per_phase = K
        self.hist_len = K - 1
        # Output phase i reads input offset d_i = floor(i down / up) with
        # tap phase r_i = (i down) mod up.
        self._d = [(i * self.down) // self.up for i in range(self.up)]
        self._r = [(i * self.down) % self.up for i in range(self.up)]
        # conv1d is a cross-correlation: each phase's taps reversed.
        self.register_buffer("rhs", torch.as_tensor(
            np.ascontiguousarray(self._phase_taps[:, ::-1]), dtype=dtype,
            device=device).reshape(up, 1, 1, K))

    def _run(self, xp: torch.Tensor) -> torch.Tensor:
        """xp: (..., K-1 + T) history-prefixed input, T % down == 0."""
        K = self.taps_per_phase
        T = xp.shape[-1] - (K - 1)
        G = T // self.down
        up, down = self.up, self.down
        lead = xp.shape[:-1]
        lhs = xp.reshape(-1, 1, xp.shape[-1])
        outs = []
        with ieee_fp32():
            for i in range(up):
                # y_i[m] = sum_j taps[r, j] xp[d + K-1 - j + m down]
                d = self._d[i]
                seg = lhs[..., d: d + (G - 1) * down + K]
                y = F.conv1d(seg, self.rhs[self._r[i]].to(xp.dtype),
                             stride=down)
                outs.append(y.reshape(lead + (G,)))
        if up == 1:
            return outs[0]
        y = torch.stack(outs, -1)  # (..., G, up)
        return y.reshape(y.shape[:-2] + (G * up,))

    def forward(self, x: torch.Tensor, state: Optional[FIRState] = None
                ) -> Tuple[torch.Tensor, FIRState]:
        T = x.shape[-1]
        if T % self.down != 0:
            raise ValueError(
                f"block length {T} must be a multiple of down={self.down}")
        x = x.to(self.dtype)
        if state is None:
            state = fir_init(self.hist_len, tuple(x.shape[:-1]),
                             dtype=self.dtype, device=x.device)
        xp = torch.cat([state.hist.to(x.dtype), x], -1) if self.hist_len \
            else x
        y = self._run(xp)
        new_hist = (xp[..., xp.shape[-1] - self.hist_len:].contiguous()
                    if self.hist_len else state.hist)
        return y, FIRState(new_hist)


class FIRFilter(PolyphaseResampler):
    """Plain streaming causal FIR: y[n] = sum_k h[k] x[n-k]
    (scipy.signal.lfilter(h, 1, x) with explicit state)."""

    def __init__(self, taps, dtype=torch.float32, device=None):
        super().__init__(taps, up=1, down=1, dtype=dtype, device=device)


class PolyphaseDecimator(PolyphaseResampler):
    """Anti-aliased decimate-by-q: filter, then keep every q-th sample,
    at 1/q of the full-rate cost."""

    def __init__(self, taps, q: int, dtype=torch.float32, device=None):
        super().__init__(taps, up=1, down=q, dtype=dtype, device=device)
        self.q = q


class PolyphaseInterpolator(PolyphaseResampler):
    """Interpolate-by-p: zero-stuff, then filter, without forming the
    zero-stuffed signal."""

    def __init__(self, taps, p: int, dtype=torch.float32, device=None):
        super().__init__(taps, up=p, down=1, dtype=dtype, device=device)
        self.p = p


class OverlapSaveFIR(nn.Module):
    """FFT-domain block convolution (overlap-save) for long FIR filters.

    Frames the history-prefixed input into hops of B with window
    Nfft = B + L - 1 rounded up to a power of two, multiplies by the tap
    spectrum (float64 on the host, held in ``dtype``) and keeps the last B
    samples of each inverse transform.  Streaming-exact: identical to one
    call for any split at multiples of B.
    """

    def __init__(self, taps: np.ndarray, block_size: int = 1024,
                 dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        taps = np.asarray(taps, dtype=np.float64)
        L = taps.size
        self.num_taps = L
        self.hist_len = L - 1
        self.block_size = int(block_size)
        n = 1
        while n < self.block_size + L - 1:
            n <<= 1
        self.nfft = n
        self.dtype = dtype
        H = np.fft.fft(taps, self.nfft)
        self.register_buffer("Hr", torch.as_tensor(H.real, dtype=dtype,
                                                   device=device))
        self.register_buffer("Hi", torch.as_tensor(H.imag, dtype=dtype,
                                                   device=device))

    def _run(self, xp: torch.Tensor) -> torch.Tensor:
        """xp: (..., L-1 + T) history-prefixed input, T % B == 0."""
        B, L, N = self.block_size, self.num_taps, self.nfft
        T = xp.shape[-1] - (L - 1)
        S = T // B
        # Gather-free framing: view xp as B-sample blocks; frame f spans
        # blocks [f, f + q), assembled from q shifted block slices.  Samples
        # past W = L - 1 + B leak in from the next hop, so a constant 0/1
        # mask restores the exact zero padding: every frame holds its W
        # samples and zeros whatever the split, which keeps streaming exact.
        W = L - 1 + B
        q = -(-W // B)
        nb = S + q - 1
        tail = nb * B - xp.shape[-1]
        xb = F.pad(xp, (0, tail)) if tail else xp
        xb = xb.reshape(xb.shape[:-1] + (nb, B))
        frames = torch.cat([xb[..., j: j + S, :] for j in range(q)], -1)
        if W < q * B:
            mask = torch.zeros(q * B, dtype=frames.dtype, device=frames.device)
            mask[:W] = 1.0
            frames = frames * mask
        if N > q * B:
            frames = F.pad(frames, (0, N - q * B))
        elif N < q * B:
            frames = frames[..., :N]      # only masked zeros beyond W dropped
        frames = frames.to(self.dtype)
        fr, fi = _fft.fft_ri(frames, torch.zeros_like(frames))
        pr = fr * self.Hr - fi * self.Hi
        pi = fr * self.Hi + fi * self.Hr
        yr, _ = _fft.ifft_ri(pr, pi)
        y = yr[..., L - 1:L - 1 + B].to(xp.dtype)    # the non-aliased samples
        return y.reshape(y.shape[:-2] + (S * B,))

    def forward(self, x: torch.Tensor, state: Optional[FIRState] = None
                ) -> Tuple[torch.Tensor, FIRState]:
        T = x.shape[-1]
        if T % self.block_size != 0:
            raise ValueError(
                f"block length {T} must be a multiple of {self.block_size}")
        x = x.to(self.dtype)
        if state is None:
            state = fir_init(self.hist_len, tuple(x.shape[:-1]),
                             dtype=self.dtype, device=x.device)
        xp = torch.cat([state.hist.to(x.dtype), x], -1)
        y = self._run(xp)
        return y, FIRState(xp[..., xp.shape[-1] - self.hist_len:].contiguous())


def fir_filter(taps, x: torch.Tensor, state: Optional[FIRState] = None, *,
               method: str = "auto", block_size: int = 1024, dtype=None):
    """One-shot streaming FIR.  method: 'direct' (:class:`FIRFilter`), 'fft'
    (:class:`OverlapSaveFIR`) or 'auto' (overlap-save for more than 96 taps
    when the block divides the length).  Returns (y, state)."""
    if method not in ("auto", "direct", "fft"):
        raise ValueError(f"unknown method {method!r} "
                         "(use 'direct', 'fft', or 'auto')")
    dtype = dtype or x.dtype
    L = np.asarray(taps).size
    if method == "fft" or (method == "auto" and L > 96
                           and x.shape[-1] % block_size == 0):
        return OverlapSaveFIR(taps, block_size=block_size, dtype=dtype,
                              device=x.device)(x, state)
    return FIRFilter(taps, dtype=dtype, device=x.device)(x, state)


def decimate(x: torch.Tensor, q: int, *, n: Optional[int] = None,
             ftype: str = "iir", zero_phase: bool = True) -> torch.Tensor:
    """Anti-alias filter then downsample by the integer factor ``q``
    (scipy.signal.decimate semantics).

    ftype='iir': order-``n`` (default 8, even) Chebyshev-I low-pass with
    0.05 dB ripple at 0.8 (fs/2) / q (``design_cheby1_lowpass``), run as
    the biquad cascade: zero-phase (``sosfiltfilt``) or causal
    (``sosfilt``).
    ftype='fir': ``n`` + 1-tap (default 20 q) Hamming-windowed sinc at
    (fs/2) / q through ``convolve``; zero_phase samples at the
    group-delay-compensated centers.

    One-shot whole-signal op; for streaming decimation use
    :class:`PolyphaseDecimator`.
    """
    if q < 1:
        raise ValueError(f"q must be a positive integer, got {q}")
    t = x.shape[-1]
    nout = -(-t // q)
    if ftype == "iir":
        from simpledsp_tpu_torch.design.biquad import design_cheby1_lowpass
        from simpledsp_tpu_torch.ops.iir import sosfilt, sosfiltfilt

        n = 8 if n is None else n
        if n < 2 or n % 2:
            raise ValueError("iir decimate needs an even order n >= 2 "
                             f"(biquad cascade), got {n}")
        design = design_cheby1_lowpass(n // 2, 0.05, 0.8 / q, 2.0)
        if zero_phase:
            y = sosfiltfilt(design, x)
        else:
            y, _ = sosfilt(design, x)
        return y[..., ::q]
    if ftype == "fir":
        from simpledsp_tpu_torch.design.fir import lowpass_taps
        from simpledsp_tpu_torch.ops.conv import convolve

        n = 20 * q if n is None else n
        taps = lowpass_taps(n + 1, 1.0 / q, fs=2.0, window="hamming")
        full = convolve(x, taps.astype(np.float64), "full")
        start = n // 2 if zero_phase else 0
        return full[..., start::q][..., :nout]
    raise ValueError(f"unknown ftype {ftype!r} (use 'iir' or 'fir')")


def _median(x: torch.Tensor) -> torch.Tensor:
    """numpy's median over the last axis, kept: the mean of the two middle
    values for an even length (``torch.median`` returns the lower one)."""
    s = x.sort(dim=-1).values
    n = x.shape[-1]
    if n % 2:
        return s[..., n // 2: n // 2 + 1]
    return 0.5 * (s[..., n // 2 - 1: n // 2] + s[..., n // 2: n // 2 + 1])


_BACKGROUND = {
    "mean": lambda x: x.mean(dim=-1, keepdim=True),
    "median": _median,
    "minimum": lambda x: x.amin(dim=-1, keepdim=True),
    "maximum": lambda x: x.amax(dim=-1, keepdim=True),
}


def resample_poly(x: torch.Tensor, up: int, down: int, *,
                  window="kaiser_5.0", padtype: str = "constant"
                  ) -> torch.Tensor:
    """Polyphase rational-rate resampling (scipy.signal.resample_poly
    semantics): anti-alias taps designed on the host (default:
    20 max(up, down) + 1-tap Kaiser beta = 5.0 windowed sinc at
    1 / max(up, down) of Nyquist), group delay compensated so y[0] aligns
    with x[0], output length ceil(T up / down).

    window: the default marker, a scipy get_window spec (e.g. 'hamming',
    ('kaiser', 8.0)), or an explicit 1-D tap array.  padtype: 'constant'
    (zero extension) or 'mean' / 'median' / 'minimum' / 'maximum'
    (subtract the statistic, filter, add back).
    """
    import math as _math

    g = _math.gcd(int(up), int(down))
    up, down = int(up) // g, int(down) // g
    if up < 1 or down < 1:
        raise ValueError("up and down must be >= 1")
    if up == down == 1:
        return x
    t = x.shape[-1]
    n_out = (t * up) // down + bool((t * up) % down)

    if isinstance(window, (np.ndarray, list, tuple)) and not (
            isinstance(window, tuple) and isinstance(window[0], str)):
        h = np.asarray(window, dtype=np.float64)
        if h.ndim != 1:
            raise ValueError("window taps must be 1-D")
        half_len = (h.size - 1) // 2
    else:
        max_rate = max(up, down)
        half_len = 10 * max_rate
        n = 2 * half_len + 1
        m = np.arange(n, dtype=np.float64) - half_len
        fc = 1.0 / max_rate                      # relative to Nyquist
        h = fc * np.sinc(fc * m)
        if window == "kaiser_5.0":
            w = np.kaiser(n, 5.0)
        else:
            import scipy.signal as _sig
            w = _sig.get_window(window, n, fftbins=False)
        h = h * w
        h = h / h.sum()
    h = h * up

    background = None
    if padtype in _BACKGROUND:
        background = _BACKGROUND[padtype](x)
        x = x - background
    elif padtype != "constant":
        raise ValueError(f"unsupported padtype {padtype!r} (use 'constant',"
                         " 'mean', 'median', 'minimum', or 'maximum')")

    # Center the output grid on the filter's group delay: pre-pad the taps
    # so the first kept output lands exactly on x[0] (scipy's rule).
    n_pre_pad = down - half_len % down
    n_pre_remove = (half_len + n_pre_pad) // down
    hp = np.concatenate([np.zeros(n_pre_pad), h])
    need = n_pre_remove + n_out
    t_dev = down * (-(-need // up))              # covers `need` outputs
    y, _ = PolyphaseResampler(hp, up, down, dtype=x.dtype, device=x.device)(
        F.pad(x, (0, max(0, t_dev - t))))
    y = y[..., n_pre_remove: n_pre_remove + n_out]
    if background is not None:
        y = y + background
    return y
