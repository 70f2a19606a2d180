"""Streaming FIR filtering and polyphase resampling on torch tensors.

Port of the polyphase part of ``simpledsp_tpu/ops/fir.py``: one engine,
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

``upfirdn``, ``resample``, ``OverlapSaveFIR`` (and its overlap-save
kernel), ``fir_filter``, ``decimate`` and ``resample_poly`` are not ported
yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from simpledsp_tpu_torch.precision import ieee_fp32

__all__ = ["FIRState", "fir_init", "PolyphaseResampler", "FIRFilter",
           "PolyphaseDecimator", "PolyphaseInterpolator"]


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
