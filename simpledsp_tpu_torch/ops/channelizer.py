"""Polyphase filter-bank (PFB) analysis channelizer on torch tensors.

Port of ``simpledsp_tpu/ops/channelizer.py``.  Critically sampled: M
baseband channels at rate fs/M, channel c centred at +c fs/M.  At output
sample g (input index g M):

    y_c[g] = sum_r e^{+2 pi i c r / M} v_r[g],
    v_r[g] = sum_j h[jM + r] x[(g-j)M - r]

i.e. M polyphase branch FIRs followed by an UNSCALED INVERSE length-M DFT
across branches (the +i sign).  Streaming with explicit carried history;
blockwise equals whole-signal at multiples of M.

Three entry points, as in the JAX package: :meth:`PFBChannelizer.forward`
(complex, frame-major), :meth:`~PFBChannelizer.process_ri` ((re, im)
planes, frame-major) and :meth:`~PFBChannelizer.process_ri_cm` (planes,
channel-major: the layout the receiver banks' composable path consumes).
The port adds a fourth, :meth:`~PFBChannelizer.process_real`: a real
stream's M/2 channels below the Nyquist channel, as a radio telescope's
F-engine keeps them, through the half-spectrum transform.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from simpledsp_tpu_torch.design.fir import pfb_prototype_taps
from simpledsp_tpu_torch.device import resolve_device
from simpledsp_tpu_torch.kernels.pfb import PFBOperators
from simpledsp_tpu_torch.ops import fft as _fft
from simpledsp_tpu_torch.ops.fir import FIRState, fir_init
from simpledsp_tpu_torch.precision import ieee_fp32
from simpledsp_tpu_torch.utils import tracing

__all__ = ["PFBChannelizer", "ChanStateRI"]


class ChanStateRI(NamedTuple):
    """Carried channelizer input history as (re, im) float planes."""

    hist_r: torch.Tensor  # (..., L-1)
    hist_i: torch.Tensor  # (..., L-1)


class PFBChannelizer(nn.Module):
    """M-channel analysis polyphase filter bank.

    Args:
      num_channels: M (channel spacing fs/M, output rate fs/M each).
      taps: prototype low-pass of length M*K (default: the Kaiser or remez
        design of ``design.fir.pfb_prototype_taps``, cutoff at half the
        channel spacing).
      dtype: compute dtype (float32 on the card, float64 for parity).
      device: where the tables live; None means CUDA (``device="cpu"`` for
        the CPU).

    Call with x: (..., T) real or complex, T % M == 0; returns (y, state)
    with y: (..., T//M, M) complex, channel c centred at c fs/M.
    """

    def __init__(self, num_channels: int, taps: Optional[np.ndarray] = None,
                 taps_per_channel: int = 16, dtype=torch.float32,
                 design: str = "kaiser", device=None):
        super().__init__()
        device = resolve_device(device)
        self.m = int(num_channels)
        if taps is None:
            taps = pfb_prototype_taps(self.m, taps_per_channel,
                                      design=design)
        taps = np.asarray(taps, dtype=np.float64)
        if taps.size % self.m != 0:
            taps = np.pad(taps, (0, self.m - taps.size % self.m))
        self.num_taps = taps.size
        self.taps_per_branch = taps.size // self.m
        self.hist_len = self.num_taps - 1
        self.dtype = dtype
        # branch_taps[r, j] = h[j*M + r]
        self._branch = taps.reshape(self.taps_per_branch, self.m).T.copy()
        # The channel-major path's tables hold M^2 K + 2 M^2 values (4.8 GB
        # at M 8192, K 16), so they are made at its first call
        # (:meth:`_cm_tables`); this empty buffer carries the bank's device
        # and dtype through ``.to()``.
        self.register_buffer("_anchor", torch.empty(0, dtype=dtype,
                                                    device=device))
        self._cm = None

    @property
    def device(self) -> torch.device:
        return self._anchor.device

    def _cm_tables(self):
        """(masked, wc, ws): the masked taps (:attr:`_masked_taps`) and the
        forward DFT's cos and the inverse's +sin, made in the bank's dtype
        on its device at the first call of the channel-major path (again
        after ``.to()`` moves the bank)."""
        key = (self._anchor.device, self._anchor.dtype)
        if self._cm is None or self._cm[0] != key:
            wr64, wi64 = _fft.dft_matrix(self.m)  # W = c + i s, s = -sin
            self._cm = (key, tuple(
                torch.as_tensor(np.ascontiguousarray(a), dtype=self.dtype,
                                device=key[0]).to(key[1])
                for a in (self._masked_taps, wr64, -wi64)))
        return self._cm[1]

    def _branch_filter(self, xp: torch.Tensor) -> torch.Tensor:
        """Polyphase branch FIRs: (..., L-1+T) -> (..., T//M, M).

        Branch r's input x[gM - r] is column M-1-r of frame g+K-1 of xp, so
        u[g] = sum_j taps[:, j] S[g + K-1-j] with S = flip(frames(xp), -1):
        K products of contiguous lagged frame slices.
        """
        M, K, L = self.m, self.taps_per_branch, self.num_taps
        T = xp.shape[-1] - (L - 1)
        G = T // M
        nfr = K + G - 1
        S = torch.flip(xp[..., : nfr * M].reshape(xp.shape[:-1] + (nfr, M)),
                       dims=(-1,))
        taps = torch.as_tensor(self._branch, dtype=S.real.dtype,
                               device=xp.device)
        acc = None
        for j in range(K):
            lag = K - 1 - j
            term = S[..., lag: lag + G, :] * taps[:, j]
            acc = term if acc is None else acc + term
        return acc  # (..., G, M)

    def _run(self, xp: torch.Tensor) -> torch.Tensor:
        """Complex path: IDFT(v) = conj(DFT(conj(v))) across branches, on
        (re, im) planes through :func:`ops.fft.fft_ri`."""
        v = self._branch_filter(xp)
        if v.is_complex():
            vr, vi = v.real.contiguous(), v.imag.contiguous()
        else:
            vr, vi = v, torch.zeros_like(v)
        yr, yi = _fft.fft_ri(vr, -vi)
        return torch.complex(yr, -yi)

    def _run_ri(self, xpr: torch.Tensor, xpi: torch.Tensor):
        """RI path: the branch FIRs (real taps) per plane, then the
        cross-branch inverse DFT on the RI pair."""
        vr = self._branch_filter(xpr)
        vi = self._branch_filter(xpi)
        yr, yi = _fft.fft_ri(vr, -vi)
        return yr, -yi

    # -- channel-major path -------------------------------------------------
    @functools.cached_property
    def _masked_taps(self) -> np.ndarray:
        """(M, 1, L) conv kernels: feature r holds the reversed prototype
        masked to taps k = r (mod M), branch r's contribution as one
        stride-M correlation over the flat signal."""
        M, L = self.m, self.num_taps
        rhs = np.zeros((M, 1, L))
        k = np.arange(L)
        for r in range(M):
            h_r = np.where(k % M == r, self._branch.T.reshape(-1), 0.0)
            rhs[r, 0] = h_r[::-1]  # conv is a cross-correlation
        return rhs

    def _run_ri_cm(self, xpr: torch.Tensor, xpi: torch.Tensor):
        """Channel-major RI path: (..., L-1+T) planes -> (yr, yi) each
        (..., M, T//M).  One stride-M masked convolution per plane (branch
        filter), then one einsum over the branch axis (inverse DFT), both
        in IEEE float32 on the card."""
        M, L = self.m, self.num_taps
        lead = xpr.shape[:-1]
        W = xpr.shape[-1]
        G = (W - (L - 1)) // M
        rhs, wc, ws = (t.to(xpr.dtype) for t in self._cm_tables())

        def dot(w, v):
            return torch.einsum("cm,...mg->...cg", w, v)

        with ieee_fp32():
            vr, vi = (F.conv1d(xp.reshape(-1, 1, W), rhs, stride=M)
                      .reshape(lead + (M, G)) for xp in (xpr, xpi))
            yr = dot(wc, vr) - dot(ws, vi)
            yi = dot(wc, vi) + dot(ws, vr)
        return yr, yi

    def frames_t(self, xp: torch.Tensor,
                 pad_to: Optional[int] = None) -> torch.Tensor:
        """Transposed frames of a history-prefixed plane for the frames-
        layout kernels: (..., W) -> (..., M, nfr) with row m holding
        xp[f*M + m], contiguous.  The trailing W % M samples (the newest
        history, carried in the state) are dropped; pad_to zero-pads to that
        many frames."""
        nfr = xp.shape[-1] // self.m
        f = xp[..., : nfr * self.m].reshape(xp.shape[:-1] + (nfr, self.m))
        ft = f.transpose(-1, -2)
        if pad_to is not None and pad_to > nfr:
            ft = F.pad(ft, (0, pad_to - nfr))
        return ft.contiguous()

    @functools.cached_property
    def kernel_ops(self) -> PFBOperators:
        """Tables for ``kernels/pfb.py`` matching this bank's prototype."""
        return PFBOperators(self._branch, dtype=self.dtype)

    def _prefixed(self, xr, xi, state):
        if xr.shape[-1] % self.m != 0:
            raise ValueError(f"block length {xr.shape[-1]} must be a multiple "
                             f"of M={self.m}")
        if state is None:
            z = torch.zeros(xr.shape[:-1] + (self.hist_len,), dtype=xr.dtype,
                            device=xr.device)
            state = ChanStateRI(z, z)
        xpr = torch.cat([state.hist_r.to(xr.dtype), xr], -1)
        xpi = torch.cat([state.hist_i.to(xi.dtype), xi], -1)
        h = self.hist_len
        new = ChanStateRI(xpr[..., xpr.shape[-1] - h:].contiguous(),
                          xpi[..., xpi.shape[-1] - h:].contiguous())
        return xpr, xpi, new

    def process_ri_cm(self, xr: torch.Tensor, xi: torch.Tensor,
                      state: Optional[ChanStateRI] = None):
        """Streaming channel-major entry: returns ((yr, yi) each
        (..., M, T//M), state)."""
        xpr, xpi, new = self._prefixed(xr, xi, state)
        return self._run_ri_cm(xpr, xpi), new

    def process_ri(self, xr: torch.Tensor, xi: torch.Tensor,
                   state: Optional[ChanStateRI] = None
                   ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], ChanStateRI]:
        """Streaming RI entry: (xr, xi) (..., T) planes, T % M == 0; returns
        ((yr, yi) each (..., T//M, M), state)."""
        xpr, xpi, new = self._prefixed(xr, xi, state)
        return self._run_ri(xpr, xpi), new

    def process_real(self, x: torch.Tensor, state: Optional[FIRState] = None
                     ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], FIRState]:
        """Streaming real-input entry: x (..., T) real, T % M == 0, M even;
        returns ((yr, yi) each (..., T//M, M//2), state).

        Channels 0 .. M/2-1 of :meth:`forward` (of a real stream the others
        mirror them, y_{M-c} = conj(y_c)); the Nyquist channel M/2 is
        dropped, as an F-engine drops it.  The branch FIRs run on the one
        real plane, then the half-spectrum transform :func:`ops.fft.rfft_ri`
        across branches, conjugated for the +i sign; no full complex
        transform.  The state is :meth:`forward`'s (the last L-1 samples),
        so blockwise output equals whole-signal output at multiples of M.
        ``yr`` is a view of the transform's M/2+1 bins.

        Spans ``sdsp.chan.forward`` (the call), ``sdsp.chan.fir`` and
        ``sdsp.chan.fft``; counters ``chan.calls`` and ``chan.prefix_bytes``
        (the values the history concatenation reads and writes, and the new
        history read and copied, counted from the shapes)."""
        with tracing.span("sdsp.chan.forward"):
            t, h = x.shape[-1], self.hist_len
            if t % self.m != 0 or self.m % 2 != 0:
                raise ValueError(f"need an even M and a block length that is "
                                 f"a multiple of it: M={self.m}, T={t}")
            if x.is_complex():
                raise ValueError("process_real takes a real stream; use "
                                 "forward or process_ri for a complex one")
            tracing.count("chan.calls")
            x = x.to(self.dtype)
            if state is None:
                state = fir_init(h, tuple(x.shape[:-1]), dtype=x.dtype,
                                 device=x.device)
            xp = torch.cat([state.hist.to(x.dtype), x], -1)
            new = FIRState(xp[..., xp.shape[-1] - h:].contiguous())
            tracing.count("chan.prefix_bytes", 2 * (
                xp.numel() + new.hist.numel()) * x.element_size())
            with tracing.span("sdsp.chan.fir"):
                v = self._branch_filter(xp)
            with tracing.span("sdsp.chan.fft"):
                vr, vi = _fft.rfft_ri(v)
                half = self.m // 2
                y = (vr[..., :half], torch.neg(vi[..., :half]))
        return y, new

    def forward(self, x: torch.Tensor, state: Optional[FIRState] = None
                ) -> Tuple[torch.Tensor, FIRState]:
        T = x.shape[-1]
        if T % self.m != 0:
            raise ValueError(f"block length {T} must be a multiple of M={self.m}")
        if not x.is_complex():
            x = x.to(self.dtype)
        if state is None:
            state = fir_init(self.hist_len, tuple(x.shape[:-1]),
                             dtype=x.dtype, device=x.device)
        xp = torch.cat([state.hist.to(x.dtype), x], -1)
        y = self._run(xp)
        return y, FIRState(xp[..., xp.shape[-1] - self.hist_len:].contiguous())
