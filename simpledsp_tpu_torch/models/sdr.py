"""SDR receiver banks: PFB channelizer -> FM / AM demod -> audio decimator.

Port of ``simpledsp_tpu/models/sdr.py`` (:class:`FMReceiverBank`,
:class:`AMReceiverBank`).  Complex baseband travels as (re, im) planes;
every stage streams with an explicit carried state (:class:`SDRState`).

Two paths compute the same audio:

- the fused path (``use_kernel=True``, the default on a CUDA device): one
  flat-layout PFB kernel (``kernels/pfb.py``, built from ``csrc/pfb.cu``)
  reads the carried history and the call's planes where they lie, with no
  prefixed copy of the stream, and channelizes, demodulates and decimates
  in one pass;
- the composable path (``use_kernel=False``): ``PFBChannelizer.process_ri_cm``,
  then ``fm_demod_ri`` / ``am_demod_ri``, then ``PolyphaseDecimator``.

There is no silent fallback: a CUDA bank whose (M, K) the kernel does not
take raises at construction, a bank asked for CUDA where there is none
raises, and a call whose length is not a multiple of M * decim raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from simpledsp_tpu_torch.design.fir import lowpass_taps
from simpledsp_tpu_torch.device import resolve_device, resolve_use_kernel
from simpledsp_tpu_torch.kernels import pfb as _pfb
from simpledsp_tpu_torch.ops.channelizer import ChanStateRI, PFBChannelizer
from simpledsp_tpu_torch.ops.demod import DemodStateRI, am_demod_ri, fm_demod_ri
from simpledsp_tpu_torch.ops.fir import FIRState, PolyphaseDecimator, fir_init
from simpledsp_tpu_torch.utils import tracing

__all__ = ["SDRState", "FMReceiverBank", "AMReceiverBank"]


class SDRState(NamedTuple):
    """Carried state of the whole receiver."""

    chan: ChanStateRI    # channelizer input history (RI planes)
    demod: DemodStateRI  # per-channel last IQ sample (RI planes)
    audio: FIRState      # per-channel decimator history (real)
    # AM remove_dc only: the previous call's per-channel envelope mean
    # (B, M).  Block-mean removal is linear, so the fused path decimates the
    # RAW envelope and corrects exactly:
    # audio = audio_raw - mu (S - Sc[n]) - mu_prev Sc[n], Sc[n] the tap mass
    # falling on the carried history for output n.  Its FIR history is
    # therefore in the raw domain, unlike the composable path's; the audio
    # is the same.
    dc: Optional[torch.Tensor] = None


class FMReceiverBank(nn.Module):
    """Channelize a wideband stream into M carriers and FM-demodulate all
    of them at once.

    Args:
      num_channels: M channels, spacing fs/M.
      fs: input sample rate.
      decim: audio decimation after the demodulator (output rate
        fs / M / decim).
      deviation_hz: sets the discriminator gain (fs/M) / (2 pi deviation).
      taps_per_channel, audio_taps, design: the prototype and audio filter
        designs ("kaiser" or "remez"), as in the JAX package.
      taps, dec_taps: given prototype (length M K) and audio decimator
        taps instead of the designs.
      dtype, device: compute dtype and device (the kernel takes float32);
        ``device=None`` means CUDA and raises where there is none.
      use_kernel: the fused CUDA kernel path; None means "on a CUDA device".
      use_pallas: the JAX package's name for ``use_kernel``, an alias.

    Call with x: (B, T) complex, or a pair (xr, xi) of float planes, or
    real samples, T % (M decim) == 0; returns (audio (B, M, T/M/decim),
    state).
    """

    def __init__(self, num_channels: int, fs: float, decim: int = 4,
                 deviation_hz: float = 75e3, taps_per_channel: int = 16,
                 audio_taps: int = 64, dtype=torch.float32, device=None,
                 use_kernel: Optional[bool] = None, design: str = "kaiser",
                 taps: Optional[np.ndarray] = None,
                 dec_taps: Optional[np.ndarray] = None,
                 use_pallas: Optional[bool] = None):
        super().__init__()
        device = resolve_device(device)
        self.m = int(num_channels)
        self.fs = float(fs)
        self.decim = int(decim)
        self.dtype = dtype
        chan_rate = fs / num_channels
        self.fm_gain = float(chan_rate / (2.0 * np.pi * deviation_hz))
        self.design = design
        self.chan = PFBChannelizer(num_channels, taps=taps,
                                   taps_per_channel=taps_per_channel,
                                   dtype=dtype, design=design, device=device)
        if dec_taps is not None:
            ataps = np.asarray(dec_taps, dtype=np.float64)
        elif design == "remez":
            from simpledsp_tpu_torch.design.optimal_fir import remez
            ataps = remez(audio_taps, [0.0, 0.35 / decim, 0.5 / decim, 0.5],
                          [1.0, 0.0], weight=[1.0, 10.0])
            ataps = ataps / ataps.sum()
        else:
            ataps = lowpass_taps(audio_taps, 0.4 / decim, fs=1.0)
        self._ataps = ataps
        self.audio = PolyphaseDecimator(ataps, decim, dtype=dtype,
                                        device=device)
        self.use_kernel = resolve_use_kernel(use_kernel, use_pallas, device)
        if self.use_kernel:
            m, k = self.m, self.chan.taps_per_branch
            if not _pfb.kernel_supports(m, k):
                raise ValueError(f"the PFB kernel takes M | 128 and K <= 32 "
                                 f"taps per channel; got M={m}, K={k}")
            if device.type == "cuda" and dtype != torch.float32:
                raise ValueError(f"the CUDA PFB kernel takes float32, got "
                                 f"{dtype}")
            self.register_buffer("dec_taps", torch.as_tensor(
                ataps, dtype=dtype, device=device))

    @property
    def device(self) -> torch.device:
        return self.chan.device

    def init_state(self, batch: int) -> SDRState:
        kw = dict(dtype=self.dtype, device=self.device)
        z = torch.zeros((batch, self.chan.hist_len), **kw)
        return SDRState(
            chan=ChanStateRI(z, z.clone()),
            demod=DemodStateRI(torch.ones((batch, self.m), **kw),
                               torch.zeros((batch, self.m), **kw)),
            audio=fir_init(self.audio.hist_len, (batch, self.m), **kw))

    # -- fused path --------------------------------------------------------
    def _next_history(self, xr, xi, state: SDRState) -> ChanStateRI:
        """The new channelizer state, the last L-1 samples of [hist | x]: a
        copy of x's tail, or for T < L-1 of the history's tail and x.
        Counts the bytes its copies move in ``bank.prefix_bytes``."""
        with tracing.span("sdsp.bank.prefix"):
            h, t = self.chan.hist_len, xr.shape[-1]
            old = state.chan
            if t >= h:
                new = ChanStateRI(xr[:, t - h:].clone(), xi[:, t - h:].clone())
            else:
                new = ChanStateRI(torch.cat([old.hist_r[:, t:], xr], -1),
                                  torch.cat([old.hist_i[:, t:], xi], -1))
            # Each plane's new history read and written.
            tracing.count("bank.prefix_bytes",
                          4 * xr.shape[0] * h * xr.element_size())
        return new

    def _fused_call(self, hist, xr, xi, chan_state, state: SDRState, g: int):
        """The fused kernel on x after the (B, L-1) history planes ``hist``,
        or on history-prefixed planes where ``hist`` is None (FM
        version)."""
        audio, (ylr, yli), ahist = _pfb.pfb_fm_flat(
            self.chan.kernel_ops, xr, xi, state.demod.prev_r[..., None],
            state.demod.prev_i[..., None], gain=self.fm_gain, g=g,
            dec_taps=self.dec_taps, decim=self.decim,
            ahist=state.audio.hist, hist=hist)
        demod = DemodStateRI(ylr[..., 0], yli[..., 0])
        return audio, SDRState(chan_state, demod, FIRState(ahist))

    # -- composable path ---------------------------------------------------
    def _composable_call(self, xr, xi, state: SDRState):
        """Channelizer -> discriminator -> decimator (FM version)."""
        (ir, ii), chan_state = self.chan.process_ri_cm(xr, xi, state.chan)
        disc, demod = fm_demod_ri(ir, ii, state.demod, gain=self.fm_gain)
        audio, audio_state = self.audio(disc, state.audio)
        return audio, SDRState(chan_state, demod, audio_state)

    def _forward(self, xr, xi, state: SDRState):
        if not self.use_kernel:
            return self._composable_call(xr, xi, state)
        g = xr.shape[-1] // self.m
        # The kernel reads rows of unit sample stride; a complex input's
        # planes are strided views.
        xr, xi = xr.contiguous(), xi.contiguous()
        chan_state = self._next_history(xr, xi, state)
        tracing.count("bank.direct_calls")
        return self._fused_call((state.chan.hist_r, state.chan.hist_i), xr, xi,
                                chan_state, state, g)

    # -- padded streaming entry ---------------------------------------------
    def _padded_g(self, w: int) -> int:
        """Output frame count for a pre-padded (B, W) buffer: the inverse of
        ``kernels.pfb.flat_pad_to``."""
        halo = _pfb.flat_pad_to(self.chan.kernel_ops, 0)
        g = (w - halo) // self.m
        if g <= 0 or self.m * g + halo != w or g % self.decim:
            raise ValueError(
                f"padded width {w} is not flat_pad_to(ops, g) for a g that "
                f"is a positive multiple of decim={self.decim} (M={self.m}, "
                f"halo={halo})")
        return g

    def padded_spec(self, t: int) -> Tuple[int, int]:
        """(front, total) buffer layout for :meth:`process_padded`: a
        producer of T samples per stream writes x at offset ``front`` of a
        (B, total) buffer; the tail is never read and needs no zeroing."""
        if not self.use_kernel or t % (self.m * self.decim) or t <= 0:
            raise ValueError(
                f"T={t} is not eligible for the fused kernel (need "
                f"use_kernel and T a positive multiple of M*decim = "
                f"{self.m * self.decim})")
        return self.chan.hist_len, _pfb.flat_pad_to(self.chan.kernel_ops,
                                                    t // self.m)

    def process_padded(self, x: Tuple[torch.Tensor, torch.Tensor],
                       state: Optional[SDRState] = None):
        """Streaming entry for producers that write each block into a
        history-prefixed buffer: x = (xpr_buf, xpi_buf) laid out per
        :meth:`padded_spec`.  The carried history is written into the
        buffers' front slots in place (the torch form of the JAX package's
        buffer donation), and the kernel reads the buffers as they are.
        Returns (audio, state, (xpr_buf, xpi_buf))."""
        if not self.use_kernel:
            raise ValueError("process_padded runs the fused kernel path "
                             "(use_kernel=True)")
        xpr, xpi = x
        g = self._padded_g(xpr.shape[-1])
        if state is None:
            state = self.init_state(xpr.shape[0])
        h = self.chan.hist_len
        xpr[:, :h] = state.chan.hist_r
        xpi[:, :h] = state.chan.hist_i
        end = h + self.m * g
        chan_state = ChanStateRI(xpr[:, end - h:end].clone(),
                                 xpi[:, end - h:end].clone())
        audio, st = self._fused_call(None, xpr, xpi, chan_state, state, g)
        return audio, st, (xpr, xpi)

    def forward(self, x, state: Optional[SDRState] = None
                ) -> Tuple[torch.Tensor, SDRState]:
        with tracing.span("sdsp.bank.forward"):
            tracing.count("bank.calls")
            kw = dict(dtype=self.dtype, device=self.device)
            if isinstance(x, (tuple, list)):
                xr, xi = (torch.as_tensor(v, **kw) for v in x)
            elif isinstance(x, np.ndarray) and np.iscomplexobj(x):
                xr = torch.as_tensor(x.real, **kw)
                xi = torch.as_tensor(x.imag, **kw)
            elif torch.is_tensor(x) and x.is_complex():
                xr, xi = x.real.to(**kw), x.imag.to(**kw)
            else:
                xr = torch.as_tensor(x, **kw)
                xi = torch.zeros_like(xr)
            b, t = xr.shape
            if t % (self.m * self.decim) != 0:
                raise ValueError(
                    f"T={t} must be a multiple of M*decim="
                    f"{self.m * self.decim}")
            if state is None:
                state = self.init_state(b)
            return self._forward(xr, xi, state)


class AMReceiverBank(FMReceiverBank):
    """Channelize and AM-envelope-detect all M carriers at once.

    Same pipeline as :class:`FMReceiverBank` with the discriminator swapped
    for an envelope detector; with ``remove_dc`` each call's per-channel
    mean envelope (the carrier level) is removed before the decimator.
    """

    def __init__(self, num_channels: int, fs: float, decim: int = 4,
                 remove_dc: bool = True, taps_per_channel: int = 16,
                 audio_taps: int = 64, dtype=torch.float32, device=None,
                 use_kernel: Optional[bool] = None, design: str = "kaiser",
                 taps: Optional[np.ndarray] = None,
                 dec_taps: Optional[np.ndarray] = None,
                 use_pallas: Optional[bool] = None):
        super().__init__(num_channels, fs, decim=decim,
                         taps_per_channel=taps_per_channel,
                         audio_taps=audio_taps, dtype=dtype, device=device,
                         use_kernel=use_kernel, design=design, taps=taps,
                         dec_taps=dec_taps, use_pallas=use_pallas)
        self.remove_dc = remove_dc
        self._sc = {}

    def init_state(self, batch: int) -> SDRState:
        st = super().init_state(batch)
        if not self.remove_dc:
            return st
        # The previous call's envelope mean: zero matches the composable
        # path's zero FIR history.
        return st._replace(dc=torch.zeros((batch, self.m), dtype=self.dtype,
                                          device=self.device))

    def _carry_tap_sums(self, gd: int) -> torch.Tensor:
        """Sc[n] = tap mass falling on the carried FIR history for output n
        (nonzero only for the first ceil((kd-1)/decim) outputs), cached per
        call length."""
        if gd not in self._sc:
            h = np.asarray(self._ataps, np.float64)
            sc = np.zeros(gd)
            j = np.arange(h.size)
            for n in range(min(gd, -(-(h.size - 1) // self.decim))):
                sc[n] = h[j > n * self.decim].sum()
            self._sc[gd] = torch.as_tensor(sc, dtype=self.dtype,
                                           device=self.device)
        return self._sc[gd]

    def _fused_call(self, hist, xr, xi, chan_state, state: SDRState, g: int):
        """The fused kernel, its input as in :meth:`FMReceiverBank._fused_call`
        (AM version)."""
        ops = self.chan.kernel_ops
        kw = dict(g=g, dec_taps=self.dec_taps, decim=self.decim,
                  ahist=state.audio.hist, hist=hist)
        if not self.remove_dc:
            audio, ahist = _pfb.pfb_am_flat(ops, xr, xi, **kw)
            return audio, SDRState(chan_state, state.demod, FIRState(ahist))
        # Decimate the raw envelope in the kernel, then remove the block
        # mean exactly with this call's mean and the carried previous one.
        audio_raw, ahist, esum = _pfb.pfb_am_flat(ops, xr, xi, emit_sum=True,
                                                  **kw)
        mu = esum / g
        s_all = float(np.sum(np.asarray(self._ataps, np.float64)))
        sc = self._carry_tap_sums(g // self.decim)
        audio = (audio_raw - mu[..., None] * (s_all - sc)
                 - state.dc[..., None] * sc)
        return audio, SDRState(chan_state, state.demod, FIRState(ahist), mu)

    def _composable_call(self, xr, xi, state: SDRState):
        """Channelizer -> envelope -> decimator (AM version)."""
        (ir, ii), chan_state = self.chan.process_ri_cm(xr, xi, state.chan)
        env = am_demod_ri(ir, ii, remove_dc=self.remove_dc)
        audio, audio_state = self.audio(env, state.audio)
        return audio, SDRState(chan_state, state.demod, audio_state,
                               state.dc)
