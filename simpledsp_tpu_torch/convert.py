"""Carry parameters from the JAX package to this one, through numpy.

The two packages never import each other; a caller holding JAX objects
passes their fields as numpy arrays, e.g.::

    d = jax_design
    design = design_from_numpy(d.b, d.a, d.gain, d.ftype, d.f0, d.fs, d.q)
    state = state_from_numpy(np.asarray(jax_state.y_hist), device="cuda")

so both packages filter with identical float64 coefficients and start from
an identical state.  The receiver banks cross the same way::

    bank = FMReceiverBank(16, fs, taps=prototype_from_branch(jbank.chan._branch),
                          dec_taps=np.asarray(jbank._ataps))
    state = sdr_state_from_numpy(*(np.asarray(a) for a in (
        js.chan.hist_r, js.chan.hist_i, js.demod.prev_r, js.demod.prev_i,
        js.audio.hist)), dc=js.dc)

and an FIR history (``FIRFilter`` / ``OverlapSaveFIR``; the taps are numpy
on both sides)::

    state = fir_state_from_numpy(np.asarray(jax_fir_state.hist), device="cuda")

An ``lfilter`` state (scipy's ``zi`` vector, a plain array on both sides),
a constellation's points and a mel spectrogram's table cross the same way
(back, they are ``zf.cpu().numpy()``, ``const.points`` and
``mel.fbT.cpu().numpy()``)::

    zi = zi_from_numpy(np.asarray(jax_zf), state_dim=len(a) - 1,
                       device="cuda")
    const = constellation_from_numpy(jc.name, jc.points)
    mel = mel_from_numpy(jm._fbT, jm.nfft, jm.hop, jm.fs, window=jm.window,
                         log=jm.log, eps=jm.eps, device="cuda")

The transforms, spectral functions and the radar carry no state: ``CZT`` and
``ZoomFFT`` are built from the same arguments on both sides, and nothing
else crosses.
"""

from __future__ import annotations

import numpy as np
import torch

from simpledsp_tpu_torch.design.biquad import BiquadCascadeDesign, FilterType
from simpledsp_tpu_torch.models.audio import MelSpectrogram
from simpledsp_tpu_torch.models.comms import Constellation
from simpledsp_tpu_torch.models.sdr import SDRState
from simpledsp_tpu_torch.ops.channelizer import ChanStateRI
from simpledsp_tpu_torch.ops.demod import DemodStateRI
from simpledsp_tpu_torch.ops.fir import FIRState
from simpledsp_tpu_torch.ops.iir import IIRState

__all__ = ["design_from_numpy", "state_from_numpy", "state_to_numpy",
           "prototype_from_branch", "sdr_state_from_numpy",
           "sdr_state_to_numpy", "fir_state_from_numpy", "fir_state_to_numpy",
           "zi_from_numpy", "constellation_from_numpy", "mel_from_numpy"]


def design_from_numpy(b, a, gain, ftype, f0, fs,
                      q=float("nan")) -> BiquadCascadeDesign:
    """A :class:`BiquadCascadeDesign` from the fields of the JAX package's
    design: b, a (M, 3) float64 rows, the scalar gain, the filter type (its
    enum or int value) and the design parameters."""
    return BiquadCascadeDesign(
        b=np.array(b, dtype=np.float64), a=np.array(a, dtype=np.float64),
        gain=float(gain), ftype=FilterType(int(ftype)), f0=float(f0),
        fs=float(fs), q=float(q))


def state_from_numpy(y_hist, device=None, dtype=torch.float32) -> IIRState:
    """An :class:`IIRState` holding a copy of a (..., M+1, 2) history array."""
    y_hist = np.asarray(y_hist)
    if y_hist.ndim < 2 or y_hist.shape[-1] != 2:
        raise ValueError(f"y_hist must be (..., M+1, 2), got {y_hist.shape}")
    return IIRState(torch.tensor(y_hist, dtype=dtype, device=device))


def state_to_numpy(state: IIRState) -> np.ndarray:
    """The state's (..., M+1, 2) history as a host numpy array."""
    return state.y_hist.detach().cpu().numpy()


def fir_state_from_numpy(hist, device=None, dtype=torch.float32) -> FIRState:
    """A :class:`FIRState` holding a copy of a (..., hist_len) input
    history, e.g. the JAX package's ``FIRState.hist``."""
    return FIRState(torch.tensor(np.asarray(hist), dtype=dtype, device=device))


def fir_state_to_numpy(state: FIRState) -> np.ndarray:
    """The state's (..., hist_len) history as a host numpy array."""
    return state.hist.detach().cpu().numpy()


def prototype_from_branch(branch) -> np.ndarray:
    """The prototype h (length M K) of a channelizer's (M, K) branch taps
    ``branch[r, j] = h[j M + r]``, for ``PFBChannelizer(taps=...)`` and the
    banks' ``taps=``."""
    return np.asarray(branch, dtype=np.float64).T.reshape(-1).copy()


def sdr_state_from_numpy(hist_r, hist_i, prev_r, prev_i, audio_hist, dc=None,
                         device=None, dtype=torch.float32) -> SDRState:
    """An :class:`SDRState` holding copies of a receiver bank's state:
    channelizer history (B, L-1) twice, demod carry (B, M) twice, decimator
    history (B, M, kd-1) and, for an AM bank with remove_dc, the previous
    envelope mean (B, M)."""
    def t(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    return SDRState(ChanStateRI(t(hist_r), t(hist_i)),
                    DemodStateRI(t(prev_r), t(prev_i)), FIRState(t(audio_hist)),
                    None if dc is None else t(dc))


def sdr_state_to_numpy(state: SDRState) -> dict:
    """The state's arrays on the host, under the names
    :func:`sdr_state_from_numpy` takes."""
    def n(a):
        return None if a is None else a.detach().cpu().numpy()

    return dict(hist_r=n(state.chan.hist_r), hist_i=n(state.chan.hist_i),
                prev_r=n(state.demod.prev_r), prev_i=n(state.demod.prev_i),
                audio_hist=n(state.audio.hist), dc=n(state.dc))


def zi_from_numpy(zi, state_dim=None, device=None,
                  dtype=torch.float32) -> torch.Tensor:
    """A copy of an ``lfilter`` state (..., D), e.g. the JAX package's
    ``zf``; ``state_dim`` (D = max(len(b), len(a)) - 1), when given, is
    checked against the last axis."""
    zi = np.asarray(zi)
    if zi.ndim < 1 or (state_dim is not None and zi.shape[-1] != state_dim):
        raise ValueError(f"zi must be (..., {state_dim or 'D'}), got "
                         f"{zi.shape}")
    return torch.tensor(zi, dtype=dtype, device=device)


def constellation_from_numpy(name: str, points) -> Constellation:
    """A :class:`Constellation` holding exactly the (n, 2) RI ``points`` of
    another, n a power of two.  They are already normalized and are not
    scaled again.  A constellation keeps a host float64 table and casts it to
    its input's device and dtype at each call, so this takes neither."""
    points = np.array(points, dtype=np.float64)
    n = points.shape[0] if points.ndim == 2 else 0
    if points.ndim != 2 or points.shape[1] != 2 or n < 2 or n & (n - 1):
        raise ValueError(f"points must be (2**k, 2) RI, got {points.shape}")
    const = object.__new__(Constellation)
    const.name, const.points = name, points
    const.bits_per_symbol = n.bit_length() - 1
    return const


def mel_from_numpy(table, nfft: int, hop=None, fs: float = 16000.0, *,
                   window: str = "hann", log: bool = True,
                   eps: float = 1e-10, device=None,
                   dtype=torch.float32) -> MelSpectrogram:
    """A :class:`MelSpectrogram` whose projection is the (nfft//2 + 1,
    n_mels) ``table`` (the JAX package's ``MelSpectrogram._fbT``), held in
    ``dtype`` on ``device`` (``None`` means CUDA)."""
    table = np.asarray(table, dtype=np.float64)
    if table.ndim != 2 or table.shape[0] != nfft // 2 + 1:
        raise ValueError(f"table must be ({nfft // 2 + 1}, n_mels), got "
                         f"{table.shape}")
    mel = MelSpectrogram(nfft, hop, table.shape[1], fs, window=window,
                         log=log, eps=eps, dtype=dtype, device=device)
    mel.fbT.copy_(torch.as_tensor(table, dtype=dtype))
    return mel

