"""FM / AM demodulation and the NCO mixer on torch tensors.

Port of ``simpledsp_tpu/ops/demod.py``: elementwise math batched over
channels, streaming with a one-sample carried state.  The complex forms
take torch complex tensors; the RI forms take (re, im) float planes and are
what the receiver banks run.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

__all__ = ["DemodState", "DemodStateRI", "fm_demod", "fm_demod_ri",
           "am_demod", "am_demod_ri", "nco_mix", "nco_mix_ri"]


class DemodState(NamedTuple):
    """Last complex sample, carried across blocks for the phase difference."""

    prev: torch.Tensor  # (...,) complex


def fm_demod(iq: torch.Tensor, state: Optional[DemodState] = None, *,
             gain: float = 1.0) -> Tuple[torch.Tensor, DemodState]:
    """Quadrature FM discriminator on complex baseband:
    y[n] = gain * angle(iq[n] * conj(iq[n-1])), the instantaneous frequency
    in radians/sample.  A fresh stream's predecessor is 1 + 0j, so
    y[0] = gain * angle(iq[0])."""
    if state is None:
        prev = torch.ones(iq.shape[:-1], dtype=iq.dtype, device=iq.device)
    else:
        prev = state.prev
    shifted = torch.cat([prev[..., None], iq[..., :-1]], -1)
    d = iq * torch.conj(shifted)
    y = torch.atan2(d.imag, d.real) * gain
    return y, DemodState(iq[..., -1])


def am_demod(iq: torch.Tensor, *, remove_dc: bool = False) -> torch.Tensor:
    """Envelope detector on complex baseband: |iq|, optionally with the
    block mean removed."""
    env = torch.abs(iq)
    if remove_dc:
        env = env - env.mean(-1, keepdim=True)
    return env


class DemodStateRI(NamedTuple):
    """Last IQ sample as (re, im) float planes."""

    prev_r: torch.Tensor  # (...,)
    prev_i: torch.Tensor  # (...,)


def fm_demod_ri(ir: torch.Tensor, ii: torch.Tensor,
                state: Optional[DemodStateRI] = None, *,
                gain: float = 1.0) -> Tuple[torch.Tensor, DemodStateRI]:
    """:func:`fm_demod` on (re, im) planes, the complex product written
    out in real arithmetic."""
    if state is None:
        pr = torch.ones(ir.shape[:-1], dtype=ir.dtype, device=ir.device)
        pi = torch.zeros(ii.shape[:-1], dtype=ii.dtype, device=ii.device)
    else:
        pr, pi = state.prev_r, state.prev_i
    sr = torch.cat([pr[..., None], ir[..., :-1]], -1)
    si = torch.cat([pi[..., None], ii[..., :-1]], -1)
    dr = ir * sr + ii * si
    di = ii * sr - ir * si
    y = torch.atan2(di, dr) * gain
    return y, DemodStateRI(ir[..., -1], ii[..., -1])


def am_demod_ri(ir: torch.Tensor, ii: torch.Tensor, *,
                remove_dc: bool = False) -> torch.Tensor:
    """Envelope detector on (re, im) planes: sqrt(ir^2 + ii^2)."""
    env = torch.sqrt(ir * ir + ii * ii)
    if remove_dc:
        env = env - env.mean(-1, keepdim=True)
    return env


def _nco_angles(length: int, freq: float, phase: float,
                sample_offset: int) -> np.ndarray:
    """Oscillator angles with the phase reduced exactly on the host: the
    cycle count is formed in float64 from an int64 sample index and reduced
    mod 1 before the 2 pi scale, so a large ``sample_offset`` loses no
    phase precision."""
    n = np.arange(length, dtype=np.int64) + int(sample_offset)
    cycles = (-(float(freq) * n) - phase / (2.0 * np.pi)) % 1.0
    return 2.0 * np.pi * cycles


def nco_mix_ri(xr: torch.Tensor, xi: torch.Tensor, freq: float, *,
               phase: float = 0.0, sample_offset: int = 0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """NCO downconversion on (re, im) planes: (xr + i xi) e^{-2 pi i f n}."""
    ang = torch.as_tensor(_nco_angles(xr.shape[-1], freq, phase,
                                      sample_offset),
                          dtype=xr.dtype, device=xr.device)
    c, s = torch.cos(ang), torch.sin(ang)
    return xr * c - xi * s, xr * s + xi * c


def nco_mix(x: torch.Tensor, freq: float, *, phase: float = 0.0,
            sample_offset: int = 0) -> torch.Tensor:
    """Numerically controlled oscillator mixer: x e^{-2 pi i f n}, with
    ``freq`` in cycles/sample and ``sample_offset`` the stream position of
    x[0] (phase-exact for any offset)."""
    real_dtype = x.real.dtype if x.is_complex() else x.dtype
    ang = torch.as_tensor(_nco_angles(x.shape[-1], freq, phase,
                                      sample_offset),
                          dtype=real_dtype, device=x.device)
    osc = torch.complex(torch.cos(ang), torch.sin(ang))
    return x * osc
