"""Carry parameters from the JAX package to this one, through numpy.

The two packages never import each other; a caller holding JAX objects
passes their fields as numpy arrays, e.g.::

    d = jax_design
    design = design_from_numpy(d.b, d.a, d.gain, d.ftype, d.f0, d.fs, d.q)
    state = state_from_numpy(np.asarray(jax_state.y_hist), device="cuda")

so both packages filter with identical float64 coefficients and start from
an identical state.
"""

from __future__ import annotations

import numpy as np
import torch

from simpledsp_tpu_torch.design.biquad import BiquadCascadeDesign, FilterType
from simpledsp_tpu_torch.ops.iir import IIRState

__all__ = ["design_from_numpy", "state_from_numpy", "state_to_numpy"]


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
