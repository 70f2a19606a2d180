"""Test-signal and waveform generators (scipy.signal parity) on torch
tensors.

Port of ``simpledsp_tpu/ops/waveforms.py``: ``chirp``, ``square``,
``sawtooth``, ``gausspulse`` and ``sweep_poly`` are elementwise math on
the time base they are given, on its device and in its dtype; the phase
constants are host float64.  ``unit_impulse`` and ``max_len_seq`` make a
tensor from no tensor input, so they take ``device=`` (None means CUDA,
and raises where there is none).  The maximum-length sequence's LFSR runs
on the host in the native library (``native/sdsp_io.cpp``, built by
``runtime/stream.load_library``); a failed build raises.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import numpy as np
import torch

from simpledsp_tpu_torch.device import resolve_device

__all__ = ["chirp", "square", "sawtooth", "gausspulse", "unit_impulse",
           "sweep_poly", "max_len_seq"]


def chirp(t, f0: float, t1: float, f1: float, *, method: str = "linear",
          phi: float = 0.0) -> torch.Tensor:
    """Swept-frequency cosine (scipy.signal.chirp semantics): instantaneous
    frequency f0 at t=0 sweeping to f1 at t=t1 along a 'linear',
    'quadratic', 'logarithmic', or 'hyperbolic' law.  phi in degrees."""
    t = torch.as_tensor(t)
    f0 = float(f0)
    f1 = float(f1)
    t1 = float(t1)
    if method == "linear":
        beta = (f1 - f0) / t1
        phase = 2.0 * math.pi * (f0 * t + 0.5 * beta * t * t)
    elif method == "quadratic":
        beta = (f1 - f0) / (t1 * t1)
        phase = 2.0 * math.pi * (f0 * t + beta * t * t * t / 3.0)
    elif method in ("logarithmic", "log", "lo"):
        if f0 * f1 <= 0.0:
            raise ValueError("logarithmic chirp needs f0, f1 nonzero with "
                             "the same sign")
        if f0 == f1:
            phase = 2.0 * math.pi * f0 * t
        else:
            beta = t1 / math.log(f1 / f0)
            phase = 2.0 * math.pi * beta * f0 * (
                torch.pow(f1 / f0, t / t1) - 1.0)
    elif method in ("hyperbolic", "hyp"):
        if f0 == 0.0 or f1 == 0.0:
            raise ValueError("hyperbolic chirp needs nonzero f0, f1")
        if f0 == f1:
            phase = 2.0 * math.pi * f0 * t
        else:
            sing = -f1 * t1 / (f0 - f1)
            phase = 2.0 * math.pi * (-sing * f0) * torch.log(
                torch.abs(1.0 - t / sing))
    else:
        raise ValueError(f"unknown chirp method {method!r}")
    return torch.cos(phase + math.pi * phi / 180.0)


def square(t, duty: Union[float, torch.Tensor] = 0.5) -> torch.Tensor:
    """Square wave of period 2*pi: +1 for the first ``duty`` fraction of
    each period, -1 for the rest (scipy.signal.square)."""
    t = torch.as_tensor(t)
    frac = torch.remainder(t, 2.0 * math.pi) / (2.0 * math.pi)
    dtype = t.dtype if t.is_floating_point() else torch.float32
    one = torch.ones((), dtype=dtype, device=t.device)
    return torch.where(frac < duty, one, -one)


def sawtooth(t, width: float = 1.0) -> torch.Tensor:
    """Sawtooth/triangle wave of period 2*pi rising from -1 to 1 over the
    first ``width`` fraction of the period and falling back over the rest
    (scipy.signal.sawtooth; width=0.5 gives a symmetric triangle)."""
    if not 0.0 <= width <= 1.0:
        raise ValueError(f"width must be in [0, 1], got {width}")
    t = torch.as_tensor(t)
    frac = torch.remainder(t, 2.0 * math.pi) / (2.0 * math.pi)
    if width == 0.0:
        return 1.0 - 2.0 * frac
    if width == 1.0:
        return 2.0 * frac - 1.0
    rising = 2.0 * frac / width - 1.0
    falling = 1.0 - 2.0 * (frac - width) / (1.0 - width)
    return torch.where(frac < width, rising, falling)


def gausspulse(t, fc: float = 1000.0, bw: float = 0.5, bwr: float = -6.0,
               *, quadrature: bool = False
               ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Gaussian-modulated sinusoid (scipy.signal.gausspulse): carrier fc,
    fractional bandwidth ``bw`` measured at ``bwr`` dB.  Returns the real
    (in-phase) pulse, or (i, q) planes with ``quadrature=True``."""
    if fc <= 0.0:
        raise ValueError(f"fc must be positive, got {fc}")
    if bw <= 0.0:
        raise ValueError(f"bw must be positive, got {bw}")
    if bwr >= 0.0:
        raise ValueError(f"bwr must be negative dB, got {bwr}")
    t = torch.as_tensor(t)
    ref = 10.0 ** (bwr / 20.0)
    a = -((math.pi * fc * bw) ** 2) / (4.0 * math.log(ref))
    env = torch.exp(-a * t * t)
    yi = env * torch.cos(2.0 * math.pi * fc * t)
    if not quadrature:
        return yi
    return yi, env * torch.sin(2.0 * math.pi * fc * t)


def sweep_poly(t, poly, phi: float = 0.0) -> torch.Tensor:
    """Frequency-swept cosine whose instantaneous frequency follows the
    polynomial ``poly`` (highest degree first, numpy.poly1d convention —
    scipy.signal.sweep_poly semantics).  The phase polynomial (the
    frequency's antiderivative) is integrated host-side in float64 and
    evaluated on the time base's device by Horner's rule.  phi in
    degrees."""
    t = torch.as_tensor(t)
    coeffs = np.asarray(np.atleast_1d(np.poly1d(poly).coeffs), np.float64)
    intc = np.polyint(coeffs)           # degree+1 coeffs, zero constant
    phase = torch.zeros_like(t)
    for c in intc:
        phase = phase * t + float(c)
    return torch.cos(2.0 * math.pi * phase + math.pi * phi / 180.0)


# Primitive LFSR feedback taps per register length (Zierler/Peterson
# tables — the same defaults scipy.signal.max_len_seq ships).
_MLS_TAPS = {2: [1], 3: [2], 4: [3], 5: [3], 6: [5], 7: [6],
             8: [7, 6, 1], 9: [5], 10: [7], 11: [9], 12: [11, 10, 4],
             13: [12, 11, 8], 14: [13, 12, 2], 15: [14], 16: [15, 13, 4],
             17: [14], 18: [11], 19: [18, 17, 14], 20: [17], 21: [19],
             22: [21], 23: [18], 24: [23, 22, 17], 25: [22], 26: [25, 24, 20],
             27: [26, 25, 22], 28: [25], 29: [27], 30: [29, 28, 7],
             31: [28], 32: [31, 30, 10]}


def max_len_seq(nbits: int, state: Optional[np.ndarray] = None,
                length: Optional[int] = None, taps: Optional[list] = None,
                *, device=None) -> Tuple[torch.Tensor, np.ndarray]:
    """Maximum-length sequence (MLS) generator
    (scipy.signal.max_len_seq semantics): returns ``length`` bits (default
    the full period 2**nbits - 1) of the binary sequence as an int8 tensor
    on ``device`` (None: CUDA), plus the final LFSR state (host int8) for
    streaming continuation.  The Fibonacci LFSR is serial bit work, so it
    runs on the host."""
    if taps is None:
        if nbits not in _MLS_TAPS:
            raise ValueError(f"nbits={nbits} needs explicit taps "
                             f"(defaults cover 2..32)")
        taps = _MLS_TAPS[nbits]
    taps = sorted(set(int(x) for x in taps), reverse=True)
    if taps[0] >= nbits or taps[-1] < 1:
        raise ValueError(f"taps must lie in [1, nbits), got {taps}")
    dev = resolve_device(device)
    n_out = (1 << nbits) - 1 if length is None else int(length)
    if state is None:
        st = np.ones(nbits, dtype=np.int8)
    else:
        if torch.is_tensor(state):
            state = state.detach().cpu().numpy()
        st = (np.asarray(state) != 0).astype(np.int8)
        if st.shape != (nbits,) or not st.any():
            raise ValueError("state must be nbits long and not all-zero")
    seq, st = _mls_run(nbits, taps, st, n_out)
    return torch.as_tensor(seq, device=dev), st


def _mls_run(nbits: int, taps, st: np.ndarray, n_out: int):
    """LFSR inner loop: the native library's ``sdsp_mls`` for registers
    up to 64 bits (the full period of nbits = 24 is ~16.7M dependent
    steps: milliseconds in C, minutes in Python), which raises where the
    library does not build; a Python loop for longer registers, which the
    native window does not hold."""
    if nbits <= 64:
        from simpledsp_tpu_torch.runtime.stream import load_library

        out = np.empty(n_out, dtype=np.uint8)
        st_out = np.empty(nbits, dtype=np.uint8)
        load_library().sdsp_mls(
            nbits, np.ascontiguousarray(taps, dtype=np.int32), len(taps),
            np.ascontiguousarray(st, dtype=np.uint8), out, n_out, st_out)
        return out.astype(np.int8), st_out.astype(np.int8)
    seq = np.empty(n_out, dtype=np.int8)
    stl = [int(v) for v in st]
    for i in range(n_out):
        fb = stl[0]
        seq[i] = fb
        for t_ in taps:
            fb ^= stl[t_]
        stl = stl[1:]
        stl.append(fb)
    return seq, np.asarray(stl, dtype=np.int8)


def unit_impulse(shape, idx: Optional[Union[int, str, Tuple[int, ...]]] = None,
                 dtype=torch.float32, *, device=None) -> torch.Tensor:
    """Unit impulse delta[n - idx] (scipy.signal.unit_impulse; idx=None ->
    index 0, idx='mid' -> the center) on ``device`` (None: CUDA)."""
    dev = resolve_device(device)
    if isinstance(shape, int):
        shape = (shape,)
    shape = tuple(int(d) for d in shape)
    if idx is None:
        idx = (0,) * len(shape)
    elif idx == "mid":
        idx = tuple(d // 2 for d in shape)
    elif isinstance(idx, int):
        idx = (idx,) * len(shape)
    out = torch.zeros(shape, dtype=dtype, device=dev)
    out[tuple(idx)] = 1
    return out
