"""Plain reference of a radio telescope F-engine's channelizer: an M-branch
critically sampled polyphase filter bank on a real stream, keeping the
M/2 channels below the Nyquist channel, in float64 on the CPU.

It imports nothing of the program and designs the prototype again from
the configuration's parameters: a Kaiser-windowed sinc of M K taps with its
-6 dB edge at half the channel spacing (0.5 / M cycles a sample), for 80 dB
and normalised to unit gain at DC.  At output sample g of channel c (input
index g M), for c < M/2:

    y_c[g] = sum_r e^{+2 pi i c r / M} v_r[g],
    v_r[g] = sum_j h[j M + r] x[(g - j) M - r]

with x = 0 before the first sample given.  The branch sums are taken from
that definition, index by index, in blocks of spectra so that a stream of
2^22 samples fits; the sum over branches is ``torch.fft.ifft`` unscaled
(``norm="forward"``).

Departures from the port's docstring (``ops/channelizer.py``
``PFBChannelizer.process_real``): none.

``rounding="bfloat16"`` computes the same with the input samples and the
taps rounded to bfloat16 first (8 bits of significand, to nearest), sums
in float64: the control that the comparison has to fail.
``rounding="tf32"`` rounds them to TF32's 11 bits (10 stored, to nearest,
ties to even, float32's exponent), the nearest precision below float32:
it has to fail the comparison too.
"""

from __future__ import annotations

import contextlib
import math

import torch

__all__ = ["kaiser_beta", "prototype", "channels"]

_ROUNDINGS = (None, "bfloat16", "tf32")


def kaiser_beta(atten_db: float) -> float:
    if atten_db > 50.0:
        return 0.1102 * (atten_db - 8.7)
    if atten_db >= 21.0:
        return 0.5842 * (atten_db - 21.0) ** 0.4 + 0.07886 * (atten_db - 21.0)
    return 0.0


def prototype(branches: int, taps: int, atten_db: float = 80.0
              ) -> torch.Tensor:
    """The M K-tap Kaiser-windowed sinc low-pass, -6 dB edge at 0.5 / M,
    unit gain at DC, float64."""
    num = branches * taps
    fc = 0.5 / branches
    n = torch.arange(num, dtype=torch.float64) - (num - 1) / 2.0
    w = torch.kaiser_window(num, periodic=False, beta=kaiser_beta(atten_db),
                            dtype=torch.float64)
    h = 2.0 * fc * torch.sinc(2.0 * fc * n) * w
    return h / h.sum()


def _rounded(a: torch.Tensor, rounding: str) -> torch.Tensor:
    """``a`` rounded as ``rounding`` says, back in float64."""
    if rounding == "bfloat16":
        return a.to(torch.bfloat16).to(torch.float64)
    u = a.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    u = u & 0xFFFFFFFF
    u = (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000
    u = torch.where(u >= 1 << 31, u - (1 << 32), u)
    return u.to(torch.int32).view(torch.float32).to(torch.float64)


@contextlib.contextmanager
def _ieee_products():
    """Float32 matmuls in IEEE float32 on the card while the reference runs
    (TF32 off), as the configuration states."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def channels(x: torch.Tensor, taps: torch.Tensor, branches: int, *,
             prefix: int = 0, block: int = 32, rounding: str = None
             ) -> torch.Tensor:
    """The channels (..., T // M, M // 2) complex128 of the real stream
    ``x`` (..., prefix + T), whose first ``prefix`` samples come before
    the call (they set the filters' memory and give no spectrum of their
    own), for the prototype ``taps`` of M K values."""
    if rounding not in _ROUNDINGS:
        raise ValueError(f"rounding is one of {_ROUNDINGS}")
    m = branches
    x = torch.as_tensor(x).to(torch.float64)
    h = torch.as_tensor(taps).to(torch.float64)
    if rounding is not None:
        x, h = _rounded(x, rounding), _rounded(h, rounding)
    k = math.ceil(h.numel() / m)
    h = torch.nn.functional.pad(h, (0, k * m - h.numel())).reshape(k, m)
    t = x.shape[-1] - prefix
    if t < 0 or t % m:
        raise ValueError(f"{t} samples after the prefix of {prefix}: not a "
                         f"multiple of M={m}")
    # x at index i (counted from the call's first sample) lies at
    # xe[base + i]; everything before the stream given is zero.
    lead = max(0, k * m - 1 - prefix)
    xe = torch.nn.functional.pad(x, (lead, 0))
    base = prefix + lead
    j = torch.arange(k)[:, None]
    r = torch.arange(m)[None, :]
    spectra = t // m
    out = []
    with _ieee_products():
        for g0 in range(0, spectra, block):
            g = torch.arange(g0, min(g0 + block, spectra))[:, None, None]
            index = base + (g - j) * m - r                     # (G, K, M)
            v = (xe[..., index] * h).sum(-2)                   # (..., G, M)
            y = torch.fft.ifft(v.to(torch.complex128), norm="forward")
            out.append(y[..., : m // 2])
    if not out:
        return torch.zeros(x.shape[:-1] + (0, m // 2),
                           dtype=torch.complex128)
    return torch.cat(out, -2)
