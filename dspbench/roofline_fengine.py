"""The work of one F-engine call, counted from its shapes: the algorithm's,
whatever kernels, formulations or launches implement it (``roofline.py``
holds the card's peaks).

A call channelizes S real streams of T samples each with an M-branch
polyphase filter bank of K taps a branch and keeps the M/2 channels below
the Nyquist channel: T / M spectra a stream.
"""

from __future__ import annotations

from dspbench.roofline import F32, real_fft_flops
from dspbench.roofline_radar import fft_flops


def half_transforms_work(streams: int, samples: int, branches: int) -> dict:
    """The half-spectrum transforms' complex part alone (the frames FFT
    kernel's share): one M/2-point complex FFT a spectrum, reading its M/2
    complex input values and writing its M/2 output values once, as
    (re, im) float32 planes."""
    frames = streams * (samples // branches)
    half = branches // 2
    return {"flops": float(frames * fft_flops(half)),
            "bytes": float(frames * half * 2 * 2 * F32)}


def fengine_work(streams: int, samples: int, branches: int,
                 taps: int) -> dict:
    """One call: S x T float32 samples in, S x (T / M) x (M / 2) channels
    out as (re, im) float32 planes, the carried history of M K - 1 samples
    a stream read and written once.

    Operations: the branch FIR (2 K a sample: a multiply and an add a tap)
    and a real M-point FFT a spectrum (2.5 M log2 M).  ``fft_flops`` and
    ``fft_bytes`` are :func:`half_transforms_work`'s."""
    n = streams * samples
    frames = n // branches
    history = streams * (branches * taps - 1)
    nbytes = (n + frames * (branches // 2) * 2 + 2 * history) * F32
    flops = n * 2 * taps + frames * real_fft_flops(branches)
    half = half_transforms_work(streams, samples, branches)
    return {"flops": float(flops), "bytes": float(nbytes),
            "fft_flops": half["flops"], "fft_bytes": half["bytes"]}
