"""The yardstick of the rooflines: the card's peaks and the algorithms' work.

The operations and bytes are the algorithm's, counted from the shapes of a
call, so the count is the same whatever kernel, formulation or number of
launches implements it.  A roofline share is the least time the card could
take (the larger of operations over the float32 peak and bytes over the
memory bandwidth) over the time measured.
"""

from __future__ import annotations

import math

# One NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12          # float32 outside the tensor cores

F32 = 4                     # bytes of a float32 value

# A biquad section as the plain recursion computes it (direct form):
# y = b0 x + b1 x1 + b2 x2 - a1 y1 - a2 y2, five multiplies and four adds.
BIQUAD_FLOPS = 9


def bound_s(flops: float, nbytes: float) -> float:
    """The least seconds the card could take for this work."""
    return max(flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S)


def real_fft_flops(n: int) -> float:
    """The usual count of one real N-point transform: 2.5 N log2 N."""
    return 2.5 * n * math.log2(n)


def chain_work(channels: int, samples: int, fft_size: int, sections: int,
               state_values: int) -> dict:
    """An IIR cascade of ``sections`` biquads, then a real FFT of each
    ``fft_size`` frame, over ``channels`` x ``samples`` float32 samples.

    Bytes: every input sample read once, the packed one-sided spectrum
    (N/2 complex values a frame, the Nyquist bin in the spare slot) written
    once, the carried state (``state_values`` a channel) read and written
    once.  Operations: the recursion's multiplies and adds for each sample
    and section, and 2.5 N log2 N for each real frame."""
    n = channels * samples
    frames = n // fft_size
    nbytes = (n + frames * fft_size + 2 * channels * state_values) * F32
    flops = n * sections * BIQUAD_FLOPS + frames * real_fft_flops(fft_size)
    return {"flops": float(flops), "bytes": float(nbytes)}


def pfb_fm_work(streams: int, samples: int, channels: int, taps: int,
                decim: int, audio_taps: int) -> dict:
    """A critically sampled M-channel polyphase channelizer, an FM
    discriminator on every channel and an audio decimator by ``decim``,
    over ``streams`` x ``samples`` complex samples as (re, im) float32.

    Operations for each complex input sample: the branch FIR (4 K, a
    complex sample times a real tap), the M-point DFT (5 log2 M), the
    discriminator's conjugate product (6) and the decimator (2 KD / decim).
    Bytes: the input planes read once and the audio written once.
    """
    n = streams * samples
    per = (4 * taps + 5 * math.log2(channels) + 6
           + 2 * audio_taps / decim)
    nbytes = (2 * n + n // decim) * F32
    return {"flops": float(n * per), "bytes": float(nbytes)}
