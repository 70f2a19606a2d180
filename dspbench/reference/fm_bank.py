"""Plain reference of the FM receiver bank: an M-channel polyphase
channelizer, an FM discriminator on every channel and an audio decimator.

It imports nothing of the program and designs both filters again from the
configuration's parameters: the prototype is a Kaiser-windowed sinc of
M K taps with its -6 dB edge at half the channel spacing, the audio filter
one of ``audio_taps`` taps at 0.4 / decim, both for 80 dB and normalised to
unit gain at DC.

At output sample g of channel c (input index g M):

    y_c[g] = sum_r e^{+2 pi i c r / M} v_r[g],
    v_r[g] = sum_j h[j M + r] x[(g - j) M - r]
    disc_c[g] = angle(y_c[g] conj(y_c[g - 1])) (fs / M) / (2 pi deviation)
    audio_c[m] = sum_j a[j] disc_c[m decim - j]

Every stage is a finite filter or a one-sample difference, so the state the
program carries from call to call is worked out again exactly by running
the bank from rest over the samples just before the call: the prefix only
has to be longer than the channelizer's, the discriminator's and the
decimator's memories together (:func:`memory`).

``tf32=True`` computes the same in float32 with every product's operands
rounded to TF32 (10 bits of significand), the precision a matmul takes on
the card where TF32 is allowed: the control that the comparison has to
fail.
"""

from __future__ import annotations

import numpy as np


def kaiser_beta(atten_db: float) -> float:
    if atten_db > 50.0:
        return 0.1102 * (atten_db - 8.7)
    if atten_db >= 21.0:
        return 0.5842 * (atten_db - 21.0) ** 0.4 + 0.07886 * (atten_db - 21.0)
    return 0.0


def lowpass_taps(num_taps: int, fc: float, atten_db: float = 80.0
                 ) -> np.ndarray:
    """Kaiser-windowed sinc low-pass, -6 dB edge at ``fc`` cycles a sample,
    unit gain at DC."""
    n = np.arange(num_taps, dtype=np.float64) - (num_taps - 1) / 2.0
    h = 2.0 * fc * np.sinc(2.0 * fc * n) * np.kaiser(num_taps,
                                                     kaiser_beta(atten_db))
    return h / h.sum()


def memory(channels: int, taps: int, decim: int, audio_taps: int) -> int:
    """Input samples a prefix must hold to set every stage's state: the
    channelizer's M K - 1, one channel sample for the discriminator and
    the decimator's taps, rounded up to whole output samples."""
    need = channels * taps - 1 + channels * (1 + audio_taps)
    step = channels * decim
    return -(-need // step) * step


def round_tf32(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to TF32's 10-bit significand, to nearest,
    ties to even."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    u = (u + np.uint32(0xFFF) + ((u >> np.uint32(13)) & np.uint32(1))) \
        & np.uint32(0xFFFFE000)
    return u.view(np.float32)


def _tf32c(z: np.ndarray) -> np.ndarray:
    return (round_tf32(z.real) + 1j * round_tf32(z.imag)).astype(np.complex64)


def audio(z: np.ndarray, *, channels: int, taps: int, fs: float, decim: int,
          audio_taps: int, deviation_hz: float, prefix: int,
          tf32: bool = False) -> np.ndarray:
    """The bank's audio for the last ``T - prefix`` samples of ``z`` (B, T)
    complex, the bank at rest before ``z``.  Returns (B, M, (T - prefix) /
    (M decim)).  ``prefix`` is a multiple of M decim of at least
    :func:`memory` samples."""
    m, k, q = channels, taps, decim
    b, t = z.shape
    if t % (m * q) or prefix % (m * q) or prefix < memory(m, k, q, audio_taps):
        raise ValueError(f"need T and prefix multiples of M decim and a "
                         f"prefix of {memory(m, k, q, audio_taps)} or more; "
                         f"got T={t}, prefix={prefix}")
    low = round_tf32 if tf32 else None
    h = lowpass_taps(m * k, 0.5 / m)
    a = lowpass_taps(audio_taps, 0.4 / q)
    gain = (fs / m) / (2.0 * np.pi * deviation_hz)
    if low is not None:
        z, h, a = _tf32c(z), low(h), low(a)
    ctype = np.complex64 if low is not None else np.complex128
    rtype = np.float32 if low is not None else np.float64

    # Channelizer: frames of M samples, branch r reads column M - 1 - r.
    xp = np.concatenate([np.zeros((b, m * k - 1), ctype), z.astype(ctype)],
                        axis=1)
    g = t // m
    frames = xp[:, :(g + k - 1) * m].reshape(b, g + k - 1, m)[:, :, ::-1]
    branch = h.reshape(k, m).T.astype(rtype)          # [r, j] = h[j M + r]
    v = np.zeros((b, g, m), ctype)
    for j in range(k):
        lag = k - 1 - j
        v += frames[:, lag:lag + g, :] * branch[:, j]
    r = np.arange(m)
    idft = np.exp(2j * np.pi * np.outer(r, r) / m).astype(ctype)  # [r, c]
    if low is not None:
        v, idft = _tf32c(v), _tf32c(idft)
    y = (v @ idft).transpose(0, 2, 1)                  # (B, M, G)

    # Discriminator, from y[-1] = 1.
    prev = np.concatenate([np.ones((b, m, 1), ctype), y[:, :, :-1]], axis=2)
    if low is not None:
        y, prev = _tf32c(y), _tf32c(prev)
    d = (y * np.conj(prev)).astype(ctype)
    disc = (np.arctan2(d.imag, d.real) * rtype(gain)).astype(rtype)

    # Audio decimator: audio[n] = sum_j a[j] disc[n q - j], from rest.
    if low is not None:
        disc = low(disc)
    kd = a.size
    dp = np.concatenate([np.zeros((b, m, kd - 1), rtype), disc], axis=2)
    n_out = g // q
    out = np.zeros((b, m, n_out), rtype)
    for j in range(kd):
        start = kd - 1 - j
        out += rtype(a[j]) * dp[:, :, start:start + (n_out - 1) * q + 1:q]
    return out[:, :, prefix // (m * q):]
