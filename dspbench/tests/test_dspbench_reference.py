"""Each plain reference against a direct float64 loop at small sizes."""

import json
import math

import numpy as np
import pytest
import scipy.signal

from dspbench.reference import fm_bank, northstar_chain
from dspbench.registry import BENCH_DIR


def _biquads(sos, x):
    """The cascade, one sample and one section at a time (direct form I)."""
    y = np.array(x, dtype=np.float64)
    for b0, b1, b2, _, a1, a2 in sos:
        out = np.zeros_like(y)
        x1 = x2 = y1 = y2 = 0.0
        for n, v in enumerate(y):
            out[n] = b0 * v + b1 * x1 + b2 * x2 - a1 * y1 - a2 * y2
            x2, x1, y2, y1 = x1, v, y1, out[n]
        y = out
    return y


def _packed_dft(frame):
    n = frame.size
    k = np.arange(n // 2 + 1)[:, None]
    spec = (frame * np.exp(-2j * np.pi * k * np.arange(n) / n)).sum(axis=1)
    re, im = spec[:n // 2].real.copy(), spec[:n // 2].imag.copy()
    im[0] = spec[n // 2].real
    return re, im


def test_lowpass_sections_are_scipys_butterworth():
    sos = northstar_chain.lowpass_sos(4, 2000.0, 39000.0)
    ref = scipy.signal.butter(8, 2000.0, fs=39000.0, output="sos")
    _, h = scipy.signal.sosfreqz(sos, worN=1024)
    _, h_ref = scipy.signal.sosfreqz(ref, worN=1024)
    np.testing.assert_allclose(np.abs(h), np.abs(h_ref), rtol=1e-9,
                               atol=1e-12)
    impulse = np.zeros(256)
    impulse[0] = 1.0
    np.testing.assert_allclose(scipy.signal.sosfilt(sos, impulse),
                               scipy.signal.sosfilt(ref, impulse),
                               rtol=1e-9, atol=1e-14)


def test_chain_spectra_against_a_direct_loop():
    rng = np.random.default_rng(3)
    sos = northstar_chain.lowpass_sos(3, 0.1, 1.0)
    stream = rng.standard_normal((2, 48 + 64))
    warm, x = stream[:, :48], stream[:, 48:]
    re, im = northstar_chain.spectra(sos, x, 16, warm)
    for c in range(2):
        y = _biquads(sos, stream[c])[48:]
        for f in range(4):
            r, i = _packed_dft(y[16 * f:16 * (f + 1)])
            np.testing.assert_allclose(re[c, f], r, atol=1e-11)
            np.testing.assert_allclose(im[c, f], i, atol=1e-11)


def test_the_chain_forgets_its_past_within_the_warm_samples():
    with open(BENCH_DIR / "configs" / "northstar_chain_n4096.json") as f:
        p = json.load(f)["params"]
    sos = northstar_chain.lowpass_sos(p["sections"], p["cutoff_hz"], p["fs"])
    radius = northstar_chain.slowest_pole(sos)
    assert radius < 1.0
    # Far below float64 rounding of the state entering a call.
    assert p["warm_samples"] * math.log10(radius) < -30


def _bank_loop(z, m, k, q, kd, fs, dev):
    """The bank from rest, one output at a time."""
    h = fm_bank.lowpass_taps(m * k, 0.5 / m)
    a = fm_bank.lowpass_taps(kd, 0.4 / q)
    gain = (fs / m) / (2 * np.pi * dev)
    b, t = z.shape
    g_n = t // m
    out = np.zeros((b, m, g_n // q))
    for s in range(b):
        def x(i):
            return z[s, i] if i >= 0 else 0.0
        y = np.zeros((m, g_n), complex)
        for g in range(g_n):
            v = [sum(h[j * m + r] * x((g - j) * m - r) for j in range(k))
                 for r in range(m)]
            for c in range(m):
                y[c, g] = sum(np.exp(2j * np.pi * c * r / m) * v[r]
                              for r in range(m))
        prev = np.concatenate([np.ones((m, 1)), y[:, :-1]], axis=1)
        disc = np.angle(y * np.conj(prev)) * gain
        for c in range(m):
            for n in range(g_n // q):
                out[s, c, n] = sum(a[j] * disc[c, n * q - j]
                                   for j in range(kd) if n * q - j >= 0)
    return out


def test_bank_audio_against_a_direct_loop_and_from_a_prefix():
    m, k, q, kd, fs, dev = 4, 3, 2, 5, 8000.0, 500.0
    prefix = fm_bank.memory(m, k, q, kd)
    assert prefix == 40
    rng = np.random.default_rng(4)
    t = 3 * prefix
    n = np.arange(t)
    z = np.exp(1j * (2 * np.pi * 0.26 * n + 1.5 * np.sin(2 * np.pi * n / 37)
                     + rng.uniform(0, 2 * np.pi, (2, 1))))
    z += 0.01 * (rng.standard_normal((2, t)) + 1j * rng.standard_normal(
        (2, t)))
    full = _bank_loop(z, m, k, q, kd, fs, dev)
    kw = dict(channels=m, taps=k, fs=fs, decim=q, audio_taps=kd,
              deviation_hz=dev)
    got = fm_bank.audio(z, prefix=prefix, **kw)
    np.testing.assert_allclose(got, full[:, :, prefix // (m * q):],
                               atol=1e-12)
    # The last third from the samples just before it alone: the prefix
    # sets every stage's state.
    tail = fm_bank.audio(z[:, prefix:], prefix=prefix, **kw)
    np.testing.assert_allclose(tail, full[:, :, 2 * prefix // (m * q):],
                               atol=1e-12)
    low = fm_bank.audio(z, prefix=prefix, tf32=True, **kw)
    err = np.abs(low - got).max() / np.abs(got).max()
    assert 1e-5 < err < 1e-1


def test_bank_refuses_a_short_prefix():
    with pytest.raises(ValueError):
        fm_bank.audio(np.ones((1, 64), complex), channels=4, taps=3,
                      fs=8000.0, decim=2, audio_taps=5, deviation_hz=500.0,
                      prefix=32)


def test_tf32_rounds_to_ten_bits_ties_to_even():
    x = np.array([1.0, 1 + 2 ** -10, 1 + 2 ** -11, 1 + 3 * 2 ** -11,
                  -(1 + 3 * 2 ** -11), 3.0e-3], np.float32)
    got = fm_bank.round_tf32(x)
    want = np.array([1.0, 1 + 2 ** -10, 1.0, 1 + 2 ** -9, -(1 + 2 ** -9)],
                    np.float32)
    np.testing.assert_array_equal(got[:5], want)
    assert abs(got[5] - x[5]) <= x[5] * 2 ** -11
