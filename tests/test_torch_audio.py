"""The port's audio features (simpledsp_tpu_torch.models.audio) against the
JAX package and an independent numpy pipeline, in float64 on the CPU (the
port of tests/test_audio.py).

Tolerances: the mel filterbank is host float64 NumPy in both packages, so
equal bit for bit; the log-mel energies and MFCCs agree with the JAX
package and the numpy pipeline to 1e-8 (log of energies that reach
1e-10, as in the JAX tests); Griffin-Lim agrees with the JAX package to
1e-9 relative to the largest sample after 5 iterations in float64.
The table crosses through ``convert.mel_from_numpy`` bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.fft as sfft
import torch

from simpledsp_tpu.models import audio as jaudio
from simpledsp_tpu.ops.spectral import stft_ri as jstft_ri
from simpledsp_tpu_torch.convert import mel_from_numpy
from simpledsp_tpu_torch.models import audio as taudio
from simpledsp_tpu_torch.ops.spectral import stft_ri

FS = 16000.0
NFFT = 512
NMELS = 40


def _numpy_logmel(x, nfft, hop, n_mels, fs):
    """Independent reference: numpy rfft + periodic hann + fb matmul."""
    w = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(nfft) / nfft)
    nframes = (x.shape[-1] - nfft) // hop + 1
    frames = np.stack([x[..., i * hop: i * hop + nfft] * w
                       for i in range(nframes)], axis=-2)
    spec = np.abs(np.fft.rfft(frames, axis=-1)) ** 2
    fb = taudio.mel_filterbank(n_mels, nfft, fs)
    return np.log(np.maximum(spec @ fb.T, 1e-10))


@pytest.mark.parametrize("args", [(NMELS, NFFT, FS), (64, 1024, 22050.0),
                                  (26, 400, 8000.0, 300.0, 3400.0)])
def test_mel_filterbank_equals_jax(args):
    fb = taudio.mel_filterbank(*args)
    np.testing.assert_array_equal(fb, jaudio.mel_filterbank(*args))
    assert fb.shape == (args[0], args[1] // 2 + 1)
    assert np.all(fb >= 0.0) and np.all(fb.max(axis=1) > 0.5)
    assert fb.max() <= 1.0 + 1e-12
    assert np.all(np.diff(np.argmax(fb, axis=1)) >= 0)


def test_mel_filterbank_bad_range_rejected():
    with pytest.raises(ValueError):
        taudio.mel_filterbank(8, NFFT, FS, fmin=9000.0, fmax=8000.0)


@pytest.mark.parametrize("hop", [None, 128])
def test_mel_spectrogram_matches_jax_and_numpy(rng, hop):
    x = rng.standard_normal((2, 4096))
    m = taudio.MelSpectrogram(NFFT, hop, NMELS, FS, dtype=torch.float64,
                              device="cpu")
    got = m(torch.as_tensor(x)).numpy()
    want = np.asarray(jaudio.MelSpectrogram(NFFT, hop, NMELS, FS,
                                            dtype=jnp.float64)(
        jnp.asarray(x)))
    ref = _numpy_logmel(x, NFFT, hop or NFFT // 2, NMELS, FS)
    assert got.shape == ref.shape == want.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-8)


def test_mel_spectrogram_linear_float32_and_tone_band():
    f_tone = 1000.0
    x = np.sin(2 * np.pi * f_tone * np.arange(16000) / FS)
    m = taudio.MelSpectrogram(NFFT, None, NMELS, FS, log=False, device="cpu")
    mel = m(torch.as_tensor(x))
    assert mel.dtype == torch.float32
    want = np.asarray(jaudio.MelSpectrogram(NFFT, None, NMELS, FS,
                                            log=False)(jnp.asarray(x)))
    np.testing.assert_allclose(mel.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
    band = int(np.argmax(mel.numpy().mean(axis=0)))
    assert abs(band - taudio._mel_bin_of_hz(f_tone, NMELS, FS)) <= 1


def test_mel_table_crosses_through_convert(rng):
    jm = jaudio.MelSpectrogram(NFFT, 128, NMELS, FS, fmin=50.0,
                               dtype=jnp.float64)
    tm = mel_from_numpy(jm._fbT, jm.nfft, jm.hop, jm.fs, window=jm.window,
                        log=jm.log, eps=jm.eps, device="cpu",
                        dtype=torch.float64)
    np.testing.assert_array_equal(tm.fbT.numpy(), jm._fbT)
    x = rng.standard_normal(4096)
    np.testing.assert_allclose(tm(torch.as_tensor(x)).numpy(),
                               np.asarray(jm(jnp.asarray(x))), rtol=0,
                               atol=1e-8)
    with pytest.raises(ValueError):
        mel_from_numpy(jm._fbT[:-1], NFFT, device="cpu")
    with pytest.raises(ValueError):
        mel_from_numpy(jm._fbT[0], NFFT, device="cpu")


def test_mfcc_matches_jax_and_reference_pipeline(rng):
    x = rng.standard_normal(8192)
    hop = NFFT // 2
    got = taudio.mfcc(torch.as_tensor(x), 13, nfft=NFFT, hop=hop,
                      n_mels=NMELS, fs=FS, dtype=torch.float64).numpy()
    want = np.asarray(jaudio.mfcc(jnp.asarray(x), 13, nfft=NFFT, hop=hop,
                                  n_mels=NMELS, fs=FS, dtype=jnp.float64))
    logmel = _numpy_logmel(x, NFFT, hop, NMELS, FS)
    ref = sfft.dct(logmel, type=2, norm="ortho", axis=-1)[..., :13]
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-8)


def test_mfcc_batched_shape_and_refusal(rng):
    x = torch.as_tensor(rng.standard_normal((3, 2, 4096)))
    out = taudio.mfcc(x, 13, nfft=NFFT, n_mels=NMELS, fs=FS)
    nframes = (4096 - NFFT) // (NFFT // 2) + 1
    assert tuple(out.shape) == (3, 2, nframes, 13)
    with pytest.raises(ValueError):
        taudio.mfcc(torch.as_tensor(rng.standard_normal(2048)), n_mfcc=99,
                    n_mels=40)


def _tones():
    t = np.arange(8192)
    return np.sin(2 * np.pi * 0.03 * t) + 0.5 * np.sin(
        2 * np.pi * 0.11 * t + 1.0)


def test_griffin_lim_matches_jax():
    x = _tones()
    sr, si = jstft_ri(jnp.asarray(x), 512, hop=128)
    mag = np.array(jnp.hypot(sr, si))
    for momentum in (0.99, 0.0):
        got = taudio.griffin_lim(torch.as_tensor(mag), nfft=512, hop=128,
                                 n_iter=5, momentum=momentum).numpy()
        want = np.asarray(jaudio.griffin_lim(jnp.asarray(mag), nfft=512,
                                             hop=128, n_iter=5,
                                             momentum=momentum))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-9 * np.abs(want).max())


def test_griffin_lim_spectral_convergence():
    """|stft(y)| approaches the target magnitude with iterations."""
    x = torch.as_tensor(_tones())
    sr, si = stft_ri(x, 512, hop=128)
    mag = torch.hypot(sr, si)

    def err(n):
        y = taudio.griffin_lim(mag, nfft=512, hop=128, n_iter=n)
        yr, yi = stft_ri(y, 512, hop=128)
        return float(torch.linalg.norm(torch.hypot(yr, yi) - mag)
                     / torch.linalg.norm(mag))

    e0, e5, e50 = err(0), err(5), err(50)
    assert e5 < e0 and e50 < e5
    assert e50 < 0.15


def test_griffin_lim_shapes_and_args(rng):
    mag = torch.as_tensor(np.abs(rng.standard_normal((2, 9, 129))))
    y = taudio.griffin_lim(mag, hop=64, n_iter=3)
    assert tuple(y.shape) == (2, (9 - 1) * 64 + 256)
    y2 = taudio.griffin_lim(mag, hop=64, n_iter=3, length=300)
    assert tuple(y2.shape) == (2, 300)
    with pytest.raises(ValueError):
        taudio.griffin_lim(mag, nfft=512, n_iter=3)   # bins mismatch
    with pytest.raises(ValueError):
        taudio.griffin_lim(mag, n_iter=-1)
