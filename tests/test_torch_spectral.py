"""The port's spectral analysis (simpledsp_tpu_torch.ops.spectral) against the
JAX package and scipy, in float64 on the CPU.

Tolerances: 1e-10 relative to the largest output magnitude against the JAX
package (the two packages sum in different orders); against scipy, the
tolerances the JAX package's own tests hold it to (tests/test_fft.py,
tests/test_transforms.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as ss
import torch

from simpledsp_tpu.ops import spectral as jsp
from simpledsp_tpu_torch.ops import spectral as tsp

RTOL = 1e-10


def _close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


SPEC_CASES = [(256, 128, "hann", False, "direct"),
              (256, 128, "hann", True, "fft"),
              (250, 125, "hamming", True, "auto"),
              (4096, 2048, "hann", True, "auto"),
              (1024, 1024, "rect", False, "fft"),
              (100, 30, ("kaiser", 8.0), True, "direct")]


@pytest.mark.parametrize("nfft,hop,window,onesided,method", SPEC_CASES)
@pytest.mark.parametrize("detrend", [False, "constant", "linear"])
def test_spectrogram_matches_jax(nfft, hop, window, onesided, method,
                                 detrend, rng):
    x = rng.standard_normal((2, 3 * nfft + 17)) + 0.5
    yr, yi = tsp.spectrogram_ri(_t(x), nfft, hop=hop, window=window,
                                detrend=detrend, onesided=onesided,
                                method=method)
    jr, ji = jsp.spectrogram_ri(jnp.asarray(x), nfft, hop=hop, window=window,
                                detrend=detrend, onesided=onesided,
                                method=method)
    _close(yr, jr)
    _close(yi, ji)


@pytest.mark.parametrize("nfft,hop,window,onesided",
                         [(256, 128, "hann", True), (256, 64, "hamming", True),
                          (128, 128, "rect", True), (64, 16, "hann", False),
                          (4096, 2048, "hann", True)])
@pytest.mark.parametrize("method", ["direct", "fft"])
def test_stft_istft_match_jax_and_invert(nfft, hop, window, onesided, method,
                                         rng):
    x = rng.standard_normal((2, 6 * nfft))
    sr, si = tsp.stft_ri(_t(x), nfft, hop=hop, window=window,
                         onesided=onesided)
    jr, ji = jsp.stft_ri(jnp.asarray(x), nfft, hop=hop, window=window,
                         onesided=onesided)
    _close(sr, jr)
    _close(si, ji)
    y = tsp.istft_ri(sr, si, nfft, hop=hop, window=window,
                     onesided=onesided, method=method)
    jy = jsp.istft_ri(jr, ji, nfft, hop=hop, window=window,
                      onesided=onesided, method=method)
    _close(y, jy)
    # Away from the ends (where the window power falls below the
    # normalizer's floor) the weighted overlap-add inverts exactly.
    t = y.shape[-1]
    np.testing.assert_allclose(y.numpy()[:, hop:-hop], x[:, hop:t - hop],
                               rtol=0, atol=1e-10)


def test_stft_matches_scipy(rng):
    """stft_ri == scipy.signal.stft(boundary=None, padded=False) * sum(w)."""
    x = rng.standard_normal(2048)
    sr, si = tsp.stft_ri(_t(x), nfft=256, hop=128)
    w = np.hanning(257)[:-1]
    _, _, zxx = ss.stft(x, nperseg=256, noverlap=128, boundary=None,
                        padded=False)
    ref = (zxx * np.sum(w)).T
    got = sr.numpy() + 1j * si.numpy()
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) < 1e-9 * np.max(np.abs(ref))


def test_istft_rejects_bad_arguments():
    z = torch.zeros(4, 33, dtype=torch.float64)
    with pytest.raises(ValueError, match="divide"):
        tsp.istft_ri(z, z, nfft=64, hop=48)
    with pytest.raises(ValueError, match="method"):
        tsp.istft_ri(z, z, nfft=64, method="fast")
    with pytest.raises(ValueError, match="method"):
        tsp.spectrogram_ri(torch.zeros(256, dtype=torch.float64), 64,
                           method="fast")
    with pytest.raises(ValueError, match="shorter"):
        tsp.spectrogram_ri(torch.zeros(32, dtype=torch.float64), 64)
    with pytest.raises(ValueError, match="detrend"):
        tsp.spectrogram_ri(torch.zeros(256, dtype=torch.float64), 64,
                           detrend="cubic")


@pytest.mark.parametrize("nfft,overlap", [(1024, True), (125, True),
                                          (4096, False)])
@pytest.mark.parametrize("detrend", [False, "constant", "linear"])
def test_welch_matches_jax_and_scipy(nfft, overlap, detrend, rng):
    fs = 1000.0
    t = np.arange(16384) / fs
    x = np.sin(2 * np.pi * 123.0 * t) + 0.1 * rng.standard_normal(t.size) + 3.0
    f, p = tsp.welch_psd(_t(x), nfft, fs=fs, overlap=overlap, detrend=detrend)
    jf, jp = jsp.welch_psd(jnp.asarray(x), nfft, fs=fs, overlap=overlap,
                           detrend=detrend)
    np.testing.assert_array_equal(f, jf)
    _close(p, jp)
    hop = nfft // 2 if overlap else nfft
    sf, sp = ss.welch(x, fs=fs, nperseg=nfft, noverlap=nfft - hop,
                      detrend=detrend)
    np.testing.assert_allclose(f, sf)
    np.testing.assert_allclose(p.numpy(), sp, rtol=1e-7, atol=1e-12)


def test_csd_and_coherence_match_jax_and_scipy(rng):
    fs = 2000.0
    t = np.arange(8192) / fs
    s = np.sin(2 * np.pi * 97.0 * t)
    x = s + 0.2 * rng.standard_normal(t.size)
    y = np.roll(s, 11) + 0.2 * rng.standard_normal(t.size) + 1.5
    f, pr, pi = tsp.csd_ri(_t(x), _t(y), nfft=512, fs=fs)
    jf, jr, ji = jsp.csd_ri(jnp.asarray(x), jnp.asarray(y), nfft=512, fs=fs)
    np.testing.assert_array_equal(f, jf)
    _close(pr, jr)
    _close(pi, ji)
    _, pxy = ss.csd(x, y, fs=fs, nperseg=512, noverlap=256)
    np.testing.assert_allclose(pr.numpy(), pxy.real, rtol=1e-7, atol=1e-12)
    np.testing.assert_allclose(pi.numpy(), pxy.imag, rtol=1e-7, atol=1e-12)
    f, c = tsp.coherence(_t(x), _t(y), nfft=256, fs=fs)
    _, jc = jsp.coherence(jnp.asarray(x), jnp.asarray(y), nfft=256, fs=fs)
    _close(c, jc)
    _, sc = ss.coherence(x, y, fs=fs, nperseg=256, noverlap=128)
    np.testing.assert_allclose(c.numpy(), sc, rtol=1e-7, atol=1e-10)
    with pytest.raises(ValueError, match="equal signal lengths"):
        tsp.csd_ri(_t(x), _t(y[:-1]), nfft=256)


@pytest.mark.parametrize("window,nfft,detrend", [("boxcar", None, "constant"),
                                                 ("hann", 4096, "constant"),
                                                 ("hann", None, False)])
def test_periodogram_matches_jax_and_scipy(window, nfft, detrend, rng):
    x = rng.standard_normal((2, 3000)) + 2.0
    f, p = tsp.periodogram(_t(x), fs=100.0, window=window, nfft=nfft,
                           detrend=detrend)
    jf, jp = jsp.periodogram(jnp.asarray(x), fs=100.0, window=window,
                             nfft=nfft, detrend=detrend)
    np.testing.assert_array_equal(f, jf)
    _close(p, jp)
    sf, sp = ss.periodogram(x, fs=100.0, window=window, nfft=nfft,
                            detrend=detrend)
    np.testing.assert_allclose(f, sf)
    np.testing.assert_allclose(p.numpy(), sp, rtol=1e-7, atol=1e-12)
    with pytest.raises(ValueError, match="nfft"):
        tsp.periodogram(_t(x), nfft=100)


def test_lombscargle_matches_jax_and_scipy(rng):
    x = np.sort(rng.uniform(0, 10, 400))
    y = np.sin(2.3 * x) + 0.5 * rng.standard_normal(400)
    freqs = np.linspace(0.1, 10, 200)
    for pc in (False, True):
        for nm in (False, True):
            got = tsp.lombscargle(_t(x), _t(y), freqs, precenter=pc,
                                  normalize=nm)
            _close(got, jsp.lombscargle(jnp.asarray(x), jnp.asarray(y),
                                        freqs, precenter=pc, normalize=nm))
            np.testing.assert_allclose(
                got.numpy(), ss.lombscargle(x, y, freqs, precenter=pc,
                                            normalize=nm),
                rtol=1e-10, atol=1e-12)
    yb = np.stack([y, 2.0 * y])
    got = tsp.lombscargle(_t(x), _t(yb), freqs)
    np.testing.assert_allclose(got.numpy()[1],
                               ss.lombscargle(x, 2.0 * y, freqs), rtol=1e-10)
    with pytest.raises(ValueError, match="1-D"):
        tsp.lombscargle(torch.zeros(2, 4), torch.zeros(4), freqs)
    with pytest.raises(ValueError, match="trailing"):
        tsp.lombscargle(torch.zeros(4), torch.zeros(5), freqs)


@pytest.mark.parametrize("bp", [(1, None), (4, 20), (-10, 12), (None, 16),
                                (-10, -5)])
@pytest.mark.parametrize("kw", [{}, {"residual": "all"}, {"residual": None},
                                {"squared": True}, {"n_out": 32},
                                {"n_out": 128}])
def test_envelope_real_matches_jax_and_scipy(bp, kw, rng):
    z = rng.standard_normal((2, 64))
    got = tsp.envelope(_t(z), bp, **kw)
    _close(got, jsp.envelope(jnp.asarray(z), bp, **kw))
    ref = np.stack([np.asarray(ss.envelope(z[i], bp, **kw)) for i in range(2)],
                   axis=-2)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-12)


@pytest.mark.parametrize("bp", [(1, None), (4, 20), (-10, 12), (-20, -5)])
@pytest.mark.parametrize("res", ["all", "lowpass", None])
@pytest.mark.parametrize("n_out", [None, 32, 63, 128])
def test_envelope_complex_matches_jax_and_scipy(bp, res, n_out, rng):
    z = rng.standard_normal(64) + 1j * rng.standard_normal(64)
    got = tsp.envelope(_t(z), bp, residual=res, n_out=n_out)
    _close(got, jsp.envelope(jnp.asarray(z), bp, residual=res, n_out=n_out))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(ss.envelope(z, bp, residual=res,
                                            n_out=n_out)), atol=1e-12)


def test_envelope_axis_ri_and_bad_arguments(rng):
    z2 = rng.standard_normal((64, 5))
    got = tsp.envelope(_t(z2), (4, 20), axis=0)
    _close(got, jsp.envelope(jnp.asarray(z2), (4, 20), axis=0))
    np.testing.assert_allclose(got.numpy(),
                               ss.envelope(z2, (4, 20), axis=0), atol=1e-12)
    z = rng.standard_normal(64) + 1j * rng.standard_normal(64)
    env, (rr, ri) = tsp.envelope_ri(_t(z.real), _t(z.imag), (4, 20),
                                    n_out=32)
    jenv, (jrr, jri) = jsp.envelope_ri(jnp.asarray(z.real),
                                       jnp.asarray(z.imag), (4, 20), n_out=32)
    for a, b in ((env, jenv), (rr, jrr), (ri, jri)):
        _close(a, b)
    env2 = tsp.envelope_ri(_t(z.real), _t(z.imag), (4, 20), residual=None)
    _close(env2, ss.envelope(z, (4, 20), residual=None), rtol=1e-12)
    with pytest.raises(ValueError, match="bp_in"):
        tsp.envelope(torch.zeros(8, dtype=torch.float64), (5, 3))
    with pytest.raises(ValueError, match="residual"):
        tsp.envelope(torch.zeros(8, dtype=torch.float64), (1, None),
                     residual="sideways")


@pytest.mark.parametrize("win,nseg,nov", [
    ("hann", 256, 128), ("hann", 256, 192), ("hann", 256, 100),
    ("boxcar", 100, 0), ("hamming", 256, 128), (("kaiser", 8.0), 128, 64)])
def test_check_cola_nola_match_jax_and_scipy(win, nseg, nov):
    got = (tsp.check_COLA(win, nseg, nov), tsp.check_NOLA(win, nseg, nov))
    assert got == (jsp.check_COLA(win, nseg, nov),
                   jsp.check_NOLA(win, nseg, nov))
    assert got == (bool(ss.check_COLA(win, nseg, nov)),
                   bool(ss.check_NOLA(win, nseg, nov)))
    with pytest.raises(ValueError, match="noverlap"):
        tsp.check_COLA(win, nseg, nseg)


def test_window_taps_and_vectorstrength_match_jax(rng):
    for kind in ("hann", "rect", "hamming", ("kaiser", 8.0), ("tukey", 0.3)):
        np.testing.assert_array_equal(tsp.window_taps(kind, 100),
                                      jsp.window_taps(kind, 100))
    ev = rng.uniform(0, 100, 200)
    for period in (7.0, [5.0, 7.0]):
        for a, b in zip(tsp.vectorstrength(ev, period),
                        ss.vectorstrength(ev, period)):
            np.testing.assert_allclose(a, b, atol=1e-12)
        for a, b in zip(tsp.vectorstrength(ev, period),
                        jsp.vectorstrength(ev, period)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="positive"):
        tsp.vectorstrength(ev, -1.0)


def test_stft_dual_windows_match_jax_and_scipy(rng):
    from scipy.signal.windows import gaussian, hann
    for win, hop in [(hann(64), 16), (gaussian(50, 10), 13),
                     (rng.standard_normal(32) + 1.5, 8),
                     (hann(48) + 1j * 0.2 * gaussian(48, 9), 12)]:
        win = np.asarray(win)
        np.testing.assert_array_equal(tsp.stft_dual_window(win, hop),
                                      jsp.stft_dual_window(win, hop))
        mode = "onesided" if np.isrealobj(win) else "twosided"
        np.testing.assert_allclose(
            tsp.stft_dual_window(win, hop),
            ss.ShortTimeFFT(win, hop, fs=1.0, fft_mode=mode).dual_win,
            atol=1e-12)
        for desired in (None, np.roll(np.abs(win), 3) + 0.1):
            for scaled in (True, False):
                d1, a1 = tsp.closest_STFT_dual_window(win, hop, desired,
                                                      scaled=scaled)
                d2, a2 = ss.closest_STFT_dual_window(win, hop, desired,
                                                     scaled=scaled)
                np.testing.assert_allclose(d1, d2, atol=1e-12)
                np.testing.assert_allclose(a1, a2, atol=1e-12)
    with pytest.raises(ValueError):
        tsp.stft_dual_window(np.ones(8), 9)
    with pytest.raises(ValueError):
        tsp.closest_STFT_dual_window(np.hanning(32), 8.5)
    with pytest.raises(ValueError):
        tsp.stft_dual_window(np.ones(8) * np.r_[1, 0, 0, 0, 0, 0, 0, 0], 4)
