"""The port's overlap-save convolution (kernels/ols plain version,
ops/fir.OverlapSaveFIR and fir_filter) against the JAX package, in float64
on the CPU.

The JAX kernel runs in Pallas interpret mode, as its own tests run it.
Tolerance: 1e-12 relative to the largest output magnitude (float64 rounding
of four-step sums in a different order); the tables are equal bit for bit
(the same float64 host code); streaming is exact (equal bits).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sig
import torch

from simpledsp_tpu.kernels import ols as jols
from simpledsp_tpu.ops import fir as jfir
from simpledsp_tpu_torch import convert
from simpledsp_tpu_torch.kernels import ols as tols
from simpledsp_tpu_torch.ops import fir as tfir

TOL = 1e-12


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("nfft", [256, 1000, 1024, 4096, 8192, 16384])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_ols_consts_equal_jax_bitwise(nfft, dtype, rng):
    taps = rng.standard_normal(37)
    got = tols._ols_consts(nfft, taps.tobytes(), taps.size, dtype)
    want = jols._ols_consts(nfft, taps.tobytes(), taps.size, dtype)
    assert got[:2] == want[:2]
    for a, b in zip(got[2:], want[2:]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [64, 1000, 4096, 16384, 32768, 65536])
def test_ols_supported_matches_jax(n):
    assert tols.ols_supported(n) == jols.ols_supported(n)


@pytest.mark.parametrize("t,m,nfft", [(65536, 301, 4096), (10000, 301, 4096),
                                      (8192, 129, 1024), (4096, 257, 2048)])
def test_convolve_ols_fused_matches_jax(t, m, nfft, rng):
    x = rng.standard_normal((2, t))
    h = rng.standard_normal(m)
    y = tols.convolve_ols_fused(torch.as_tensor(x), h, nfft=nfft).numpy()
    want = np.asarray(jols.convolve_ols_fused(jnp.asarray(x), h, nfft=nfft,
                                              interpret=True))
    _close(y, want)
    _close(y, np.stack([np.convolve(r, h) for r in x]))


@pytest.mark.parametrize("nfft,m,o1", [(1024, 129, 2), (2048, 257, 3),
                                       (4096, 301, 3)])
def test_conv_ols_frames_matches_jax(nfft, m, o1, rng):
    frames = rng.standard_normal((6, nfft))
    h = rng.standard_normal(m)
    y = tols.conv_ols_frames(torch.as_tensor(frames), h, overlap_rows=o1)
    want = jols.conv_ols_frames(jnp.asarray(frames), h, overlap_rows=o1,
                                interpret=True)
    _close(y.numpy(), want)
    # A (B, F, nfft) batch gives the same rows.
    yb = tols.conv_ols_frames(torch.as_tensor(frames.reshape(2, 3, nfft)), h,
                              overlap_rows=o1)
    _close(yb.reshape(6, -1).numpy(), want)


def test_single_tap_identity(rng):
    x = rng.standard_normal(5000)
    y = tols.convolve_ols_fused(torch.as_tensor(x), np.array([2.5]), nfft=512)
    want = jols.convolve_ols_fused(jnp.asarray(x), np.array([2.5]), nfft=512,
                                   interpret=True)
    _close(y.numpy(), want)
    np.testing.assert_allclose(y.numpy(), 2.5 * x, atol=1e-12)


def test_leading_batch_axes(rng):
    x = rng.standard_normal((2, 3, 4096))
    h = rng.standard_normal(65)
    y = tols.convolve_ols_fused(torch.as_tensor(x), h, nfft=1024)
    assert y.shape == (2, 3, 4096 + 64)
    want = jols.convolve_ols_fused(jnp.asarray(x), h, nfft=1024, interpret=True)
    _close(y.numpy(), want)


def test_validation_matches_jax(rng):
    frames = rng.standard_normal((4, 1024))
    for mod, arr in ((tols, torch.as_tensor(frames)),
                     (jols, jnp.asarray(frames))):
        kw = {} if mod is tols else {"interpret": True}
        with pytest.raises(ValueError, match="overlap 1\\*128 < taps-1"):
            mod.conv_ols_frames(arr, np.ones(300), overlap_rows=1, **kw)
        with pytest.raises(ValueError, match="leave no output"):
            mod.conv_ols_frames(arr, np.ones(3), overlap_rows=8, **kw)
    x = rng.standard_normal(4096)
    with pytest.raises(ValueError, match="too long"):
        tols.convolve_ols_fused(torch.as_tensor(x), np.ones(1100), nfft=1024)
    with pytest.raises(ValueError, match="not supported"):
        tols.conv_ols_frames(torch.zeros(2, 131 * 131, dtype=torch.float64),
                             np.ones(3), overlap_rows=1)


def test_plain_version_in_float32_is_near_float64(rng):
    """The float32 plain version (IEEE products) holds about 130 dB against
    the float64 one: the bar the kernel is held to on the card is 100 dB."""
    frames = rng.standard_normal((8, 4096))
    h = rng.standard_normal(301)
    ref = tols.conv_ols_frames(torch.as_tensor(frames), h, overlap_rows=3)
    got = tols.conv_ols_frames(torch.as_tensor(frames, dtype=torch.float32),
                               h, overlap_rows=3)
    snr = 10 * np.log10((ref.numpy() ** 2).sum()
                        / ((got.double() - ref).numpy() ** 2).sum())
    assert got.dtype == torch.float32 and snr >= 120.0


@pytest.mark.parametrize("m,block", [(129, 256), (301, 1024), (40, 64)])
def test_overlap_save_fir_matches_jax_chained(m, block, rng):
    """Three chained blocks against the JAX filter chained the same way
    (1e-12) and against one call over all three (equal bits)."""
    h = rng.standard_normal(m)
    x = rng.standard_normal((2, 3, 6 * block))
    ours = tfir.OverlapSaveFIR(h, block_size=block, dtype=torch.float64,
                               device="cpu")
    theirs = jfir.OverlapSaveFIR(h, block_size=block, dtype=jnp.float64)
    assert ours.nfft == theirs.nfft
    st = jst = None
    parts = []
    for lo, hi in ((0, block), (block, 4 * block), (4 * block, 6 * block)):
        y, st = ours(torch.as_tensor(x[..., lo:hi]), st)
        jy, jst = theirs(jnp.asarray(x[..., lo:hi]), jst)
        _close(y.numpy(), jy)
        np.testing.assert_array_equal(st.hist.numpy(), np.asarray(jst.hist))
        parts.append(y)
    whole, _ = ours(torch.as_tensor(x))
    assert torch.equal(torch.cat(parts, -1), whole)
    _close(whole.numpy(), sig.lfilter(h, 1.0, x, axis=-1))


def test_overlap_save_fir_rejects_ragged_block():
    with pytest.raises(ValueError, match="multiple of 256"):
        tfir.OverlapSaveFIR(np.ones(9), block_size=256, device="cpu")(
            torch.zeros(1, 300))


@pytest.mark.parametrize("method,m,t", [("auto", 129, 2048), ("auto", 33, 2048),
                                        ("auto", 129, 2000), ("fft", 33, 1024),
                                        ("direct", 129, 1024)])
def test_fir_filter_matches_jax(method, m, t, rng):
    h = rng.standard_normal(m)
    x = rng.standard_normal((3, t))
    y, st = tfir.fir_filter(h, torch.as_tensor(x), method=method,
                            block_size=512)
    jy, jst = jfir.fir_filter(h, jnp.asarray(x), method=method,
                              block_size=512)
    _close(y.numpy(), jy)
    np.testing.assert_array_equal(st.hist.numpy(), np.asarray(jst.hist))
    with pytest.raises(ValueError, match="unknown method"):
        tfir.fir_filter(h, torch.as_tensor(x), method="fast")


def test_state_carried_from_jax_continues_the_jax_stream(rng):
    """An OverlapSaveFIR restarted from the JAX filter's state, carried
    across with convert.fir_state_from_numpy, continues as the JAX one."""
    h = rng.standard_normal(200)
    x = rng.standard_normal((2, 4 * 512))
    jols_fir = jfir.OverlapSaveFIR(h, block_size=512, dtype=jnp.float64)
    _, jst = jols_fir(jnp.asarray(x[:, :1024]))
    jy, jst2 = jols_fir(jnp.asarray(x[:, 1024:]), jst)
    st = convert.fir_state_from_numpy(np.asarray(jst.hist),
                                      dtype=torch.float64)
    y, st2 = tfir.OverlapSaveFIR(h, block_size=512, dtype=torch.float64,
                                  device="cpu")(
        torch.as_tensor(x[:, 1024:]), st)
    _close(y.numpy(), jy)
    back = convert.fir_state_to_numpy(st2)
    assert isinstance(back, np.ndarray)
    np.testing.assert_array_equal(back, np.asarray(jst2.hist))
