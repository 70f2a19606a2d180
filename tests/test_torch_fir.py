"""The port's FIR design and polyphase resampling against the JAX package.

Designs are NumPy in both packages (the port carries the files verbatim),
so taps and windows must be equal bit for bit.  The streaming resamplers
run in float64 on the CPU against the JAX package's (XLA on the CPU) and
``scipy.signal.upfirdn``; tolerance 1e-12 (float64 sums of at most a few
hundred terms in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sig
import torch

from simpledsp_tpu.design import fir as jfir
from simpledsp_tpu.design import optimal_fir as jopt
from simpledsp_tpu.design import windows as jwin
from simpledsp_tpu.ops import fir as jops
from simpledsp_tpu_torch.design import fir as tfir
from simpledsp_tpu_torch.design import optimal_fir as topt
from simpledsp_tpu_torch.design import windows as twin
from simpledsp_tpu_torch.ops import fir as tops

DESIGNS = [
    ("kaiser_beta", (60.0,), {}),
    ("kaiser_beta", (30.0,), {}),
    ("lowpass_taps", (64, 0.1), {"fs": 1.0}),
    ("lowpass_taps", (101, 0.2), {"fs": 1.0, "atten_db": 60.0}),
    ("lowpass_taps", (33, 3000.0), {"fs": 48000.0, "window": "hamming"}),
    ("pfb_prototype_taps", (16, 16), {}),
    ("pfb_prototype_taps", (8, 32), {"design": "kaiser"}),
    ("pfb_prototype_taps", (16, 16), {"design": "remez"}),
    ("resampler_taps", (3, 2), {}),
    ("resampler_taps", (1, 4), {"taps_per_phase": 16}),
    ("highpass_taps", (65, 0.3), {}),
    ("bandpass_taps", (65, 0.2, 0.5), {}),
]


@pytest.mark.parametrize("name,args,kw", DESIGNS,
                         ids=[f"{d[0]}-{i}" for i, d in enumerate(DESIGNS)])
def test_fir_designs_equal_jax_bitwise(name, args, kw):
    ours = np.asarray(getattr(tfir, name)(*args, **kw))
    theirs = np.asarray(getattr(jfir, name)(*args, **kw))
    np.testing.assert_array_equal(ours, theirs)


REMEZ = [
    (64, [0.0, 0.35 / 4, 0.5 / 4, 0.5], [1.0, 0.0], {"weight": [1.0, 10.0]}),
    (31, [0.0, 0.1, 0.2, 0.5], [1.0, 0.0], {}),
    (40, [0.0, 0.1, 0.15, 0.3, 0.35, 0.5], [0.0, 1.0, 0.0], {}),
]


@pytest.mark.parametrize("n,bands,desired,kw", REMEZ)
def test_remez_equals_jax_bitwise(n, bands, desired, kw):
    np.testing.assert_array_equal(topt.remez(n, bands, desired, **kw),
                                  jopt.remez(n, bands, desired, **kw))


WINDOWS = ["hann", "hamming", "blackman", ("kaiser", 8.6), ("tukey", 0.3),
           ("chebwin", 70), ("gaussian", 7.0), 5.0, "flattop", ("dpss", 3.0)]


@pytest.mark.parametrize("spec", WINDOWS, ids=[str(w) for w in WINDOWS])
@pytest.mark.parametrize("fftbins", [True, False])
def test_windows_equal_jax_bitwise(spec, fftbins):
    np.testing.assert_array_equal(twin.get_window(spec, 51, fftbins=fftbins),
                                  jwin.get_window(spec, 51, fftbins=fftbins))


CASES = [(1, 1, 31), (1, 4, 64), (3, 1, 24), (3, 2, 24), (2, 3, 40)]


@pytest.mark.parametrize("up,down,ntaps", CASES)
def test_resampler_matches_jax_and_upfirdn(up, down, ntaps, rng):
    h = rng.standard_normal(ntaps)
    x = rng.standard_normal((2, 3, 60 * down))
    y, st = tops.PolyphaseResampler(h, up, down, dtype=torch.float64,
                                    device="cpu")(
        torch.as_tensor(x))
    jy, jst = jops.PolyphaseResampler(h, up, down, dtype=jnp.float64)(
        jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=1e-12)
    np.testing.assert_allclose(st.hist.numpy(), np.asarray(jst.hist), rtol=0,
                               atol=0)
    ref = sig.upfirdn(h, x, up, down)[..., : y.shape[-1]]
    np.testing.assert_allclose(y.numpy(), ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("cls,arg", [(tops.PolyphaseDecimator, 4),
                                     (tops.PolyphaseInterpolator, 3),
                                     (tops.FIRFilter, None)])
def test_wrappers_match_jax(cls, arg, rng):
    h = tfir.lowpass_taps(48, 0.1, fs=1.0)
    jcls = getattr(jops, cls.__name__)
    args = (h,) if arg is None else (h, arg)
    x = rng.standard_normal((4, 96))
    ours, _ = cls(*args, dtype=torch.float64, device="cpu")(
        torch.as_tensor(x))
    theirs, _ = jcls(*args, dtype=jnp.float64)(jnp.asarray(x))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("up,down", [(1, 4), (3, 2), (2, 1)])
def test_blockwise_equals_whole(up, down, rng):
    """Streaming at multiples of ``down`` equals one call (1e-12)."""
    h = rng.standard_normal(37)
    x = torch.as_tensor(rng.standard_normal((2, 48 * down)))
    rs = tops.PolyphaseResampler(h, up, down, dtype=torch.float64,
                                 device="cpu")
    whole, _ = rs(x)
    parts, st = [], None
    for lo, hi in ((0, 5 * down), (5 * down, 30 * down), (30 * down, 48 * down)):
        y, st = rs(x[:, lo:hi], st)
        parts.append(y)
    np.testing.assert_allclose(torch.cat(parts, -1).numpy(), whole.numpy(),
                               rtol=0, atol=1e-12)


def test_rejects_bad_arguments():
    with pytest.raises(ValueError, match="up/down"):
        tops.PolyphaseResampler(np.ones(4), 0, 1, device="cpu")
    with pytest.raises(ValueError, match="1-D"):
        tops.PolyphaseResampler(np.ones((2, 2)), device="cpu")
    with pytest.raises(ValueError, match="multiple of down"):
        tops.PolyphaseDecimator(np.ones(8), 4, device="cpu")(
            torch.zeros(1, 10))


# -- the one-shot whole-signal functions ------------------------------------------
# Each against the JAX package (1e-12 absolute on outputs of order 1) and
# scipy (the JAX tests' tolerances).

def _t(x):
    return torch.as_tensor(x, dtype=torch.float64)


@pytest.mark.parametrize("up,down,n,m", [(1, 1, 50, 7), (3, 1, 40, 12),
                                         (1, 4, 101, 17), (3, 2, 64, 31),
                                         (5, 7, 33, 40)])
def test_upfirdn_matches_jax_and_scipy(rng, up, down, n, m):
    h = rng.standard_normal(m)
    x = rng.standard_normal((2, n))
    got = tops.upfirdn(h, _t(x), up, down).numpy()
    want = np.asarray(jops.upfirdn(h, jnp.asarray(x), up, down))
    ref = np.stack([sig.upfirdn(h, r, up=up, down=down) for r in x])
    assert got.shape == ref.shape == want.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    with pytest.raises(ValueError):
        tops.upfirdn(h, _t(x), 0, 1)


@pytest.mark.parametrize("n,num", [(100, 50), (100, 51), (100, 200),
                                   (100, 201), (99, 50), (99, 200),
                                   (100, 64), (128, 100), (100, 100)])
def test_resample_matches_jax_and_scipy(rng, n, num):
    x = rng.standard_normal((3, n))
    got = tops.resample(_t(x), num).numpy()
    want = np.asarray(jops.resample(jnp.asarray(x), num))
    ref = sig.resample(x, num, axis=-1)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_resample_rejects_complex_and_bad_num():
    with pytest.raises(ValueError):
        tops.resample(torch.ones(8, dtype=torch.complex128), 4)
    with pytest.raises(ValueError):
        tops.resample(torch.ones(8, dtype=torch.float64), 0)


@pytest.mark.parametrize("zero_phase", [True, False])
@pytest.mark.parametrize("ftype", ["iir", "fir"])
@pytest.mark.parametrize("q", [2, 4, 13])
def test_decimate_matches_jax_and_scipy(rng, q, ftype, zero_phase):
    x = rng.standard_normal((2, 1000))
    got = tops.decimate(_t(x), q, ftype=ftype, zero_phase=zero_phase).numpy()
    want = np.asarray(jops.decimate(jnp.asarray(x), q, ftype=ftype,
                                    zero_phase=zero_phase))
    ref = sig.decimate(x, q, ftype=ftype, zero_phase=zero_phase, axis=-1)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_decimate_long_signal_takes_the_block_and_overlap_save_routes(rng):
    """T = 8192: the cascade runs on BlockIIR, and the 161-tap FIR of q = 8
    takes convolve's overlap-save route (n >= 4 m, n + m - 1 >= 8192)."""
    x = rng.standard_normal((2, 8192))
    for ftype in ("iir", "fir"):
        got = tops.decimate(_t(x), 8, ftype=ftype).numpy()
        ref = sig.decimate(x, 8, ftype=ftype, axis=-1)
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-11)


def test_decimate_rejects_bad_args(rng):
    x = _t(rng.standard_normal(100))
    for kw in ({"q": 0}, {"q": 2, "n": 7, "ftype": "iir"},
               {"q": 2, "ftype": "cic"}):
        with pytest.raises(ValueError):
            tops.decimate(x, **kw)


@pytest.mark.parametrize("t", [1000, 997])
@pytest.mark.parametrize("up,down", [(2, 1), (1, 3), (3, 2), (7, 5),
                                     (160, 441)])
def test_resample_poly_matches_jax_and_scipy(rng, up, down, t):
    x = rng.standard_normal((2, t)) + 2.0
    got = tops.resample_poly(_t(x), up, down).numpy()
    want = np.asarray(jops.resample_poly(jnp.asarray(x), up, down))
    ref = sig.resample_poly(x, up, down, axis=-1)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("t", [800, 801])
@pytest.mark.parametrize("padtype", ["constant", "mean", "median", "minimum",
                                     "maximum"])
def test_resample_poly_padtypes(rng, padtype, t):
    """Every padtype; t = 800 is the even length whose median is the mean
    of the two middle values (numpy's), not torch.median's lower one."""
    x = rng.standard_normal((2, t)) + 3.0
    got = tops.resample_poly(_t(x), 3, 2, padtype=padtype).numpy()
    want = np.asarray(jops.resample_poly(jnp.asarray(x), 3, 2,
                                         padtype=padtype))
    ref = sig.resample_poly(x, 3, 2, padtype=padtype, axis=-1)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_resample_poly_median_of_an_even_length():
    x = _t([[1.0, 4.0, 2.0, 10.0]])
    np.testing.assert_array_equal(tops._median(x).numpy(), [[3.0]])
    np.testing.assert_array_equal(tops._median(x[:, :3]).numpy(), [[2.0]])


@pytest.mark.parametrize("window", ["hamming", ("kaiser", 8.0), "taps",
                                    "list"])
def test_resample_poly_window_spec_and_taps(rng, window):
    x = rng.standard_normal(800) + 3.0
    if window == "taps":
        window = sig.firwin(31, 0.4)
    elif window == "list":
        window = list(sig.firwin(21, 0.3))
    got = tops.resample_poly(_t(x), 2, 3, window=window).numpy()
    want = np.asarray(jops.resample_poly(jnp.asarray(x), 2, 3,
                                         window=window))
    ref = sig.resample_poly(x, 2, 3, window=window)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_resample_poly_identity_and_errors(rng):
    x = _t(rng.standard_normal(64))
    assert tops.resample_poly(x, 3, 3) is x
    with pytest.raises(ValueError):
        tops.resample_poly(x, 2, 3, padtype="wrap")
    with pytest.raises(ValueError):
        tops.resample_poly(x, 2, 3, window=np.ones((3, 3)))
    with pytest.raises(ValueError):
        tops.resample_poly(x, 0, 3)
