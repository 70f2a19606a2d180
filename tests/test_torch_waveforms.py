"""The PyTorch port's waveform generators (simpledsp_tpu_torch.ops.waveforms)
against scipy and the JAX package, on the CPU (the port of
tests/test_waveforms.py).

Inputs are made with numpy and handed to both packages.  Tolerances: the
elementwise generators agree with scipy to 1e-9 (the JAX tests' bar) and
with the JAX package in float64 to 1e-12 absolute (outputs of order 1);
``square`` equals both except at switching instants, where the phase sits
on a float boundary (under 0.2 % of the samples, as in the JAX tests).
``max_len_seq`` gives the JAX package's bits, sequence and state, at every
default register length 2-24 over the full period and streamed in pieces;
``unit_impulse`` equals scipy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sig
import torch

from simpledsp_tpu.ops import waveforms as jw
from simpledsp_tpu_torch.ops import waveforms as tw
from simpledsp_tpu_torch.ops.waveforms import (chirp, gausspulse, max_len_seq,
                                               sawtooth, square, sweep_poly,
                                               unit_impulse)

TOL = 1e-12
CPU = {"device": "cpu"}


@pytest.fixture
def t():
    return np.linspace(0.0, 3.0, 4001)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


# -- the JAX package's tests, on the port --------------------------------------

@pytest.mark.parametrize("method", ["linear", "quadratic", "logarithmic",
                                    "hyperbolic"])
def test_chirp_matches_scipy(t, method):
    got = _np(chirp(torch.from_numpy(t), 5.0, 2.0, 40.0, method=method,
                    phi=30.0))
    want = sig.chirp(t, 5.0, 2.0, 40.0, method=method, phi=30.0)
    np.testing.assert_allclose(got, want, atol=1e-9)


def test_chirp_equal_freqs_and_errors(t):
    tt = torch.from_numpy(t)
    for method in ("logarithmic", "hyperbolic"):
        got = _np(chirp(tt, 7.0, 2.0, 7.0, method=method))
        np.testing.assert_allclose(got, sig.chirp(t, 7.0, 2.0, 7.0,
                                                  method=method), atol=1e-9)
    with pytest.raises(ValueError):
        chirp(tt, -5.0, 2.0, 40.0, method="logarithmic")
    with pytest.raises(ValueError):
        chirp(tt, 0.0, 2.0, 40.0, method="hyperbolic")
    with pytest.raises(ValueError):
        chirp(tt, 5.0, 2.0, 40.0, method="cubic")


@pytest.mark.parametrize("duty", [0.5, 0.25, 0.9])
def test_square_matches_scipy(t, duty):
    w = 2 * np.pi * 3.0 * t
    got = _np(square(torch.from_numpy(w), duty))
    want = sig.square(w, duty)
    # Avoid the exact switching instants (float-boundary sensitive).
    mask = np.abs(got - want) > 0
    assert mask.mean() < 0.002
    np.testing.assert_allclose(got[~mask], want[~mask])


@pytest.mark.parametrize("width", [1.0, 0.5, 0.0, 0.3])
def test_sawtooth_matches_scipy(t, width):
    w = 2 * np.pi * 3.0 * t
    got = _np(sawtooth(torch.from_numpy(w), width))
    np.testing.assert_allclose(got, sig.sawtooth(w, width), atol=1e-9)


def test_sawtooth_rejects_bad_width(t):
    with pytest.raises(ValueError):
        sawtooth(torch.from_numpy(t), 1.5)


def test_gausspulse_matches_scipy():
    t = np.linspace(-0.01, 0.01, 2001)
    tt = torch.from_numpy(t)
    got = _np(gausspulse(tt, fc=1500.0, bw=0.6))
    np.testing.assert_allclose(got, sig.gausspulse(t, fc=1500.0, bw=0.6),
                               atol=1e-9)
    gi, gq = gausspulse(tt, fc=1500.0, bw=0.6, quadrature=True)
    wi, wq = sig.gausspulse(t, fc=1500.0, bw=0.6, retquad=True)
    np.testing.assert_allclose(_np(gi), wi, atol=1e-9)
    np.testing.assert_allclose(_np(gq), wq, atol=1e-9)
    for kwargs in ({"fc": -1.0}, {"bw": 0.0}, {"bwr": 3.0}):
        with pytest.raises(ValueError):
            gausspulse(tt, **kwargs)


def test_unit_impulse_matches_scipy():
    np.testing.assert_array_equal(_np(unit_impulse(7, **CPU)),
                                  sig.unit_impulse(7))
    np.testing.assert_array_equal(_np(unit_impulse(7, "mid", **CPU)),
                                  sig.unit_impulse(7, "mid"))
    np.testing.assert_array_equal(_np(unit_impulse((3, 4), 2, **CPU)),
                                  sig.unit_impulse((3, 4), 2))
    np.testing.assert_array_equal(_np(unit_impulse((3, 4), (1, 3), **CPU)),
                                  sig.unit_impulse((3, 4), (1, 3)))


def test_sweep_poly_matches_scipy(t):
    p = np.poly1d([0.05, -0.75, 2.0, 1.0])
    got = _np(sweep_poly(torch.from_numpy(t), p, phi=25.0))
    np.testing.assert_allclose(got, sig.sweep_poly(t, p, phi=25.0),
                               atol=1e-10)
    # plain list form
    got2 = _np(sweep_poly(torch.from_numpy(t), [1.0, 2.0]))
    np.testing.assert_allclose(got2, sig.sweep_poly(t, np.poly1d([1.0, 2.0])),
                               atol=1e-10)


@pytest.mark.parametrize("nbits", [4, 8, 12])
def test_max_len_seq_matches_scipy(nbits):
    ours, st = max_len_seq(nbits, **CPU)
    ref, rst = sig.max_len_seq(nbits)
    np.testing.assert_array_equal(_np(ours), ref)
    np.testing.assert_array_equal(st, rst)


def test_max_len_seq_streaming_and_flat_spectrum():
    a1, s1 = max_len_seq(8, length=100, **CPU)
    a2, _ = max_len_seq(8, state=s1, length=155, **CPU)
    full, _ = max_len_seq(8, **CPU)
    np.testing.assert_array_equal(np.concatenate([_np(a1), _np(a2)]),
                                  _np(full))
    # The defining MLS property: +-1 sequence has a flat spectrum.
    bip = 2.0 * _np(full).astype(np.float64) - 1.0
    mag = np.abs(np.fft.fft(bip))[1:]
    np.testing.assert_allclose(mag, np.full(mag.shape, mag[0]), rtol=1e-9)
    with pytest.raises(ValueError):
        max_len_seq(64, **CPU)                       # no default taps
    with pytest.raises(ValueError):
        max_len_seq(8, state=np.zeros(8), **CPU)     # all-zero state


# -- against the JAX package ---------------------------------------------------

@pytest.mark.parametrize("method", ["linear", "quadratic", "logarithmic",
                                    "hyperbolic"])
@pytest.mark.parametrize("f1", [40.0, 5.0])
def test_chirp_matches_jax(t, method, f1):
    want = np.asarray(jw.chirp(jnp.asarray(t), 5.0, 2.0, f1, method=method,
                               phi=-12.0))
    got = chirp(torch.from_numpy(t), 5.0, 2.0, f1, method=method, phi=-12.0)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("duty", [0.1, 0.5, 0.75])
def test_square_and_sawtooth_match_jax(t, duty):
    w = 2 * np.pi * 2.7 * t - 4.0
    got = _np(square(torch.from_numpy(w), duty))
    want = np.asarray(jw.square(jnp.asarray(w), duty))
    assert (got != want).mean() < 0.002
    np.testing.assert_allclose(_np(sawtooth(torch.from_numpy(w), duty)),
                               np.asarray(jw.sawtooth(jnp.asarray(w), duty)),
                               rtol=0, atol=TOL)


def test_generators_batch_and_keep_dtype(rng):
    """A (3, 500) time base in float32 and float64: the shape and dtype of
    the input come back, as in the JAX package."""
    t = rng.uniform(-1.0, 1.0, (3, 500))
    for dtype in (torch.float32, torch.float64):
        tt = torch.from_numpy(t).to(dtype)
        for out in (chirp(tt, 2.0, 1.0, 9.0), square(tt * 10),
                    sawtooth(tt * 10, 0.4), gausspulse(tt, fc=5.0),
                    sweep_poly(tt, [1.0, -2.0, 0.5])):
            assert out.shape == (3, 500) and out.dtype == dtype
    want = np.asarray(jw.gausspulse(jnp.asarray(t), fc=5.0, bw=0.3,
                                    quadrature=True))
    got = gausspulse(torch.from_numpy(t), fc=5.0, bw=0.3, quadrature=True)
    np.testing.assert_allclose(np.stack([_np(g) for g in got]), want,
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(
        _np(sweep_poly(torch.from_numpy(t), [0.3, -1.0, 2.0, 1.0], 40.0)),
        np.asarray(jw.sweep_poly(jnp.asarray(t), [0.3, -1.0, 2.0, 1.0],
                                 40.0)), rtol=0, atol=TOL)


def test_square_of_an_integer_time_base_is_float32():
    got = square(torch.arange(20))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_np(got), sig.square(np.arange(20)))


@pytest.mark.parametrize("nbits", range(2, 25))
def test_max_len_seq_full_period_matches_jax(nbits):
    """Every default register length, the full period: the JAX package's
    sequence and final state, bit for bit."""
    ours, st = max_len_seq(nbits, **CPU)
    ref, rst = jw.max_len_seq(nbits)
    assert ours.dtype == torch.int8 and ours.numel() == (1 << nbits) - 1
    np.testing.assert_array_equal(_np(ours), np.asarray(ref))
    np.testing.assert_array_equal(st, rst)
    assert st.dtype == np.int8


@pytest.mark.parametrize("nbits,pieces", [(7, (1, 5, 40, 81)),
                                          (16, (3, 9000, 7, 56525)),
                                          (20, (524288, 524287))])
def test_max_len_seq_streams_like_jax(nbits, pieces):
    """A stream cut in pieces, each continued from the last state (shorter
    than the register too): the full period, and JAX's states."""
    st = jst = None
    parts = []
    for n in pieces:
        seq, st = max_len_seq(nbits, state=st, length=n, **CPU)
        ref, jst = jw.max_len_seq(nbits, state=jst, length=n)
        np.testing.assert_array_equal(_np(seq), np.asarray(ref))
        np.testing.assert_array_equal(st, jst)
        parts.append(_np(seq))
    np.testing.assert_array_equal(np.concatenate(parts),
                                  np.asarray(jw.max_len_seq(nbits)[0]))


@pytest.mark.parametrize("nbits,taps,length", [(40, [38, 21, 19], 5000),
                                               (64, [63, 61, 60], 3000),
                                               (70, [69, 68], 300),
                                               (9, [5], 0)])
def test_max_len_seq_explicit_taps_match_jax(nbits, taps, length):
    """Registers past the defaults: the native library up to 64 bits, the
    Python loop beyond, as in the JAX package; and a zero length."""
    rng = np.random.default_rng(nbits)
    state = rng.integers(0, 2, nbits)
    state[0] = 1
    ours, st = max_len_seq(nbits, state=state, length=length, taps=taps,
                           **CPU)
    ref, rst = jw.max_len_seq(nbits, state=state, length=length, taps=taps)
    np.testing.assert_array_equal(_np(ours), np.asarray(ref))
    np.testing.assert_array_equal(st, rst)


def test_max_len_seq_takes_a_tensor_state():
    _, st = max_len_seq(10, length=77, **CPU)
    a, sa = max_len_seq(10, state=torch.from_numpy(st), length=50, **CPU)
    b, sb = max_len_seq(10, state=st, length=50, **CPU)
    np.testing.assert_array_equal(_np(a), _np(b))
    np.testing.assert_array_equal(sa, sb)
    with pytest.raises(ValueError):
        max_len_seq(10, state=np.ones(9), **CPU)
    with pytest.raises(ValueError):
        max_len_seq(10, taps=[10], **CPU)


def test_max_len_seq_raises_where_the_native_library_fails(monkeypatch):
    """No quiet fallback: a failed build of the native library raises for
    a register the library serves."""
    from simpledsp_tpu_torch.runtime import stream

    def broken():
        raise RuntimeError("g++ failed")

    monkeypatch.setattr(stream, "load_library", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        max_len_seq(8, **CPU)


def test_unit_impulse_dtype_and_device():
    got = unit_impulse((2, 5), "mid", dtype=torch.float64, **CPU)
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    np.testing.assert_array_equal(_np(got), np.asarray(
        jw.unit_impulse((2, 5), "mid", dtype=jnp.float64)))


@pytest.mark.parametrize("make", [lambda: tw.unit_impulse(8),
                                  lambda: tw.max_len_seq(6)])
def test_tensor_makers_default_to_cuda(make):
    """unit_impulse and max_len_seq make a tensor from no tensor: they go
    to CUDA by default and raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        make()
