"""The PyTorch port's IIR (simpledsp_tpu_torch.ops.iir) against the JAX
package and scipy, in float64 on the CPU.

Inputs are made with numpy from a seed and handed to both packages;
coefficients and state cross through ``simpledsp_tpu_torch.convert``.
Tolerances: host-built tables are bitwise equal (same float64 code); filter
outputs agree to 1e-12 absolute (float64 rounding of block sums over at most
256 terms, outputs of order 1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sig
import torch

from simpledsp_tpu.design import biquad as jbq
from simpledsp_tpu.ops import iir as jiir
from simpledsp_tpu_torch.convert import (design_from_numpy, state_from_numpy,
                                         state_to_numpy)
from simpledsp_tpu_torch.design import biquad as tbq
from simpledsp_tpu_torch.ops import iir as tiir

TOL = 1e-12

DESIGNS = {
    "lowpass": lambda m: m.design_lowpass(4, 2000.0, 39000.0),
    "highpass": lambda m: m.design_highpass(3, 5000.0, 39000.0, gain=2.0),
    "bandpass": lambda m: m.design_bandpass(4, 6000.0, 39000.0, 3.0),
}


def _designs(name):
    """(JAX design, port design carried across through convert)."""
    jd = DESIGNS[name](jbq)
    td = design_from_numpy(jd.b, jd.a, jd.gain, jd.ftype, jd.f0, jd.fs, jd.q)
    return jd, td


def _warm_state(jd, rng, c=2):
    """A realistic nonzero state: the JAX filter's state after noise."""
    _, st = jiir.sosfilt(jd, jnp.asarray(rng.standard_normal((c, 777))),
                         method="scan")
    return np.asarray(st.y_hist)


@pytest.mark.parametrize("name", sorted(DESIGNS))
def test_port_design_equals_jax_and_convert(name):
    jd, td = _designs(name)
    own = DESIGNS[name](tbq)
    for d in (td, own):
        np.testing.assert_array_equal(d.b, jd.b)
        np.testing.assert_array_equal(d.a, jd.a)
        assert d.gain == jd.gain and int(d.ftype) == int(jd.ftype)
        np.testing.assert_array_equal(tbq.sos_matrix(d), jbq.sos_matrix(jd))
    assert own.dc_gain() == pytest.approx(jd.dc_gain(), rel=1e-15)


@pytest.mark.parametrize("block_size", [32, 128, 256])
@pytest.mark.parametrize("name", sorted(DESIGNS))
def test_block_operators_f64_bitwise(name, block_size):
    jd, td = _designs(name)
    for got, want in zip(tiir.block_operators_f64(td, block_size),
                         jiir.block_operators_f64(jd, block_size)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(DESIGNS))
def test_block_iir_matches_jax_and_scipy(name, rng):
    jd, td = _designs(name)
    x = rng.standard_normal((2, 4096))
    # Cold start against scipy.
    y, _ = tiir.BlockIIR(td, 256, dtype=torch.float64, device="cpu")(
        torch.as_tensor(x))
    ref = sig.sosfilt(jbq.sos_matrix(jd), x, axis=-1)
    np.testing.assert_allclose(y.numpy(), ref, rtol=0, atol=TOL)
    # Warm start against JAX, state crossing through convert.
    s0 = _warm_state(jd, rng)
    y_t, st_t = tiir.BlockIIR(td, 256, dtype=torch.float64, device="cpu")(
        torch.as_tensor(x), state_from_numpy(s0, dtype=torch.float64))
    y_j, st_j = jiir.BlockIIR(jd, 256, dtype=jnp.float64)(
        jnp.asarray(x), jiir.IIRState(jnp.asarray(s0)))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=0, atol=TOL)
    np.testing.assert_allclose(state_to_numpy(st_t), np.asarray(st_j.y_hist),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("name", sorted(DESIGNS))
def test_sosfilt_scan_matches_jax_and_scipy(name, rng):
    jd, td = _designs(name)
    x = rng.standard_normal((2, 4096))
    coeffs = tiir.coeffs_from_design(td, dtype=torch.float64)
    y, _ = tiir.sosfilt_scan(coeffs, torch.as_tensor(x),
                             tiir.iir_init(td.nsections, (2,), torch.float64))
    np.testing.assert_allclose(y.numpy(),
                               sig.sosfilt(jbq.sos_matrix(jd), x, axis=-1),
                               rtol=0, atol=TOL)
    s0 = _warm_state(jd, rng)
    y_t, st_t = tiir.sosfilt_scan(coeffs, torch.as_tensor(x),
                                  state_from_numpy(s0, dtype=torch.float64))
    y_j, st_j = jiir.sosfilt_scan(jiir.coeffs_from_design(jd, jnp.float64),
                                  jnp.asarray(x), jiir.IIRState(jnp.asarray(s0)))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=0, atol=TOL)
    np.testing.assert_allclose(state_to_numpy(st_t), np.asarray(st_j.y_hist),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("method", ["scan", "block"])
def test_blocks_of_32_equal_whole_signal(method, rng):
    """Filtering 32 samples at a time, state carried, gives the whole-signal
    result: bitwise for the scan oracle (the same operations in the same
    order), to 1e-12 for the block path (its matmuls batch differently)."""
    _, td = _designs("lowpass")
    x = torch.as_tensor(rng.standard_normal((2, 4096)))
    if method == "scan":
        coeffs = tiir.coeffs_from_design(td, dtype=torch.float64)

        def run(seg, st):
            return tiir.sosfilt_scan(coeffs, seg, st)
    else:
        f = tiir.BlockIIR(td, block_size=32, dtype=torch.float64,
                          device="cpu")

        def run(seg, st):
            return f(seg, st)
    st0 = tiir.iir_init(td.nsections, (2,), dtype=torch.float64)
    whole, st_whole = run(x, st0)
    parts, st = [], st0
    for seg in x.split(32, dim=-1):
        y, st = run(seg, st)
        parts.append(y)
    pieces = torch.cat(parts, dim=-1)
    if method == "scan":
        assert torch.equal(pieces, whole) and torch.equal(st.y_hist,
                                                          st_whole.y_hist)
    else:
        np.testing.assert_allclose(pieces.numpy(), whole.numpy(), rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(st.y_hist.numpy(), st_whole.y_hist.numpy(),
                                   rtol=0, atol=TOL)


def test_block_iir_ragged_tail_matches_scan(rng):
    """T not a multiple of block_size: the tail runs through the scan."""
    jd, td = _designs("lowpass")
    x = rng.standard_normal((3, 1000))
    y, st = tiir.BlockIIR(td, 256, dtype=torch.float64, device="cpu")(
        torch.as_tensor(x))
    y_j, st_j = jiir.BlockIIR(jd, 256, dtype=jnp.float64)(jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=0, atol=TOL)
    np.testing.assert_allclose(st.y_hist.numpy(), np.asarray(st_j.y_hist),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("name", sorted(DESIGNS))
def test_iir_preload_matches_jax(name):
    jd, td = _designs(name)
    got = tiir.iir_preload(td, 0.75, (3,), dtype=torch.float64)
    want = jiir.iir_preload(jd, 0.75, (3,), dtype=jnp.float64)
    np.testing.assert_array_equal(state_to_numpy(got), np.asarray(want.y_hist))
    # Steady state: a constant input produces no transient.
    y, _ = tiir.sosfilt(td, torch.full((3, 64), 0.75, dtype=torch.float64), got,
                        method="scan")
    np.testing.assert_allclose(y.numpy(), 0.75 * jd.dc_gain(), rtol=0, atol=TOL)


@pytest.mark.parametrize("method", ["auto", "scan", "block"])
def test_sosfilt_methods_match_jax(method, rng):
    jd, td = _designs("bandpass")
    x = rng.standard_normal((2, 2048))
    y_t, _ = tiir.sosfilt(td, torch.as_tensor(x), method=method, block_size=128)
    y_j, _ = jiir.sosfilt(jd, jnp.asarray(x), method=method, block_size=128)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=0, atol=TOL)


def test_bad_arguments_raise():
    _, td = _designs("lowpass")
    with pytest.raises(ValueError):
        tiir.sosfilt(td, torch.zeros(2, 64), method="fast")
    with pytest.raises(ValueError):
        tiir.BlockIIR(td, block_size=0, device="cpu")
    with pytest.raises(ValueError):
        state_from_numpy(np.zeros((2, 5, 3)))
    with pytest.raises(ValueError):
        tbq.design_lowpass(4, 20000.0, 39000.0)


# -- sosfiltfilt / sosfilt_zi ---------------------------------------------------

@pytest.mark.parametrize("method", ["auto", "scan", "block"])
@pytest.mark.parametrize("name", sorted(DESIGNS))
def test_sosfiltfilt_matches_jax_and_scipy(name, method):
    jd, td = _designs(name)
    x = np.random.default_rng(11).standard_normal((2, 3000)) + 1.5
    got = tiir.sosfiltfilt(td, torch.as_tensor(x), method=method,
                           block_size=128)
    want = jiir.sosfiltfilt(jd, jnp.asarray(x), method=method, block_size=128)
    ref = sig.sosfiltfilt(jbq.sos_matrix(jd), x, axis=-1)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-9, atol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("padlen", [0, 1, 40, 299])
def test_sosfiltfilt_padlen(padlen):
    """The odd reflection at its extremes: no padding, one sample, and
    T - 1 samples (the longest scipy takes)."""
    jd, td = _designs("lowpass")
    x = np.random.default_rng(12).standard_normal((2, 300))
    got = tiir.sosfiltfilt(td, torch.as_tensor(x), padlen=padlen)
    want = jiir.sosfiltfilt(jd, jnp.asarray(x), padlen=padlen)
    ref = sig.sosfiltfilt(jbq.sos_matrix(jd), x, axis=-1, padlen=padlen)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-9, atol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


def test_sosfiltfilt_rejects_long_padlen():
    _, td = _designs("lowpass")
    with pytest.raises(ValueError):
        tiir.sosfiltfilt(td, torch.ones(10, dtype=torch.float64))


@pytest.mark.parametrize("name", sorted(DESIGNS))
def test_preload_from_values_matches_jax(name):
    jd, td = _designs(name)
    v = np.array([0.5, -1.25, 3.0])
    got = tiir._preload_from_values(td, torch.as_tensor(v))
    want = jiir._preload_from_values(jd, jnp.asarray(v))
    np.testing.assert_array_equal(state_to_numpy(got), np.asarray(want.y_hist))


@pytest.mark.parametrize("sos", [
    lambda: sig.butter(6, 0.3, output="sos"),
    lambda: sig.cheby1(5, 1.0, 0.2, output="sos"),
    lambda: sig.ellip(4, 0.5, 40.0, [0.2, 0.5], btype="bandpass",
                      output="sos")])
def test_sosfilt_zi_matches_jax_and_scipy(sos):
    s = sos()
    got = tiir.sosfilt_zi(s)
    np.testing.assert_array_equal(got, jiir.sosfilt_zi(s))
    np.testing.assert_allclose(got, sig.sosfilt_zi(s), atol=1e-13)


def test_sosfilt_zi_rejects_bad_shape():
    with pytest.raises(ValueError):
        tiir.sosfilt_zi(np.zeros((2, 5)))
