"""The port's PFB channelizer, demodulators and NCO against the JAX
package, in float64 on the CPU.

Tolerance 1e-12 throughout: the same float64 math, with sums of at most
M K terms taken in different orders.  The demodulators' atan2 is the
library function on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpledsp_tpu.ops import channelizer as jch
from simpledsp_tpu.ops import demod as jdm
from simpledsp_tpu_torch.ops import channelizer as tch
from simpledsp_tpu_torch.ops import demod as tdm

TOL = 1e-12


def _pair(m=16, k=8, **kw):
    return (tch.PFBChannelizer(m, taps_per_channel=k, dtype=torch.float64,
                               device="cpu",
                               **kw),
            jch.PFBChannelizer(m, taps_per_channel=k, dtype=jnp.float64,
                               **kw))


def _close(ours, theirs, tol=TOL):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs), rtol=0,
                               atol=tol)


@pytest.mark.parametrize("m,k,design", [(16, 8, "kaiser"), (8, 4, "kaiser"),
                                        (16, 8, "remez"), (12, 6, "kaiser")])
@pytest.mark.parametrize("entry", ["process_ri", "process_ri_cm"])
def test_ri_entries_match_jax_streaming(m, k, design, entry, rng):
    """Two streaming calls through each RI entry match the JAX channelizer
    call for call, output and carried history."""
    ours, theirs = _pair(m, k, design=design)
    np.testing.assert_array_equal(ours._branch, theirs._branch)
    st = jst = None
    for t in (m * 24, m * 40):
        xr, xi = rng.standard_normal((2, 3, t))
        (yr, yi), st = getattr(ours, entry)(torch.as_tensor(xr),
                                            torch.as_tensor(xi), st)
        (jr, ji), jst = getattr(theirs, entry)(jnp.asarray(xr),
                                               jnp.asarray(xi), jst)
        _close(yr.numpy(), jr)
        _close(yi.numpy(), ji)
        _close(st.hist_r.numpy(), jst.hist_r, 0)
        _close(st.hist_i.numpy(), jst.hist_i, 0)


def test_complex_call_matches_jax_streaming(rng):
    ours, theirs = _pair()
    st = jst = None
    for t in (16 * 20, 16 * 33):
        x = rng.standard_normal((2, t)) + 1j * rng.standard_normal((2, t))
        y, st = ours(torch.as_tensor(x), st)
        jy, jst = theirs(jnp.asarray(x), jst)
        _close(y.numpy(), jy)
    xr = rng.standard_normal((2, 16 * 8))
    _close(ours(torch.as_tensor(xr))[0].numpy(), theirs(jnp.asarray(xr))[0])


def test_masked_taps_and_frames_equal_jax(rng):
    ours, theirs = _pair()
    np.testing.assert_array_equal(ours._masked_taps, theirs._masked_taps)
    xp = rng.standard_normal((2, 16 * 30 + 7))
    _close(ours.frames_t(torch.as_tensor(xp), pad_to=40).numpy(),
           theirs.frames_t(jnp.asarray(xp), pad_to=40), 0)


@pytest.mark.parametrize("c0", [0, 3, 13])
def test_carrier_lands_in_its_channel(c0):
    """A tone at c0 fs/M comes out of channel c0, the others stay > 60 dB
    below it."""
    m = 16
    ch = tch.PFBChannelizer(m, taps_per_channel=16, dtype=torch.float64,
                            device="cpu")
    n = np.arange(m * 512)
    x = torch.as_tensor(np.exp(2j * np.pi * (c0 / m) * n))
    y, _ = ch(x[None])
    power = (y[0, 64:].abs() ** 2).mean(0).numpy()
    assert np.argmax(power) == c0
    others = np.delete(power, c0)
    assert 10 * np.log10(power[c0] / others.max()) > 60.0


def test_rejects_partial_frames():
    ch = tch.PFBChannelizer(16, dtype=torch.float64, device="cpu")
    z = torch.zeros(1, 20, dtype=torch.float64)
    for call in (ch.process_ri, ch.process_ri_cm):
        with pytest.raises(ValueError, match="multiple of M"):
            call(z, z)
    with pytest.raises(ValueError, match="multiple of M"):
        ch(z)


def _iq(rng, shape):
    iq = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    iq[..., 5] = 0.0     # atan2(0, 0) on both sides of the product
    return iq


def test_fm_demod_matches_jax_streaming(rng):
    st = jst = None
    for _ in range(2):
        iq = _iq(rng, (3, 4, 50))
        y, st = tdm.fm_demod(torch.as_tensor(iq), st, gain=2.5)
        jy, jst = jdm.fm_demod(jnp.asarray(iq), jst, gain=2.5)
        _close(y.numpy(), jy)
        _close(st.prev.numpy(), jst.prev, 0)


def test_fm_demod_ri_matches_jax_streaming(rng):
    st = jst = None
    for _ in range(2):
        iq = _iq(rng, (3, 4, 50))
        y, st = tdm.fm_demod_ri(torch.as_tensor(iq.real),
                                torch.as_tensor(iq.imag), st, gain=0.7)
        jy, jst = jdm.fm_demod_ri(jnp.asarray(iq.real), jnp.asarray(iq.imag),
                                  jst, gain=0.7)
        _close(y.numpy(), jy)
        _close(st.prev_r.numpy(), jst.prev_r, 0)
        _close(st.prev_i.numpy(), jst.prev_i, 0)


def test_atan2_of_zero_is_zero():
    """A zero stream discriminates to exactly 0 (numpy's atan2(0, 0))."""
    z = torch.zeros(2, 8, dtype=torch.float64)
    y, _ = tdm.fm_demod_ri(z, z, gain=3.0)
    assert torch.equal(y, torch.zeros_like(y))
    y, _ = tdm.fm_demod(torch.zeros(2, 8, dtype=torch.complex128))
    assert torch.equal(y, torch.zeros(2, 8, dtype=torch.float64))


@pytest.mark.parametrize("remove_dc", [False, True])
def test_am_demod_matches_jax(remove_dc, rng):
    iq = _iq(rng, (3, 64))
    _close(tdm.am_demod(torch.as_tensor(iq), remove_dc=remove_dc).numpy(),
           jdm.am_demod(jnp.asarray(iq), remove_dc=remove_dc))
    _close(tdm.am_demod_ri(torch.as_tensor(iq.real), torch.as_tensor(iq.imag),
                           remove_dc=remove_dc).numpy(),
           jdm.am_demod_ri(jnp.asarray(iq.real), jnp.asarray(iq.imag),
                           remove_dc=remove_dc))


@pytest.mark.parametrize("offset", [0, 12345, 3 * 10**9 + 7])
def test_nco_matches_jax(offset, rng):
    """Both mixers, phase-exact at a large stream offset."""
    iq = _iq(rng, (2, 96))
    kw = dict(phase=0.3, sample_offset=offset)
    _close(tdm.nco_mix(torch.as_tensor(iq), 0.137, **kw).numpy(),
           jdm.nco_mix(jnp.asarray(iq), 0.137, **kw))
    yr, yi = tdm.nco_mix_ri(torch.as_tensor(iq.real),
                            torch.as_tensor(iq.imag), 0.137, **kw)
    jr, ji = jdm.nco_mix_ri(jnp.asarray(iq.real), jnp.asarray(iq.imag), 0.137,
                            **kw)
    _close(yr.numpy(), jr)
    _close(yi.numpy(), ji)
    np.testing.assert_array_equal(tdm._nco_angles(96, 0.137, 0.3, offset),
                                  jdm._nco_angles(96, 0.137, 0.3, offset))
