"""The port's PFB kernels' plain versions against the JAX package's Pallas
kernels (``kernels/pfb.py``) in interpret mode, in float64 on the CPU.

On the CPU the public entries (``pfb_fm_flat`` ...) run the plain versions
``pfb_flat_reference`` / ``pfb_frames_reference``; the CUDA kernel is held
to them on the card (``test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances: host tables bit for bit (same float64 code, same cast); the
kernels' outputs 1e-10 (the JAX kernel's 7-term float64 atan2 polynomial
is within 1.2e-12 rad, times gains up to 2.5; envelopes and channel
outputs agree to rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpledsp_tpu.design.fir import lowpass_taps
from simpledsp_tpu.kernels import pfb as jpfb
from simpledsp_tpu.ops.channelizer import PFBChannelizer as JChannelizer
from simpledsp_tpu_torch.kernels import pfb as tpfb
from simpledsp_tpu_torch.ops.channelizer import ChanStateRI, PFBChannelizer

TOL = 1e-10


def _ops(m, k, dtype=torch.float64):
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    jch = JChannelizer(m, taps_per_channel=k, dtype=jdt)
    tch = PFBChannelizer(m, taps_per_channel=k, dtype=dtype, device="cpu")
    return jch, tch


@pytest.mark.parametrize("m,k", [(16, 16), (8, 4), (32, 8), (12, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_operators_equal_jax_bitwise(m, k, dtype):
    jch, tch = _ops(m, k, dtype)
    jo, to = jch.kernel_ops, tch.kernel_ops
    for name in ("taps_t", "wfc", "wfs"):
        assert getattr(to, name).dtype == getattr(jo, name).dtype
        np.testing.assert_array_equal(getattr(to, name), getattr(jo, name))
    for p in (1, 2, 128 // m if 128 % m == 0 else 3):
        for a, b in zip(to.packed_tables(p), jo.packed_tables(p)):
            np.testing.assert_array_equal(a, b)
    tabs = to.tables()
    np.testing.assert_array_equal(tabs.taps_jm.numpy(), jo.taps_t.T)
    np.testing.assert_array_equal(tabs.wct.numpy(), jo.wfc.T)
    assert tabs.taps_jm.is_contiguous() and tabs.wst.is_contiguous()


@pytest.mark.parametrize("m,k", [(16, 16), (8, 4), (32, 8), (16, 32),
                                 (128, 3), (4, 2)])
@pytest.mark.parametrize("g", [0, 8, 192, 1000])
def test_flat_pad_to_equals_jax_interpret(m, k, g):
    jch, tch = _ops(m, k)
    assert (tpfb.flat_pad_to(tch.kernel_ops, g)
            == jpfb.flat_pad_to(jch.kernel_ops, g, interpret=True))


def test_flat_pad_to_rejects_m_not_dividing_128():
    _, tch = _ops(12, 4)
    with pytest.raises(ValueError, match="M \\| 128"):
        tpfb.flat_pad_to(tch.kernel_ops, 8)


@pytest.mark.parametrize("m,k,ok", [(16, 16, True), (16, 32, True),
                                    (8, 16, True), (32, 16, True),
                                    (128, 32, True), (1, 1, True),
                                    (12, 16, False), (16, 33, False),
                                    (256, 4, False)])
def test_kernel_supports(m, k, ok):
    assert tpfb.kernel_supports(m, k) is ok


# -- the kernels' plain versions against the JAX kernels ---------------------

B, M, K, G = 3, 16, 16, 192
KD, DECIM = 24, 4


@pytest.fixture(scope="module")
def data():
    """History-prefixed flat planes padded to the JAX interpret width, the
    matching frames planes, a random FM carry and decimator history."""
    rng = np.random.default_rng(1234)
    jch, tch = _ops(M, K)
    w = jpfb.flat_pad_to(jch.kernel_ops, G, interpret=True)
    xr, xi = rng.standard_normal((2, B, w))
    xr[:, w - 5:] = xi[:, w - 5:] = 0.0
    ftr = np.array(jch.frames_t(jnp.asarray(xr)))
    fti = np.array(jch.frames_t(jnp.asarray(xi)))
    pr, pi = rng.standard_normal((2, B, M, 1))
    ah = rng.standard_normal((B, M, KD - 1))
    taps = lowpass_taps(KD, 0.1, fs=1.0)
    return jch, tch, xr, xi, ftr, fti, pr, pi, ah, taps


def _leaves(t):
    if isinstance(t, (tuple, list)):
        return [u for v in t for u in _leaves(v)]
    return [np.asarray(t)]


def _jax_flat(mode, d, emit_sum=False):
    jch, _, xr, xi, _, _, pr, pi, ah, taps = d
    ops = jch.kernel_ops
    kw = dict(g=G, row_tile=8, interpret=True)
    if mode.endswith("dec"):
        kw.update(dec_taps=taps, decim=DECIM, ahist=jnp.asarray(ah))
    if mode.startswith("fm"):
        return jpfb.pfb_fm_flat(ops, jnp.asarray(xr), jnp.asarray(xi),
                                jnp.asarray(pr), jnp.asarray(pi), gain=2.5,
                                **kw)
    return jpfb.pfb_am_flat(ops, jnp.asarray(xr), jnp.asarray(xi),
                            emit_sum=emit_sum, **kw)


def _jax_frames(mode, d):
    jch, _, _, _, ftr, fti, pr, pi, ah, taps = d
    ops = jch.kernel_ops
    kw = dict(g=G, g_tile=64, interpret=True)
    if mode == "chan":
        return jpfb.pfb_channelize_frames(ops, jnp.asarray(ftr),
                                          jnp.asarray(fti), **kw)
    if mode.endswith("dec"):
        kw.update(dec_taps=taps, decim=DECIM, ahist=jnp.asarray(ah))
    if mode.startswith("fm"):
        return jpfb.pfb_fm_frames(ops, jnp.asarray(ftr), jnp.asarray(fti),
                                  jnp.asarray(pr), jnp.asarray(pi), gain=2.5,
                                  **kw)
    return jpfb.pfb_am_frames(ops, jnp.asarray(ftr), jnp.asarray(fti), **kw)


def _args(mode, d):
    _, tch, xr, xi, ftr, fti, pr, pi, ah, taps = d
    t = torch.as_tensor
    fm = mode.startswith("fm")
    dec = mode.endswith("dec")
    return (tch.kernel_ops.tables(), t(pr) if fm else None,
            t(pi) if fm else None, t(ah) if dec else None,
            t(taps) if dec else None)


FLAT = [("fm", False), ("fm_dec", False), ("am", False), ("am_dec", False),
        ("am_dec", True)]


@pytest.mark.parametrize("mode,emit_sum", FLAT,
                         ids=["fm", "fm_dec", "am", "am_dec", "am_dec_sum"])
def test_flat_reference_matches_jax(mode, emit_sum, data):
    tabs, pr, pi, ah, taps = _args(mode, data)
    got = tpfb.pfb_flat_reference(
        mode, tabs, torch.as_tensor(data[2]), torch.as_tensor(data[3]), pr,
        pi, ah, taps, gain=2.5, g=G, decim=DECIM, emit_sum=emit_sum)
    ref = _jax_flat(mode, data, emit_sum)
    got, ref = _leaves(got), _leaves(ref)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)


@pytest.mark.parametrize("mode", ["fm", "fm_dec", "am", "am_dec", "chan"])
def test_frames_reference_matches_jax(mode, data):
    tabs, pr, pi, ah, taps = _args(mode, data)
    got = tpfb.pfb_frames_reference(
        mode, tabs, torch.as_tensor(data[4]), torch.as_tensor(data[5]), pr,
        pi, ah, taps, gain=2.5, g=G, decim=DECIM)
    got, ref = _leaves(got), _leaves(_jax_frames(mode, data))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)


@pytest.mark.parametrize("mode,emit_sum", FLAT,
                         ids=["fm", "fm_dec", "am", "am_dec", "am_dec_sum"])
def test_public_entries_run_the_plain_version_on_cpu(mode, emit_sum, data):
    """The public entries on CPU tensors return the plain version's result,
    with g taken from the padded width, and launch nothing."""
    _, tch, xr, xi, ftr, fti, pr, pi, ah, taps = data
    ops = tch.kernel_ops
    t = torch.as_tensor
    kw = {}
    if mode.endswith("dec"):
        kw = dict(dec_taps=taps, decim=DECIM, ahist=t(ah))
    launches = (tpfb.pfb_flat_kernel.launches, tpfb.pfb_frames_kernel.launches)
    if mode.startswith("fm"):
        flat = tpfb.pfb_fm_flat(ops, t(xr), t(xi), t(pr), t(pi), gain=2.5,
                                **kw)
        frames = tpfb.pfb_fm_frames(ops, t(ftr), t(fti), t(pr), t(pi),
                                    gain=2.5, g=G, **kw)
    else:
        flat = tpfb.pfb_am_flat(ops, t(xr), t(xi), emit_sum=emit_sum, **kw)
        frames = tpfb.pfb_am_frames(ops, t(ftr), t(fti), g=G, **kw)
    ref = _leaves(_jax_flat(mode, data, emit_sum))
    for a, b in zip(_leaves(flat), ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    for a, b in zip(_leaves(frames), ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    assert launches == (tpfb.pfb_flat_kernel.launches,
                        tpfb.pfb_frames_kernel.launches)


def test_channelize_frames_equals_channelizer(data):
    """The bare channelizer entry equals ``process_ri_cm`` on the same
    stream (zero history)."""
    _, tch, xr, xi, ftr, fti = data[:6]
    h = tch.hist_len
    yr, yi = tpfb.pfb_channelize_frames(tch.kernel_ops, torch.as_tensor(ftr),
                                        torch.as_tensor(fti), g=G)
    t = torch.as_tensor
    (cr, ci), _ = tch.process_ri_cm(
        t(xr[:, h:h + M * G]), t(xi[:, h:h + M * G]),
        ChanStateRI(t(xr[:, :h]), t(xi[:, :h])))
    np.testing.assert_allclose(yr.numpy(), cr.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(yi.numpy(), ci.numpy(), rtol=0, atol=1e-12)


def test_entries_refuse_what_they_do_not_take(data):
    """No fallback and no silent truncation: a short input, a bad decimation,
    a device other than CUDA or CPU, and float64 for the CUDA kernel (checked
    before any build) all raise."""
    _, tch, xr, xi, ftr, fti, pr, pi, ah, taps = data
    ops = tch.kernel_ops
    t = torch.as_tensor
    with pytest.raises(ValueError, match="input frames"):
        tpfb.pfb_am_flat(ops, t(xr), t(xi), g=G + 20)
    with pytest.raises(ValueError, match="decim"):
        tpfb.pfb_am_flat(ops, t(xr), t(xi), g=G - 2, dec_taps=taps, decim=4,
                         ahist=t(ah))
    with pytest.raises(ValueError, match="ahist"):
        tpfb.pfb_am_flat(ops, t(xr), t(xi), g=G, dec_taps=taps, decim=4,
                         ahist=t(ah[..., 1:]))
    with pytest.raises(ValueError, match="rows"):
        tpfb.pfb_am_frames(ops, t(ftr[:, 1:]), t(fti[:, 1:]))
    with pytest.raises(ValueError, match="emit_sum"):
        tpfb.pfb_am_flat(ops, t(xr), t(xi), emit_sum=True)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tpfb.pfb_am_flat(ops, t(xr).to("meta"), t(xi).to("meta"), g=G)
    launches = tpfb.pfb_flat_kernel.launches
    with pytest.raises(ValueError, match="input frames"):
        tpfb.pfb_frames_kernel("chan", ops.tables(), t(ftr).float(),
                               t(fti).float(), None, None, None, None,
                               gain=0.0, g=G + 20, decim=1, emit_sum=False,
                               tile=None)
    with pytest.raises(ValueError, match="float32"):
        tpfb.pfb_flat_kernel("am", ops.tables(), t(xr), t(xi), None, None,
                             None, None, gain=0.0, g=G, decim=1,
                             emit_sum=False, tile=None)
    assert tpfb.pfb_flat_kernel.launches == launches
