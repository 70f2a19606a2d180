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
    order = tabs.order.numpy()
    np.testing.assert_array_equal(tabs.fir_taps.numpy(), jo.taps_t[order[0]].T)
    np.testing.assert_array_equal(order[0], m - 1 - np.arange(m))
    assert tabs.order.dtype == torch.int32
    assert tabs.fir_taps.dtype == tabs.fft_tw.dtype == dtype
    assert all(t.is_contiguous() for t in tabs)


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


@pytest.mark.parametrize("mode,emit_sum", FLAT,
                         ids=["fm", "fm_dec", "am", "am_dec", "am_dec_sum"])
@pytest.mark.parametrize("t", [M * DECIM, M * K, 4096])
def test_split_input_equals_the_prefixed_planes(mode, emit_sum, t):
    """The flat entries given the carried history apart (``hist=``, the
    receiver banks' input) give, bit for bit, what they give on [hist | x |
    pad] planes of :func:`flat_pad_to`'s width, over three chained calls
    carrying the history, the FM carry and the decimator history: at
    T = M decim (below the history's M K - 1), M K and 4096, each entry
    with its own default g."""
    rng = np.random.default_rng(t)
    ops = _ops(M, K)[1].kernel_ops
    h = M * K - 1
    t_ = torch.as_tensor
    fm, dec = mode.startswith("fm"), mode.endswith("dec")
    hist = [t_(v) for v in rng.standard_normal((2, B, h))]
    prev = [t_(v) for v in rng.standard_normal((2, B, M, 1))]
    ahist = t_(rng.standard_normal((B, M, KD - 1)))
    taps = lowpass_taps(KD, 0.1, fs=1.0)
    for _ in range(3):
        x = [t_(v) for v in rng.standard_normal((2, B, t))]
        pad = torch.zeros(B, tpfb.flat_pad_to(ops, t // M) - h - t,
                          dtype=torch.float64)
        xp = [torch.cat([hv, xv, pad], -1) for hv, xv in zip(hist, x)]
        kw = dict(dec_taps=taps, decim=DECIM, ahist=ahist) if dec else {}
        if fm:
            split = tpfb.pfb_fm_flat(ops, *x, *prev, gain=2.5,
                                     hist=tuple(hist), **kw)
            whole = tpfb.pfb_fm_flat(ops, *xp, *prev, gain=2.5, **kw)
        else:
            split = tpfb.pfb_am_flat(ops, *x, emit_sum=emit_sum,
                                     hist=tuple(hist), **kw)
            whole = tpfb.pfb_am_flat(ops, *xp, emit_sum=emit_sum, **kw)
        got, want = _leaves(split), _leaves(whole)
        assert len(got) == len(want)
        for a, w in zip(got, want):
            np.testing.assert_array_equal(a, w)
        if fm:
            prev = list(split[1])
        if dec:
            ahist = split[2] if fm else split[1]
        hist = [torch.cat([hv, xv], -1)[:, -h:] for hv, xv in zip(hist, x)]


def test_split_input_is_refused_where_it_does_not_fit(data):
    """A history and x too short for g frames, and re / im history planes
    of different shapes, raise."""
    _, tch, xr, xi = data[:4]
    ops = tch.kernel_ops
    h = tch.hist_len
    t = torch.as_tensor
    hist = (t(xr[:, :h]), t(xi[:, :h]))
    with pytest.raises(ValueError, match="input frames"):
        tpfb.pfb_am_flat(ops, t(xr[:, h:h + M * G]), t(xi[:, h:h + M * G]),
                         g=G + 1, hist=hist)
    with pytest.raises(ValueError, match="history planes differ"):
        tpfb.pfb_am_flat(ops, t(xr[:, h:]), t(xi[:, h:]),
                         hist=(hist[0], hist[1][:, 1:]))


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


# -- the CUDA kernel's arithmetic, walked in numpy from its host tables ------

def _walk_fft(u, tw, order):
    """(..., M) branch outputs through the kernel's FFT: input e takes row
    order[0, e], radix-2 decimation-in-frequency stages with the twiddles
    tw (log2 M, M, 2), output position e is channel order[1, e]."""
    m = u.shape[-1]
    v = u[..., order[0]].astype(complex)
    w = tw[..., 0] + 1j * tw[..., 1]
    for s in range(tw.shape[0]):
        h = m >> (s + 1)
        top = np.arange(m)[(np.arange(m) & h) == 0]
        a, b = v[..., top].copy(), v[..., top + h].copy()
        v[..., top] = a + b
        v[..., top + h] = (a - b) * w[s, top + h]
    y = np.empty_like(v)
    y[..., order[1]] = v
    return y


def _walk_kernel(mode, tabs, fr, fi, prev, ahist, dtaps, gain, g, decim,
                 emit_sum):
    """The kernel's arithmetic on frame-major (B, g + K - 1, M) planes in
    float64: the FIR by FFT input position from ``fir_taps``, the FFT of
    :func:`_walk_fft`, the demod, and the decimator by phase from
    ``decimator_phase_index``."""
    taps = tabs.fir_taps.numpy()
    order = tabs.order.numpy()
    k = taps.shape[0]
    x = fr + 1j * fi
    xe = x[..., order[0]]                      # the row each position reads
    u = sum(taps[j] * xe[:, k - 1 - j:k - 1 - j + g] for j in range(k))
    # _walk_fft re-applies the row order: hand it u by row.
    ur = np.empty_like(u)
    ur[..., order[0]] = u
    y = _walk_fft(ur, tabs.fft_tw.numpy(), order).transpose(0, 2, 1)
    if mode == "chan":
        return y.real, y.imag
    if mode.startswith("fm"):
        prv = np.concatenate([prev[0] + 1j * prev[1], y[..., :-1]], -1)
        q = y * np.conj(prv)
        sig = gain * np.arctan2(q.imag, q.real)
        carry = (y.real[..., -1:], y.imag[..., -1:])
    else:
        sig = np.abs(y)
    if mode == "fm":
        return sig, carry
    if mode == "am":
        return sig
    kd = len(dtaps)
    idx = tpfb.decimator_phase_index(kd, decim)
    ext = np.concatenate([ahist, sig], -1)
    nt = g // decim
    audio = np.zeros(sig.shape[:-1] + (nt,))
    for ph in range(decim):
        for o in range(idx.shape[1]):
            if idx[ph, o] >= 0:
                rows = (np.arange(nt) + o) * decim + ph
                audio += dtaps[idx[ph, o]] * ext[..., rows]
    ahist_out = ext[..., ext.shape[-1] - (kd - 1):]
    if mode == "fm_dec":
        return audio, carry, ahist_out
    if emit_sum:
        return audio, ahist_out, sig.sum(-1)
    return audio, ahist_out


WALK_MODES = [("fm", False), ("fm_dec", False), ("am", False),
              ("am_dec", False), ("am_dec", True), ("chan", False)]


@pytest.mark.parametrize("mode,emit_sum", WALK_MODES,
                         ids=["fm", "fm_dec", "am", "am_dec", "am_dec_sum",
                              "chan"])
@pytest.mark.parametrize("k", [4, 16, 32])
@pytest.mark.parametrize("m", [1, 2, 8, 16, 32, 128])
def test_kernel_tables_give_the_plain_version(m, k, mode, emit_sum):
    """The kernel's host tables (FFT input rows, twiddles, output channels,
    FIR taps by position, per-phase decimator taps) walked in numpy in
    float64 in the kernel's order give ``pfb_flat_reference`` (and
    ``pfb_frames_reference`` for chan) to 1e-12 of the largest output."""
    rng = np.random.default_rng(m * 100 + k)
    b, g, kd, decim = 2, 24, 11, 4
    tabs = tpfb.PFBOperators(rng.standard_normal((m, k)),
                             dtype=torch.float64).tables()
    fr, fi = rng.standard_normal((2, b, g + k - 1, m))
    prev = rng.standard_normal((2, b, m, 1))
    ahist = rng.standard_normal((b, m, kd - 1))
    dtaps = lowpass_taps(kd, 0.1, fs=1.0)
    fm, dec = mode.startswith("fm"), mode.endswith("dec")
    t = torch.as_tensor
    args = (t(prev[0]) if fm else None, t(prev[1]) if fm else None,
            t(ahist) if dec else None, t(dtaps) if dec else None)
    kw = dict(gain=2.5, g=g, decim=decim, emit_sum=emit_sum)
    if mode == "chan":
        want = tpfb.pfb_frames_reference(
            mode, tabs, t(fr).transpose(1, 2), t(fi).transpose(1, 2), *args,
            **kw)
    else:
        want = tpfb.pfb_flat_reference(mode, tabs, t(fr).reshape(b, -1),
                                       t(fi).reshape(b, -1), *args, **kw)
    got = _walk_kernel(mode, tabs, fr, fi, prev, ahist, dtaps, 2.5, g, decim,
                       emit_sum)
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    scale = max(np.abs(w).max() for w in want)
    for a, w in zip(got, want):
        assert a.shape == w.shape
        np.testing.assert_allclose(a, w, rtol=0, atol=1e-12 * scale)


@pytest.mark.parametrize("gt", [8, 64, 1024])
@pytest.mark.parametrize("m,k", [(16, 16), (32, 16), (16, 32), (8, 16),
                                 (128, 3)])
def test_kernel_input_stage_reads_the_stream_from_two_sources(m, k, gt):
    """The flat kernel's input stage (``csrc/pfb.cu``) walked in numpy for
    every tile of tiles of ``gt`` frames: the first round's chunk split at
    the tile's element h - gbase into 4-byte copies from the history and
    copies from x at its origin xo = gbase - h, the later rounds' chunks
    (``copy_chunk``) from x alone, fill the tile's frames i0 .. nx - 1 once
    each with the stream [hist | x], reading nothing outside either source;
    at g = decim (T below the history), K and 2000 frames, with each mode's
    halo."""
    kd, decim, h = 64, 4, m * k - 1
    p = m // 32 if m > 32 else 1
    per_round = 256 // min(m, 32) * {1: 9, 2: 4}.get(p, 2)
    for g in (decim, k, 2000):
        t = g * m
        hist, x = np.arange(h) + 0.5, np.arange(h, h + t) + 0.5
        stream = np.concatenate([hist, x])
        for mode in ("fm", "am", "fm_dec", "am_dec"):
            hb = (kd - 1 if mode.endswith("dec") else 0) + (mode[:2] == "fm")
            for f0 in range(0, g, gt):
                ny = min(gt, g - f0) + hb
                nx = ny + k - 1
                a0 = f0 - hb
                i0 = max(0, -a0)
                gbase, nrounds = a0 * m, -(-(ny - i0) // per_round)
                xo = gbase - h
                ends = [i0] + [min(nx, i0 + (rd + 1) * per_round + k - 1)
                               for rd in range(nrounds)]
                xs = np.full(nx * m, -1.0)
                for n, (lo, hi) in enumerate(zip(ends[:-1], ends[1:])):
                    e0, e1 = lo * m, hi * m
                    eh = (e0 if -xo <= e0 or n else e1 if -xo >= e1
                          else -xo)
                    from_h = np.arange(e0, eh) + gbase
                    from_x = np.arange(eh, e1) + xo
                    assert from_h.size == 0 or (0 <= from_h.min()
                                                and from_h.max() < h)
                    assert from_x.size == 0 or (0 <= from_x.min()
                                                and from_x.max() < t)
                    assert (xs[e0:e1] == -1).all()
                    xs[e0:eh], xs[eh:e1] = hist[from_h], x[from_x]
                assert ends[-1] == nx and (xs[:i0 * m] == -1).all()
                np.testing.assert_array_equal(
                    xs[i0 * m:], stream[gbase + i0 * m:gbase + nx * m])


@pytest.mark.parametrize("m", [1, 2, 4, 8, 16, 32, 64, 128])
def test_fft_tables_give_the_jax_inverse_dft(m):
    """Unit branch outputs through the kernel's FFT give the JAX package's
    flipped inverse-DFT operators ``wfc + i wfs`` (float64, 1e-13), and the
    FIR taps by position are the JAX ``taps_t`` rows in the FFT's input
    order, bit for bit."""
    branch = np.random.default_rng(m).standard_normal((m, 4))
    tabs = tpfb.PFBOperators(branch, dtype=torch.float64).tables()
    jo = jpfb.PFBOperators(branch, dtype=jnp.float64)
    w = _walk_fft(np.eye(m), tabs.fft_tw.numpy(), tabs.order.numpy())
    np.testing.assert_allclose(w.real.T, np.asarray(jo.wfc), rtol=0, atol=1e-13)
    np.testing.assert_allclose(w.imag.T, np.asarray(jo.wfs), rtol=0, atol=1e-13)
    order = tabs.order.numpy()
    np.testing.assert_array_equal(tabs.fir_taps.numpy(),
                                  np.asarray(jo.taps_t)[order[0]].T)
    assert sorted(order[1].tolist()) == list(range(m))


@pytest.mark.parametrize("kd,decim", [(64, 4), (11, 4), (3, 4), (24, 1),
                                      (7, 3)])
def test_decimator_phase_index_covers_every_tap_once(kd, decim):
    idx = tpfb.decimator_phase_index(kd, decim)
    assert idx.shape == (decim, -(-(-(-kd // decim)) // 4) * 4)
    assert sorted(idx[idx >= 0].tolist()) == list(range(kd))
    for ph in range(decim):
        live = idx[ph][idx[ph] >= 0]
        assert np.all((kd - 1 - ph - live) % decim == 0)
        assert np.all(idx[ph][: len(live)] >= 0)   # the live taps come first


def test_stage_cuts_of_the_pfb_source():
    """``tools/pfb_stages.py`` cuts the kernel through its
    ``SDSP_PFB_CUT_AT`` hook (after the input, the FIR, the FFT, and the
    demod, where every cut returns); it never launches anything here."""
    from simpledsp_tpu_torch.kernels import _build
    from simpledsp_tpu_torch.tools import pfb_stages

    text = (_build.CSRC_DIR / "pfb.cu").read_text()
    assert all(f in text for f in ("SDSP_PFB_CUT_AT == 1", "SDSP_PFB_SINK(2)",
                                   "SDSP_PFB_SINK(3)"))
    for n in range(1, pfb_stages.CUTS + 1):
        cut = pfb_stages.cut_source(text, n)
        assert cut.startswith(f"#define SDSP_PFB_CUT_AT {n}\n")
        assert cut.endswith(text)
