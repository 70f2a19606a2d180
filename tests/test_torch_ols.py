"""The port's overlap-save convolution (kernels/ols plain version,
ops/fir.OverlapSaveFIR and fir_filter) against the JAX package, in float64
on the CPU.

The JAX kernel runs in Pallas interpret mode, as its own tests run it.
Tolerance: 1e-12 relative to the largest output magnitude (float64 rounding
of four-step sums in a different order); the tables are equal bit for bit
(the same float64 host code); streaming is exact (equal bits).  The CUDA
kernel's index arithmetic (its loads, the FFT core's passes, the tap
product between the transforms and the store) is walked here in float64
on the CPU.
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
from simpledsp_tpu_torch.kernels.fft import _best_split
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


def _ols_walk(x, nf, frame_stride, offset, valid, nfft, skip, taps):
    """``csrc/ols.cu``'s kernel walked in float64 with its own index
    arithmetic: blocks of ppb = max(1, 4096 / N) frame pairs, each frame's
    row offset and start, the load (16-byte chunks zero-filled past
    ``valid`` where the strides allow, else single samples; planes re = frame
    a, im = frame b), the forward transform on the FFT core
    (``_core_walk``), TapTurn between its last pass and the inverse's first
    (bin p times H[p mod N], conjugated), the inverse transform on the
    reversed plan and its last pass's SkipSplitStore (sample p of pair
    p / N: Re to frame a, -Im to frame b, samples below skip dropped, no
    frame b past the last).  x: (rows, W) float64.  Returns (rows nf,
    N - skip), NaN where nothing was stored."""
    from test_torch_fft import _core_walk

    from simpledsp_tpu_torch.kernels import fft as tkfft

    rows, n = x.shape[0], nfft
    total = rows * nf
    lg, mask, hop = n.bit_length() - 1, n - 1, n - skip
    ppb = 1 if n >= 4096 else 4096 // n
    wide = x.shape[1] % 4 == 0 and frame_stride % 4 == 0 and offset % 4 == 0
    flat = x.reshape(-1)
    h = np.fft.fft(taps, n) / n
    out = np.full((total, hop), np.nan)
    pairs = (total + 1) // 2
    for blk in range(-(-pairs // ppb)):
        pair0 = blk * ppb
        g0 = 2 * pair0
        np_ = min(ppb, pairs - pair0)
        frames = min(2 * np_, total - g0)
        row_at, start = [], []
        for i in range(2 * np_):
            g = g0 + i
            if i < frames:
                row = g // nf
                row_at.append(row * x.shape[1])
                start.append((g - row * nf) * frame_stride - offset)
            else:
                row_at.append(0)
                start.append(valid)
        tot = np_ * n
        planes = np.full((2, tot), np.nan)
        for e0 in range(0, tot, 4 if wide else 1):
            q, t = e0 >> lg, e0 & mask
            for half in range(2):
                pos = start[2 * q + half] + t
                if wide:
                    left = valid - pos
                    count = 0 if pos < 0 else min(4, max(0, left))
                    chunk = np.zeros(4)
                    at = row_at[2 * q + half] + pos
                    chunk[:count] = flat[at: at + count]
                    planes[half, e0: e0 + 4] = chunk
                else:
                    ok = 0 <= pos < valid
                    planes[half, e0] = flat[row_at[2 * q + half] + pos] if ok \
                        else 0.0
        z = _core_walk((planes[0] + 1j * planes[1]).reshape(np_, n), n)
        p = np.arange(tot)
        yv = z.reshape(-1) * h[p & mask]
        w = _core_walk(np.conj(yv).reshape(np_, n), n,
                       tkfft._plan(n)[::-1]).reshape(-1)
        keep = (p & mask) >= skip
        fa = g0 + 2 * (p >> lg)
        out[fa[keep], (p & mask)[keep] - skip] = w.real[keep]
        hasb = keep & (fa + 1 < g0 + frames)
        out[fa[hasb] + 1, (p & mask)[hasb] - skip] = -w.imag[hasb]
    return out


@pytest.mark.parametrize("nfft,m,rows,t", [(64, 9, 3, 301), (256, 40, 1, 1000),
                                           (1024, 65, 3, 4094),
                                           (4096, 301, 3, 16000),
                                           (16384, 2000, 1, 40000)])
def test_ols_kernel_walk_gives_the_plain_version(nfft, m, rows, t, rng):
    """The kernel walked on the CPU (:func:`_ols_walk`), on the signal path's
    source (frame stride hop, offset the zero history, valid the signal's
    length), gives ``conv_ols_frames_reference`` in float64 on the padded
    frames and numpy's full convolution (1e-12 of the largest output) at
    every frame, an odd frame count included (the last pair's frame b
    absent); rows of a length that is not a multiple of 4 take the
    single-sample loads.  nfft 64 splits as 1 x 64, where the plain version
    leaves no output past one overlap row: the kernel takes any skip, here
    16 samples, held to numpy."""
    x = rng.standard_normal((rows, t))
    h = rng.standard_normal(m)
    n1, n2 = _best_split(nfft)
    o1 = -(-(m - 1) // n2)
    skip = o1 * n2 if o1 < n1 else 16
    hop = nfft - skip
    nf = -(-(t + m - 1) // hop)
    assert (rows * nf) % 2 == 1
    got = _ols_walk(x, nf, hop, skip, t, nfft, skip, h)
    full = np.stack([np.convolve(r, h) for r in x])
    _close(got.reshape(rows, -1)[:, : t + m - 1], full)
    if o1 < n1:
        frames = torch.nn.functional.pad(
            torch.as_tensor(x), (skip, nf * hop - t)).unfold(-1, nfft, hop)
        want = tols.conv_ols_frames_reference(
            frames, tols.ols_tables(nfft, h, torch.float64), o1)
        _close(got, want.reshape(rows * nf, hop).numpy())


@pytest.mark.parametrize("nfft", [64, 128, 256, 512, 1024, 2048, 4096, 8192,
                                  16384])
def test_ols_kernel_exchanges_have_no_bank_conflict(nfft):
    """Every access of the kernel's interleaved buffer (value p at float2
    index p ^ ((p >> 4) & 15), 8 bytes: a phase of 16 lanes) falls in 16
    distinct bank pairs: the forward passes' reads after the first (which
    reads the copies' planes) and their writes, the turn's writes (f n +
    j R + m), and the inverse passes on the reversed plan, whose last pass
    writes device memory."""
    from simpledsp_tpu_torch.kernels import fft as tkfft

    ppb = 1 if nfft >= 4096 else 4096 // nfft
    nt = ppb * nfft // 16
    tid = np.arange(nt)
    fwd = tkfft._plan(nfft)
    accesses = []
    for plan, inverse in ((fwd, False), (fwd[::-1], True)):
        ns = 1
        for p, r in enumerate(plan):
            q = nfft // r
            last = p == len(plan) - 1
            for b in range(16 // r):
                w = tid + b * nt
                f, j = w // q, w % q
                k = j % ns
                live = w < ppb * nfft // r
                if p > 0 or inverse:
                    accesses += [np.where(live, f * nfft + j + t * q, -1)
                                 for t in range(r)]
                if last and not inverse:       # the turn's writes
                    accesses += [np.where(live, f * nfft + j * r + m, -1)
                                 for m in range(r)]
                elif not last:
                    accesses += [np.where(live, f * nfft + (j - k) * r + k
                                          + m * ns, -1) for m in range(r)]
            ns *= r
    for idx in accesses:
        for w0 in range(0, nt, 16):
            p = idx[w0: w0 + 16]
            p = p[p >= 0]
            slots = (p ^ ((p >> 4) & 15)) % 16
            assert len(set(slots.tolist())) == len(p), (nfft, p)


def test_ols_variants_tool_edits_apply_and_need_a_card():
    """``tools/ols_variants.py`` builds each variant by one edit of
    ``csrc/ols.cu``: every edit's text is in the source once, and the tool
    times the card and raises without one."""
    from simpledsp_tpu_torch.kernels import _build
    from simpledsp_tpu_torch.tools import ols_variants

    text = (_build.CSRC_DIR / "ols.cu").read_text()
    for name, edit in ols_variants.VARIANTS.items():
        assert edit is None or text.count(edit[0]) == 1, name
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ols_variants.run(variants=("all",))
