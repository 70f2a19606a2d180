"""The port's real-input channelizer entry (``ops/channelizer.py``
``PFBChannelizer.process_real``, an F-engine's M/2 channels) against the
benchmark's plain reference (``dspbench/reference/pfb_fengine.py``: the
branch sums index by index and ``torch.fft`` in float64) on seeded streams
of noise and tones, on the CPU, at M 256 with K 4 and M 64 with K 16.

Tolerances:

- float64: every channel to 1e-12 of the reference, and to 1e-12 of the
  first M/2 channels of ``forward`` (the full complex transform).
- float32: each stream's channels at a relative RMS error of at most 2e-5,
  the benchmark's limit ``chan_rel_err``.  The FIR of 4-16 taps and the
  32-128-point transform read about 2e-7 here; the input and taps rounded
  to bfloat16 (the benchmark's control) read about 2.6e-3, so the limit
  lies about 100x above the one and 100x below the other.
- Blocks: the outputs of a stream cut into blocks at multiples of M, the
  history carried, equal the whole stream's bit for bit, in both dtypes.

On a card (``cuda``), the cell's own widths: 16 streams of 2^22 samples, M
8192, K 16, against the reference on a few streams.
"""

import math

import pytest
import torch

from dspbench.reference import pfb_fengine as ref
from simpledsp_tpu_torch.ops.channelizer import PFBChannelizer
from simpledsp_tpu_torch.utils import tracing

SHAPES = [(256, 4), (64, 16)]        # M, K
SEEDS = [3, 2 ** 31 + 7]
F32_REL = 2e-5
SPANS = ["sdsp.chan.fir", "sdsp.chan.fft", "sdsp.chan.forward"]


def streams(seed, rows, samples, tones=4):
    """(rows, samples) float64: unit-power Gaussian noise and ``tones``
    sinusoids a stream at -20 to +10 dB over it, each at a frequency and a
    phase drawn from the seed."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((rows, samples), generator=g, dtype=torch.float64)
    n = torch.arange(samples, dtype=torch.float64)
    for b in range(rows):
        for _ in range(tones):
            u = torch.rand(3, generator=g, dtype=torch.float64).tolist()
            amp = math.sqrt(2.0 * 10.0 ** ((-20.0 + 30.0 * u[0]) / 10.0))
            x[b] += amp * torch.cos(math.pi * u[1] * n + 2 * math.pi * u[2])
    return x


def bank(m, k, dtype, device="cpu"):
    return PFBChannelizer(m, taps_per_channel=k, dtype=dtype, device=device)


def in_blocks(chan, x, cuts):
    """``process_real`` over x cut at ``cuts``, the state carried; the
    blocks' channels concatenated along the spectra."""
    state, parts = None, []
    for lo, hi in zip([0] + cuts, cuts + [x.shape[-1]]):
        (yr, yi), state = chan.process_real(x[..., lo:hi], state)
        parts.append(torch.complex(yr, yi))
    return torch.cat(parts, -2), state


def rel_rms(got, want):
    """Each row's relative RMS error over its spectra and channels."""
    err = (got - want).abs().square().sum((-2, -1))
    return (err / want.abs().square().sum((-2, -1))).sqrt()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("m, k", SHAPES)
def test_the_entry_matches_the_reference_in_float64(m, k, seed):
    x = streams(seed, 3, m * (k + 12))
    got, _ = in_blocks(bank(m, k, torch.float64), x, [m * 5, m * 11])
    want = ref.channels(x, ref.prototype(m, k), m)
    assert got.shape == want.shape == (3, k + 12, m // 2)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("m, k", SHAPES)
def test_the_entry_matches_the_reference_in_float32(m, k, seed):
    x = streams(seed, 3, m * (k + 12))
    got, _ = in_blocks(bank(m, k, torch.float32), x.float(), [m * 7])
    want = ref.channels(x.float().double(), ref.prototype(m, k), m)
    assert got.dtype == torch.complex64
    assert float(rel_rms(got.to(torch.complex128), want).max()) <= F32_REL


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m, k", SHAPES)
def test_blocks_give_the_whole_streams_bits(m, k, dtype):
    x = streams(11, 2, m * 3 * k).to(dtype)
    chan = bank(m, k, dtype)
    whole, whole_state = in_blocks(chan, x, [])
    for cuts in ([m], [m * k, m * (k + 1)], [m * (2 * k - 1)]):
        got, state = in_blocks(chan, x, cuts)
        assert torch.equal(got, whole), cuts
        assert torch.equal(state.hist, whole_state.hist), cuts


@pytest.mark.parametrize("m, k", SHAPES)
def test_the_channels_are_the_first_half_of_forwards(m, k):
    x = streams(5, 2, m * 9)
    chan = bank(m, k, torch.float64)
    (yr, yi), state = chan.process_real(x)
    y, forward_state = chan(x)
    torch.testing.assert_close(torch.complex(yr, yi), y[..., : m // 2],
                               rtol=0, atol=1e-12)
    assert torch.equal(state.hist, forward_state.hist)
    # A real stream's upper channels mirror the lower ones.
    torch.testing.assert_close(y[..., m // 2 + 1:].flip(-1),
                               y[..., 1: m // 2].conj(), rtol=0, atol=1e-12)


def test_the_state_carries_over_from_forward():
    m, k = 64, 16
    x = streams(9, 2, m * 40)
    chan = bank(m, k, torch.float64)
    _, state = chan(x[:, : m * 20])
    (yr, yi), _ = chan.process_real(x[:, m * 20:], state)
    whole, _ = in_blocks(chan, x, [])
    assert torch.equal(torch.complex(yr, yi), whole[:, 20:])


def test_the_spans_and_counters_fire_once_a_call():
    m, k, rows, t = 64, 16, 3, 64 * 8
    chan = bank(m, k, torch.float32)
    x = streams(1, rows, 2 * t).float()
    before = tracing.counters()
    tracing.disable()
    tracing.reset()
    tracing.enable()
    try:
        _, state = chan.process_real(x[:, :t])
        chan.process_real(x[:, t:], state)
        spans = tracing.snapshot()["spans"]
    finally:
        tracing.disable()
        tracing.reset()
    after = tracing.counters()
    assert [s["name"] for s in spans] == SPANS * 2
    for call in (spans[:3], spans[3:]):
        fir, fft, fwd = call
        assert fir["parent"] == fft["parent"] == fwd["id"]
        assert fwd["parent"] == 0
        assert fir["call"] == fft["call"] == fwd["call"]
        assert fwd["start_ns"] <= fir["start_ns"] <= fir["end_ns"] \
            <= fft["start_ns"] <= fft["end_ns"] <= fwd["end_ns"]
    assert spans[0]["call"] != spans[3]["call"]
    h = m * k - 1
    assert after["chan.calls"] - before.get("chan.calls", 0) == 2
    assert after["chan.prefix_bytes"] - before.get("chan.prefix_bytes", 0) \
        == 2 * rows * (2 * (h + t) + 2 * h) * 4


def test_spans_off_record_nothing():
    tracing.disable()
    tracing.reset()
    bank(64, 4, torch.float32).process_real(streams(2, 1, 64 * 4).float())
    assert tracing.snapshot()["spans"] == []


def test_the_channel_major_tables_wait_for_their_path():
    """At the cell's M 8192, K 16 the channel-major path's tables would be
    M^2 K + 2 M^2 values; neither the constructor nor ``process_real``
    makes them.  ``process_ri_cm`` does, again after ``.to()``."""
    wide = bank(8192, 16, torch.float32)
    wide.process_real(torch.zeros((1, 8192)))
    assert wide._cm is None
    chan = bank(16, 4, torch.float32)
    xr, xi = streams(4, 2, 16 * 8).float(), streams(6, 2, 16 * 8).float()
    (yr, _), _ = chan.process_ri_cm(xr, xi)
    masked, wc, ws = chan._cm_tables()
    assert masked.shape == (16, 1, 64) and wc.shape == ws.shape == (16, 16)
    assert yr.dtype == masked.dtype == torch.float32
    chan.to(torch.float64)
    (yr64, _), _ = chan.process_ri_cm(xr.double(), xi.double())
    assert chan._cm_tables()[0].dtype == torch.float64
    assert torch.equal(chan._cm_tables()[0], masked.double())
    torch.testing.assert_close(yr64, yr.double(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("m, t, x_dtype, match", [
    (64, 100, torch.float32, "multiple"),
    (63, 126, torch.float32, "even M"),
    (64, 128, torch.complex64, "real stream")])
def test_what_the_entry_refuses(m, t, x_dtype, match):
    chan = bank(m, 4, torch.float32)
    with pytest.raises(ValueError, match=match):
        chan.process_real(torch.zeros((2, t), dtype=x_dtype))


# -- on a card -----------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the frames FFT kernel)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_the_published_widths_on_the_card(card):
    """16 streams x 2^22 samples, M 8192, K 16: two calls of 2^21 give one
    call's bits, the frames FFT kernel runs once a call, and four streams'
    channels lie within the benchmark's limit of the float64 reference."""
    from simpledsp_tpu_torch.kernels.fft import fft_frames_kernel

    m, k, t = 8192, 16, 2 ** 22
    gen = torch.Generator(device=card).manual_seed(2 ** 31 + 5)
    x = torch.randn((16, t), generator=gen, device=card)
    chan = bank(m, k, torch.float32, device=card)
    launches = fft_frames_kernel.launches
    (yr, yi), state = chan.process_real(x)
    torch.cuda.synchronize()
    assert fft_frames_kernel.launches == launches + 1
    assert yr.shape == yi.shape == (16, t // m, m // 2)
    half, half_state = in_blocks(chan, x, [t // 2])
    assert torch.equal(half, torch.complex(yr, yi))
    assert torch.equal(half_state.hist, state.hist)
    h = ref.prototype(m, k)
    for s in (0, 5, 10, 15):
        want = ref.channels(x[s].double().cpu(), h, m)
        got = torch.complex(yr[s], yi[s]).to(torch.complex128).cpu()
        assert float(rel_rms(got, want)) <= F32_REL, s
