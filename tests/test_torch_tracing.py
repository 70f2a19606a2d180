"""The port's tracer (``utils/tracing.py``): counters always on, spans off
unless asked for, each span's parent, call and self time, the bound on the
spans kept, the kernel wrappers' launch counts as counters, and the spans
and counters of the chain and the bank on the CPU, with and without the
profiler."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from simpledsp_tpu_torch.kernels import cfar as kcfar
from simpledsp_tpu_torch.kernels import chain as kchain
from simpledsp_tpu_torch.kernels import chain_variants as kcv
from simpledsp_tpu_torch.kernels import conv2d as k2d
from simpledsp_tpu_torch.kernels import doppler as kdop
from simpledsp_tpu_torch.kernels import fft as kfft
from simpledsp_tpu_torch.kernels import ols as kols
from simpledsp_tpu_torch.kernels import pfb as kpfb
from simpledsp_tpu_torch.kernels import probes as kprobes
from simpledsp_tpu_torch.models import radar
from simpledsp_tpu_torch.models.northstar import NorthStarChain
from simpledsp_tpu_torch.models.sdr import AMReceiverBank, FMReceiverBank
from simpledsp_tpu_torch.ops import fft as tfft
from simpledsp_tpu_torch.utils import tracing

REPO = Path(__file__).resolve().parents[1]

# Every kernel wrapper with a launch count, as chip_smoke.KERNELS lists
# them, and its counter.
KERNELS = {
    "chain_natural": kchain.chain_kernel,
    "chain_full": kchain.chain_full_kernel,
    "chain_regs": kcv.chain_regs_kernel,
    "chain_grouped": kcv.chain_grouped_kernel,
    "chain_wide_fmajor": kcv.chain_store_kernel,
    "conv2d": k2d.conv2d_kernel,
    "ols": kols.ols_kernel,
    "fft_frames": kfft.fft_frames_kernel,
    "pfb_flat": kpfb.pfb_flat_kernel,
    "pfb_frames": kpfb.pfb_frames_kernel,
    "scale_copy": kprobes.scale_copy_kernel,
    "permute": kprobes.permute_kernel,
    "contract": kprobes.contract_kernel,
    "row_sum": kprobes.row_sum_kernel,
    "cfar": kcfar.cfar_kernel,
    "doppler": kdop.doppler_power,
}

CHAIN_SPANS = {"sdsp.chain.forward", "sdsp.chain.prepass",
               "sdsp.chain.launch"}
BANK_SPANS = {"sdsp.bank.forward", "sdsp.bank.prefix", "sdsp.pfb.launch"}


@pytest.fixture(autouse=True)
def clean():
    """Each test starts with no spans and spans off, and leaves them so."""
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _names():
    return [s["name"] for s in tracing.snapshot()["spans"]]


def _off():
    """Spans are off: every span() is the one shared null context."""
    return tracing.span("sdsp.a") is tracing.span("sdsp.b")


def _bank(cls=FMReceiverBank):
    return cls(16, 1.6e6, device="cpu", use_kernel=True)


def _iq(b=2, t=4096, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((b, t), generator=g), torch.randn((b, t), generator=g))


# -- off, and what turns spans on ---------------------------------------------

def test_off_spans_record_nothing_and_share_one_null_context():
    assert _off()
    with tracing.span("sdsp.a"):
        with tracing.span("sdsp.b"):
            pass
    NorthStarChain(device="cpu", use_kernel=True)(torch.randn(2, 8192))
    assert tracing.snapshot()["spans"] == []


def test_enable_turns_spans_on_until_disable():
    tracing.enable()
    assert not _off()
    with tracing.span("sdsp.a"):
        pass
    tracing.disable()
    assert _off()
    with tracing.span("sdsp.b"):
        pass
    assert _names() == ["sdsp.a"]


def test_the_environment_turns_spans_on_at_import():
    code = textwrap.dedent("""
        from simpledsp_tpu_torch.utils import tracing
        with tracing.span("sdsp.a"):
            pass
        tracing.disable()
        with tracing.span("sdsp.b"):
            pass
        print(tracing.span("x") is tracing.span("y"),
              [s["name"] for s in tracing.snapshot()["spans"]])
    """)
    env = dict(os.environ, SIMPLEDSP_TRACE="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=120, check=True).stdout
    assert out.strip().splitlines()[-1] == "False ['sdsp.a', 'sdsp.b']"


def test_a_running_profiler_turns_spans_on_and_records_ranges():
    from torch.profiler import ProfilerActivity, profile
    chain = NorthStarChain(device="cpu", use_kernel=True)
    x = torch.randn(2, 8192)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert not _off()
        chain(x)
        _bank()(_iq())
    assert _off()
    events = {e.name for e in prof.events()}
    assert CHAIN_SPANS | BANK_SPANS <= events
    spans = tracing.snapshot()["spans"]
    assert {s["name"] for s in spans} == CHAIN_SPANS | BANK_SPANS
    assert all(s["profiled"] for s in spans)
    chain(x)
    assert len(tracing.snapshot()["spans"]) == len(spans)


# -- what a span records -------------------------------------------------------

def test_nesting_gives_parents_calls_and_self_times():
    tracing.enable()
    for _ in range(2):
        with tracing.span("sdsp.outer"):
            with tracing.span("sdsp.inner"):
                with tracing.span("sdsp.leaf"):
                    pass
            with tracing.span("sdsp.inner"):
                pass
    spans = tracing.snapshot()["spans"]
    by_id = {s["id"]: s for s in spans}
    outer = [s for s in spans if s["name"] == "sdsp.outer"]
    assert len(outer) == 2 and outer[0]["call"] != outer[1]["call"]
    assert all(s["parent"] == 0 for s in outer)
    for s in spans:
        if s["name"] != "sdsp.outer":
            parent = by_id[s["parent"]]
            assert s["call"] == parent["call"]
            assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= parent["end_ns"]
        assert not s["profiled"]
    assert [by_id[s["parent"]]["name"] for s in spans
            if s["name"] == "sdsp.leaf"] == ["sdsp.inner"] * 2

    stats = tracing.span_stats()
    assert {k: v["count"] for k, v in stats.items()} == {
        "sdsp.outer": 2, "sdsp.inner": 4, "sdsp.leaf": 2}

    def ms(s):
        return (s["end_ns"] - s["start_ns"]) * 1e-6
    inner = sum(ms(s) for s in spans if s["name"] == "sdsp.inner")
    leaf = sum(ms(s) for s in spans if s["name"] == "sdsp.leaf")
    total = sum(ms(s) for s in outer)
    assert stats["sdsp.outer"]["total_ms"] == pytest.approx(total)
    assert stats["sdsp.outer"]["self_ms"] == pytest.approx(total - inner)
    assert stats["sdsp.inner"]["self_ms"] == pytest.approx(inner - leaf)
    assert stats["sdsp.leaf"]["self_ms"] == pytest.approx(leaf)

    # The first call left out: its three spans and their times go.
    later = tracing.span_stats(skip_calls=1)
    assert later["sdsp.outer"]["count"] == 1
    assert later["sdsp.inner"]["count"] == 2
    assert tracing.span_stats(profiled_only=True) == {}


def test_the_spans_kept_are_bounded_and_the_overflow_counted():
    extra = 10
    before = tracing.counters().get("tracing.dropped", 0)
    tracing.enable()
    for _ in range(tracing.MAX_SPANS + extra):
        with tracing.span("sdsp.a"):
            pass
    spans = tracing.snapshot()["spans"]
    assert len(spans) == tracing.MAX_SPANS
    assert tracing.counters()["tracing.dropped"] - before == extra
    calls = [s["call"] for s in spans]
    assert calls == list(range(calls[0], calls[0] + tracing.MAX_SPANS))
    tracing.reset()
    assert tracing.snapshot()["spans"] == []


def test_a_span_raised_through_is_recorded_and_closed():
    tracing.enable()
    with pytest.raises(ValueError):
        with tracing.span("sdsp.outer"):
            with tracing.span("sdsp.inner"):
                raise ValueError("x")
    with tracing.span("sdsp.next"):
        pass
    spans = tracing.snapshot()["spans"]
    assert [s["name"] for s in spans] == ["sdsp.inner", "sdsp.outer",
                                          "sdsp.next"]
    assert spans[2]["parent"] == 0


# -- counters --------------------------------------------------------------------

def test_counters_add_and_copy():
    tracing.count("test.things")
    tracing.count("test.things", 4)
    c = tracing.counters()
    assert c["test.things"] == 5
    c["test.things"] = 0
    assert tracing.counters()["test.things"] == 5


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_each_launch_count_reads_and_resets_through_the_counters(name):
    """As ``chip_smoke.zero_counts`` does: ``kernel.launches = 0``."""
    kernel = KERNELS[name]
    key = f"kernel.{name}.launches"
    saved = kernel.launches
    try:
        assert key in tracing.counters()
        kernel.launches = 0
        assert tracing.counters()[key] == 0
        tracing.count(kernel.launch_counter, 3)
        assert kernel.launches == 3
        kernel.launches += 1
        assert tracing.counters()[key] == 4
    finally:
        kernel.launches = saved


def test_every_kernel_counter_belongs_to_one_wrapper():
    keys = {k for k in tracing.counters() if k.startswith("kernel.")}
    assert keys == {f"kernel.{n}.launches" for n in KERNELS}
    assert len({k.launch_counter for k in KERNELS.values()}) == len(KERNELS)


# -- the port's spans and counters ------------------------------------------------

def test_the_chain_records_its_spans():
    tracing.enable()
    chain = NorthStarChain(device="cpu", use_kernel=True)
    x = torch.randn(3, 8192)
    chain(chain.frame_input(x.numpy()))
    spans = tracing.snapshot()["spans"]
    assert _names() == ["sdsp.chain.prepass", "sdsp.chain.launch",
                        "sdsp.chain.forward"]
    assert spans[0]["parent"] == spans[1]["parent"] == spans[2]["id"]
    assert len({s["call"] for s in spans}) == 1


def test_the_composable_chain_records_only_its_entry():
    tracing.enable()
    NorthStarChain(device="cpu", use_kernel=False)(torch.randn(2, 8192))
    assert _names() == ["sdsp.chain.forward"]


@pytest.mark.parametrize("cls", [FMReceiverBank, AMReceiverBank],
                         ids=lambda c: c.__name__)
def test_the_bank_records_its_spans_and_counts_its_calls(cls):
    bank = _bank(cls)
    before = tracing.counters().get("bank.calls", 0)
    tracing.enable()
    audio, state = bank(_iq())
    bank(_iq(seed=1), state)
    assert _names() == ["sdsp.bank.prefix", "sdsp.pfb.launch",
                        "sdsp.bank.forward"] * 2
    assert tracing.counters()["bank.calls"] - before == 2


def test_the_prefix_bytes_are_the_copies_counted_from_the_shapes():
    """The copies left beside the kernel make the new channelizer history,
    the last L-1 samples of [hist | x]: per plane that history read and
    written, from x's tail at T >= L-1 and from the history's tail and x
    below it; counted here from the tensors the copies make, at T = M decim
    (< L-1), L and 4096."""
    bank = _bank()
    h = bank.chan.hist_len
    for t in (bank.m * bank.decim, h + 1, 4096):
        xr, xi = _iq(b=3, t=t, seed=t)
        state = bank.init_state(3)
        state = state._replace(chan=type(state.chan)(*_iq(b=3, t=h, seed=1)))
        before = tracing.counters().get("bank.prefix_bytes", 0)
        chan = bank._next_history(xr, xi, state)
        moved = sum(2 * new.nbytes for new in chan)
        assert tracing.counters()["bank.prefix_bytes"] - before == moved
        for hist, x, new in ((state.chan.hist_r, xr, chan.hist_r),
                             (state.chan.hist_i, xi, chan.hist_i)):
            assert new.shape == (3, h) and new.is_contiguous()
            assert torch.equal(new, torch.cat([hist, x], -1)[:, -h:])
            assert new.data_ptr() not in (hist.data_ptr(), x.data_ptr())


@pytest.mark.parametrize("cls", [FMReceiverBank, AMReceiverBank],
                         ids=lambda c: c.__name__)
def test_direct_calls_count_the_calls_that_read_the_input_in_place(cls):
    """``bank.direct_calls`` rises by one on each fused ``__call__``, whose
    input reaches the kernel with no prefixed copy, and not on
    ``process_padded`` (a prefixed buffer) or the composable path."""
    bank = _bank(cls)

    def direct():
        return tracing.counters().get("bank.direct_calls", 0)

    before = direct()
    audio, state = bank(_iq())
    assert direct() - before == 1
    audio, state = bank(_iq(seed=1), state)
    assert direct() - before == 2
    front, total = bank.padded_spec(4096)
    bufs = tuple(torch.zeros(2, total) for _ in range(2))
    for buf, x in zip(bufs, _iq(seed=2)):
        buf[:, front:front + 4096] = x
    bank.process_padded(bufs, state)
    cls(16, 1.6e6, device="cpu", use_kernel=False)(_iq())
    assert direct() - before == 2


# -- the radar and the small-DFT route ---------------------------------------------

RADAR_SPANS = ["sdsp.radar.range", "sdsp.radar.doppler", "sdsp.radar.map",
               "sdsp.radar.cfar"]


def _radar_call(beams=2, pulses=16, samples=256, taps=16):
    """One map and its CFAR, as the benchmark's radar system calls them."""
    tx_re, tx_im = radar.lfm_chirp(taps, 0.8)
    xr, xi = _iq(b=beams * pulses, t=samples)
    power = radar.range_doppler_map(xr.view(beams, pulses, samples),
                                    xi.view(beams, pulses, samples),
                                    tx_re, tx_im, window="hann")
    return power, radar.cfar_ca(power, guard=2, train=12, pfa=1e-5)


def test_the_radar_records_its_spans_once_a_call_nested_as_stated():
    tracing.enable()
    for _ in range(2):
        _radar_call()
    spans = tracing.snapshot()["spans"]
    assert _names() == RADAR_SPANS * 2
    for call in (spans[:4], spans[4:]):
        rng, dop, rdm, cfar = call
        assert rng["parent"] == dop["parent"] == rdm["id"]
        assert rdm["parent"] == cfar["parent"] == 0
        assert rng["call"] == dop["call"] == rdm["call"] != cfar["call"]
        assert rdm["start_ns"] <= rng["start_ns"] <= rng["end_ns"] \
            <= dop["start_ns"] <= dop["end_ns"] <= rdm["end_ns"] \
            <= cfar["start_ns"]
    assert {k: v["count"] for k, v in tracing.span_stats().items()} == {
        name: 2 for name in RADAR_SPANS}


def test_the_radar_counts_its_maps_and_cells():
    before = tracing.counters()
    power, _ = _radar_call(beams=3)
    after = tracing.counters()
    assert after["radar.maps"] - before.get("radar.maps", 0) == 1
    assert after["radar.cells"] - before.get("radar.cells", 0) \
        == power.numel() == 3 * 16 * 256
    assert after["radar.cfars"] - before.get("radar.cfars", 0) == 1
    assert after["kernel.cfar.launches"] == before["kernel.cfar.launches"]


def _products(before):
    return tracing.counters()["fft.dft_products"] - before.get(
        "fft.dft_products", 0)


@pytest.mark.parametrize("rows, n, want", [
    (2 * 256, 16, 2),     # 16 pulses x 2 beams x 256 cells: one CPU block
    (2 * 256, 128, 4),    # blocks of 256 rows at n = 128 on the CPU
    (300, 128, 4),        # the last block zero-padded
    (5, 3, 2),
])
def test_dft_products_count_every_product_of_the_small_dft_route(rows, n,
                                                                 want):
    before = tracing.counters()
    xr, xi = _iq(b=rows, t=n)
    yr, _ = tfft.fft_ri(xr, xi)
    assert _products(before) == want
    assert want == 2 * -(-rows // tfft._dft_rows(n, xr.device))
    assert torch.allclose(yr, torch.fft.fft(torch.complex(xr, xi)).real,
                          atol=1e-4)


def test_dft_products_of_a_radar_map_are_its_transforms_products():
    """2 beams x 16 pulses x 256 cells with 16 taps on the CPU: the range
    transforms of 512 points split 16 x 32 (one product a plane at each
    factor, forward and inverse: 8) and the 16-point Doppler transform of
    512 rows (2).  On a card the range transforms run the frames FFT
    kernel and only the Doppler products count: 64 at 64 beams x 128
    pulses x 4096 cells."""
    before = tracing.counters()
    _radar_call()
    assert _products(before) == 8 + 2
    card = torch.device("cuda")
    assert 2 * -(-(64 * 4096) // tfft._dft_rows(128, card)) == 64
