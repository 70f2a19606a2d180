"""The metrics read from the program's own spans and counters
(``simpledsp_tpu_torch/utils/tracing.py``): present and positive in a traced
run of their cells, absent from an untraced one; the bank's prefix bytes
equal to the count from the shapes; and on a card, the program's spans
leave the device-time readings alone."""

import contextlib

import pytest
import torch

from dspbench import run
from dspbench.harness import Cell, run_cell
from dspbench.registry import Registry
from simpledsp_tpu_torch.kernels.pfb import flat_pad_to
from simpledsp_tpu_torch.utils import tracing

SMALL = {
    "chain_blocking": ({"channels": 4}, {"samples_per_call": 1 << 14}),
    "fm_bank_bulk": ({"streams": 2}, {"samples_per_call": 1 << 14}),
}
NEW = {
    "chain_blocking": {"chain_prepass_host_ms", "chain_launch_host_ms"},
    "fm_bank_bulk": {"bank_entry_host_ms", "pfb_launch_host_ms",
                     "bank_prefix_mb"},
}


def _run(name, trace, device=torch.device("cpu"), calls=4):
    """A short run of the cell ``name``: small on the CPU, at the cell's
    own sizes on a card."""
    params, traffic = SMALL[name] if device.type == "cpu" else ({}, {})
    cell = Cell.load(Registry(), name, params,
                     dict(traffic, keep_within=2, trace_calls=calls,
                          trace_skip=1))
    tracing.reset()
    record = run_cell(cell, 2 ** 31 + 77, 0.2, trace, device,
                      stop_window=lambda n, start: n >= 4)
    ctx = run.Context(cell, [record], 1.0)
    return ctx, run.assemble(Registry(), ctx, trace, device.type)


def prefix_mb(cell) -> float:
    """The bytes a call's [hist | x | pad] copies move, from the shapes, in
    MB: per plane the pad's zeros written, the prefixed row read and written
    by the cat, and the new history read and written by its clone."""
    p = cell.params
    sut = cell.system.System(p, cell.traffic, torch.device("cpu"))
    ops = sut.model.chan.kernel_ops
    b, t, h = p["streams"], cell.traffic["samples_per_call"], \
        sut.model.chan.hist_len
    width = flat_pad_to(ops, t // p["channels"])
    pad = width - h - t
    per_plane = b * 4 * (pad + 2 * width + 2 * h)
    return 2 * per_plane / 1e6


@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_span_metrics_appear_in_a_traced_run(name):
    ctx, result = _run(name, True)
    assert result["correct"], result["checks"]
    got = {k: v["value"] for k, v in result["metrics"].items()
           if k in NEW[name]}
    assert set(got) == NEW[name]
    assert all(v > 0 for v in got.values()), got
    if name == "fm_bank_bulk":
        assert got["bank_prefix_mb"] == prefix_mb(ctx.cell)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_an_untraced_run_lacks_them(name):
    _, result = _run(name, False)
    assert not NEW[name] & set(result["metrics"])


def test_the_readers_skip_the_first_calls_of_the_segment():
    """The chain's readers count the traced calls after ``trace_skip``: one
    prepass and one launch span a call."""
    _run("chain_blocking", True, calls=5)
    stats = tracing.span_stats(profiled_only=True, skip_calls=1)
    assert stats["sdsp.chain.forward"]["count"] == 4
    assert stats["sdsp.chain.prepass"]["count"] == 4
    assert stats["sdsp.chain.launch"]["count"] == 4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _no_spans(monkeypatch):
    monkeypatch.setattr(tracing, "span",
                        lambda name: contextlib.nullcontext())


@pytest.mark.cuda
@pytest.mark.parametrize("name, metric", [("chain_bulk", "chain_prepass_ms"),
                                          ("fm_bank_bulk", "bank_prefix_ms")])
def test_spans_leave_the_device_readings_alone(card, name, metric,
                                               monkeypatch):
    """At the cell's own sizes: no ``sdsp.`` range counts as device work,
    and the device ms beside the kernel read the same with the program's
    spans and without them."""
    readings = {}
    for spans in (True, False, True, False):
        with monkeypatch.context() as m:
            if not spans:
                _no_spans(m)
            ctx, result = _run(name, True, card, calls=64)
        assert result["correct"], result["checks"]
        assert not [k for k in ctx.traces[0]["device"] if "sdsp." in k]
        readings.setdefault(spans, []).append(
            result["metrics"][metric]["value"])
    on, off = min(readings[True]), min(readings[False])
    assert abs(on - off) <= 0.02 * off, readings


@pytest.mark.cuda
def test_the_blocking_chains_idle_falls_in_its_spans(card):
    """With one call in flight the entry's host work runs in series with
    the card: some of the device's idle lies inside the program's spans."""
    ctx, result = _run("chain_blocking", True, card, calls=64)
    assert result["correct"], result["checks"]
    gaps = ctx.traces[0]["gaps"]
    assert any(k.startswith("sdsp.") for k in gaps), gaps
