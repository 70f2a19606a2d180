"""The F-engine cell (``fengine_4k_bulk``): its work count against a hand
sum, its reference against a direct loop, the registry taking it up, its
per-layer metrics in a traced run on the CPU, a sound run correct and each
planted fault not, no module of JAX loaded; on a card, the program under
and the control over the limit."""

import json
import math
import subprocess
import sys

import pytest
import torch

from dspbench import run
from dspbench.harness import Cell, run_cell
from dspbench.reference import pfb_fengine as ref
from dspbench.registry import ROOT, Registry
from dspbench.roofline import bound_s
from dspbench.roofline_fengine import fengine_work, half_transforms_work

CELL = "fengine_4k_bulk"
NEW = {"chan_fft_roofline", "chan_elementwise_ms", "chan_host_ms",
       "chan_prefix_mb", "step_mfu.fengine", "device_idle.fengine"}
SMALL = {"inputs": 2, "branches": 256, "taps": 4, "channels_out": 128}
SMALL_T = 256 * 16


# -- the work count ----------------------------------------------------------

def test_the_work_by_hand():
    # 2 streams x 64 samples, M 16, K 3: 4 spectra a stream, 8 in all.
    w = fengine_work(2, 64, 16, 3)
    n, frames = 128, 8
    fft16 = 2.5 * 16 * 4
    assert w["flops"] == pytest.approx(n * 6 + frames * fft16)
    assert w["bytes"] == pytest.approx(4 * (n + frames * 8 * 2 + 2 * 2 * 47))
    assert w["fft_flops"] == pytest.approx(frames * 5 * 8 * 3)
    assert w["fft_bytes"] == pytest.approx(frames * 8 * 16)
    assert half_transforms_work(2, 64, 16) == {"flops": w["fft_flops"],
                                               "bytes": w["fft_bytes"]}


def test_the_cells_work_is_bytes_bound():
    w = fengine_work(16, 2 ** 22, 8192, 16)
    n = 16 * 2 ** 22
    assert w["flops"] == pytest.approx(n * 64.5)
    assert w["bytes"] == pytest.approx(8 * n + 8 * 16 * 131071)
    assert bound_s(w["flops"], w["bytes"]) == pytest.approx(
        w["bytes"] / 3.35e12)
    assert w["fft_bytes"] == 8192 * 4096 * 16
    assert bound_s(w["fft_flops"], w["fft_bytes"]) == pytest.approx(
        w["fft_bytes"] / 3.35e12)


# -- the reference against a direct loop --------------------------------------

def _direct(x, h, m, prefix):
    """The channels one value at a time, from the definition."""
    k = len(h) // m
    t = len(x) - prefix
    out = []
    for g in range(t // m):
        v = []
        for r in range(m):
            s = 0.0
            for j in range(k):
                i = prefix + (g - j) * m - r
                if i >= 0:
                    s += h[j * m + r] * x[i]
            v.append(s)
        out.append([sum(v[r] * complex(math.cos(2 * math.pi * c * r / m),
                                       math.sin(2 * math.pi * c * r / m))
                        for r in range(m)) for c in range(m // 2)])
    return torch.tensor(out, dtype=torch.complex128)


@pytest.mark.parametrize("prefix", [0, 5, 23])
def test_the_reference_against_a_direct_loop(prefix):
    g = torch.Generator().manual_seed(prefix)
    m, k = 8, 3
    x = torch.randn(prefix + 5 * m, generator=g, dtype=torch.float64)
    h = ref.prototype(m, k)
    want = _direct(x.tolist(), h.tolist(), m, prefix)
    for block in (1, 2, 32):
        got = ref.channels(x, h, m, prefix=prefix, block=block)
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_the_reference_prototype_and_its_rounding():
    h = ref.prototype(16, 4)
    assert h.shape == (64,) and float(h.sum()) == pytest.approx(1.0)
    assert torch.allclose(h, h.flip(0), rtol=0, atol=1e-18)
    assert int(h.argmax()) in (31, 32)
    x = torch.randn(2, 64 + 15, dtype=torch.float64)
    exact = ref.channels(x, h, 16, prefix=15)
    rel = {}
    for rounding in ("bfloat16", "tf32"):
        got = ref.channels(x, h, 16, prefix=15, rounding=rounding)
        rel[rounding] = ((got - exact).abs().norm()
                         / exact.abs().norm()).item()
    assert 1e-4 < rel["tf32"] < 2e-3 < rel["bfloat16"] < 2e-2
    # TF32 keeps 11 of float32's 24 bits: 1 + 2^-11 rounds to even, 1 +
    # 3 x 2^-11 up, and float32's exponent range stays.
    v = torch.tensor([1 + 2 ** -11, 1 + 3 * 2 ** -11, -1e-30],
                     dtype=torch.float64)
    assert ref._rounded(v, "tf32").tolist() == pytest.approx(
        [1.0, 1 + 2 ** -9, -1e-30], rel=1e-3)
    with pytest.raises(ValueError, match="rounding"):
        ref.channels(x, h, 16, rounding="float16")


# -- the registry and the readers ---------------------------------------------

def test_the_registry_takes_the_cell():
    reg = Registry()
    cell = Cell.load(reg, CELL)
    assert cell.config["name"] == "meerkat_fengine_l4k_i16"
    entry = [c for c in reg.bench["configs"]
             if c["name"] == "meerkat_fengine_l4k_i16"][0]
    assert entry["reduced"] == ["inputs"]
    assert cell.entry["chips"] == cell.traffic["ranks"] == 1
    assert set(cell.config["limits"]) == {"chan_rel_err"}
    assert {m["name"] for m in reg.end_to_end_for(CELL)} == {"throughput",
                                                             "setup_s"}
    assert {m["name"] for m in reg.per_layer_for(CELL)} == NEW
    p = cell.params
    assert (p["inputs"], p["branches"], p["taps"], p["channels_out"]) == (
        16, 8192, 16, 4096)
    assert cell.traffic["samples_per_call"] == 2 ** 22
    assert reg.reader("step_mfu.fengine") is reg.reader("step_mfu")
    assert reg.reader("device_idle.fengine") is reg.reader("device_idle")


def _cell(**traffic):
    return Cell.load(Registry(), CELL, SMALL, dict(
        samples_per_call=SMALL_T, keep_within=2, trace_calls=3,
        trace_skip=1, **traffic))


def _result(cell, trace=False, **kw):
    record = run_cell(cell, 2 ** 31 + 77, 0.2, trace, torch.device("cpu"),
                      stop_window=lambda n, start: n >= 4, **kw)
    return run.assemble(Registry(), run.Context(cell, [record], 1.0), trace,
                        "cpu")


def test_a_mix_shorter_than_the_history_is_refused():
    cell = Cell.load(Registry(), CELL, SMALL, {"samples_per_call": 512})
    with pytest.raises(ValueError, match="history of 1023"):
        cell.system.System(cell.params, cell.traffic, torch.device("cpu"))


def test_the_program_metrics_in_a_traced_run():
    """On the CPU the device-trace metrics find no device time; the span and
    counter metrics read the program.  A call's history concatenation reads
    and writes [hist | x] (1023 + 4096 samples a stream) and the new
    history's copy reads and writes 1023, in float32."""
    from simpledsp_tpu_torch.utils import tracing
    for name in ("chan.calls", "chan.prefix_bytes"):
        # What other runs in this process counted: the benchmark's own
        # process runs one cell.
        tracing.count(name, -tracing.counters().get(name, 0))
    result = _result(_cell(), trace=True)
    assert result["correct"], result["checks"]
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(got) == {"chan_host_ms", "chan_prefix_mb"}
    assert got["chan_prefix_mb"] == 2 * (2 * (1023 + 4096) + 2 * 1023) * 4 / 1e6
    assert got["chan_host_ms"] > 0
    untraced = _result(_cell())
    assert set(untraced["metrics"]) == {"throughput", "setup_s"}


# -- faults --------------------------------------------------------------------

def history_dropped(call):
    """Every call starts from rest: the carried history is thrown away."""
    def broken(x, state):
        return call(x, None)
    return broken


def bfloat16_operands(call):
    """The FIR's input and taps rounded to bfloat16 in the program."""
    def broken(x, state):
        model = call.__self__.model
        taps = model._branch
        model._branch = torch.as_tensor(taps).to(torch.bfloat16).double(
        ).numpy()
        try:
            return call(x.to(torch.bfloat16).float(), state)
        finally:
            model._branch = taps
    return broken


def channel_sign_flipped(call):
    """One channel's imaginary part negated in every spectrum."""
    def broken(x, state):
        (yr, yi), state = call(x, state)
        yi = yi.clone()
        yi[..., 5] = -yi[..., 5]
        return (yr, yi), state
    return broken


def test_a_sound_run_is_correct():
    result = _result(_cell())
    assert result["correct"], result["checks"]
    assert result["failed"] == 0
    assert result["checks"]["chan_rel_err"]["value"] < 2e-6


@pytest.mark.parametrize("fault", [history_dropped, bfloat16_operands,
                                   channel_sign_flipped],
                         ids=lambda f: f.__name__)
def test_a_broken_step_is_not_correct(fault):
    result = _result(_cell(), fault=fault)
    assert not result["correct"], result["checks"]
    assert result["failed"] >= 1
    check = result["checks"]["chan_rel_err"]
    assert check["value"] == "inf" or check["value"] > check["limit"]


def test_the_control_fails_the_limit():
    result = _result(_cell(), control=True)
    assert not result["correct"]
    check = result["checks"]["chan_rel_err"]
    assert check["value"] > check["limit"]


PROBE = r'''
import json, sys, torch
from dspbench.harness import Cell, forbidden_modules, run_cell
from dspbench.registry import Registry
reg = Registry()
for m in reg.per_layer_for("fengine_4k_bulk"):
    reg.reader(m["name"])
cell = Cell.load(reg, "fengine_4k_bulk", json.loads(sys.argv[1]),
                 dict(samples_per_call=int(sys.argv[2]), keep_within=2))
run_cell(cell, 13, 0.05, False, torch.device("cpu"),
         stop_window=lambda n, start: n >= 4)
print(json.dumps({"loaded": forbidden_modules()}))
'''


def test_no_module_of_jax_or_the_jax_package_is_loaded():
    out = subprocess.run([sys.executable, "-c", PROBE, json.dumps(SMALL),
                          str(SMALL_T)], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {"loaded": []}


# -- on a card -----------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_program_under_and_control_over_the_limit_on_the_card(card):
    """4 of the 16 inputs at the cell's widths."""
    cell = Cell.load(Registry(), CELL, {"inputs": 4})
    limit = cell.config["limits"]["chan_rel_err"]
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        sound = run_cell(cell, seed, 0.5, False, card)
        control = run_cell(cell, seed, 0.5, False, card, control=True)
        assert sound["numbers"]["chan_rel_err"] <= limit / 10, (
            seed, sound["numbers"])
        assert control["numbers"]["chan_rel_err"] > limit, (
            seed, control["numbers"])
