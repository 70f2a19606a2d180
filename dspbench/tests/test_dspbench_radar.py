"""The pulse-Doppler cell (``radar_cpi_bulk``): its work count against a hand
sum, its reference against direct loops, the registry taking it up, its
per-layer metrics in a traced run on the CPU, a sound run correct and each
planted fault not; on a card, the program under and the control over a
limit."""

import math

import pytest
import torch

from dspbench import run
from dspbench.harness import Cell, run_cell
from dspbench.reference import pulse_doppler as ref
from dspbench.registry import Registry
from dspbench.roofline import bound_s
from dspbench.roofline_radar import (pulse_doppler_work, range_length,
                                     range_transforms_work)

CELL = "radar_cpi_bulk"
NEW = {"fft_kernel_roofline", "radar_dft_ms", "radar_elementwise_ms",
       "radar_host_ms", "dft_products", "step_mfu.radar", "device_idle.radar"}
SMALL = {"beams": 2, "pulses": 64, "range_samples": 512, "taps": 32}


# -- the work count ----------------------------------------------------------

def test_the_work_by_hand():
    # 2 beams x 4 pulses x 12 samples, 5 taps: L = 16; train 2.
    w = pulse_doppler_work(2, 4, 12, 5, 2)
    rows, cells = 8, 96
    fft16 = 5 * 16 * 4
    fft4 = 5 * 4 * 2
    flops = (rows * 2 * fft16 + rows * 16 * 6 + cells * 2 + 2 * 12 * fft4
             + cells * 3 + cells * 5)
    assert w["flops"] == pytest.approx(flops)
    assert w["bytes"] == pytest.approx(cells * (8 + 4 + 1))
    assert w["range_flops"] == pytest.approx(rows * 2 * fft16)
    assert w["range_bytes"] == pytest.approx(rows * 2 * 16 * 16)
    assert range_length(12, 5) == 16 and range_length(4096, 128) == 8192
    assert range_length(13, 4) == 16 and range_length(14, 4) == 32


def test_the_cells_work_is_operations_bound_and_its_transforms_bytes_bound():
    w = pulse_doppler_work(64, 128, 4096, 128, 12)
    assert bound_s(w["flops"], w["bytes"]) == pytest.approx(w["flops"] / 67e12)
    r = range_transforms_work(64, 128, 4096, 128)
    assert r["bytes"] == 2 * 8192 * 8192 * 16
    assert bound_s(r["flops"], r["bytes"]) == pytest.approx(
        r["bytes"] / 3.35e12)


# -- the reference against direct loops ---------------------------------------

def _direct(z, tx, guard, train, pfa):
    """The map and the CFAR one cell at a time."""
    b, p, n = z.shape
    k = tx.shape[0]
    w = [0.5 - 0.5 * math.cos(2 * math.pi * i / p) for i in range(p)]
    power = torch.zeros((b, p, n), dtype=torch.float64)
    for bb in range(b):
        y = torch.zeros((p, n), dtype=torch.complex128)
        for pp in range(p):
            for r in range(n):
                for kk in range(k):
                    if r + kk < n:
                        y[pp, r] += z[bb, pp, r + kk] * tx[kk].conj()
        for q in range(p):
            for r in range(n):
                d = sum(w[pp] * y[pp, r]
                        * complex(math.cos(-2 * math.pi * q * pp / p),
                                  math.sin(-2 * math.pi * q * pp / p))
                        for pp in range(p))
                power[bb, (q + p // 2) % p, r] = abs(d) ** 2
    n_train = 2 * train
    alpha = n_train * (pfa ** (-1.0 / n_train) - 1.0)
    thresh = torch.zeros_like(power)
    for r in range(n):
        s = sum(power[..., (r + j) % n] + power[..., (r - j) % n]
                for j in range(guard + 1, guard + train + 1))
        thresh[..., r] = alpha * s / n_train
    return power, power > thresh, thresh


def test_the_reference_against_direct_loops():
    g = torch.Generator().manual_seed(5)
    z = torch.complex(torch.randn((2, 4, 12), generator=g,
                                  dtype=torch.float64),
                      torch.randn((2, 4, 12), generator=g,
                                  dtype=torch.float64))
    z[1, :, 3:6] += 4.0 * ref.chirp(3, 0.8)
    power, det, thresh = ref.detect(z, taps=3, bandwidth=0.8, guard=1,
                                    train=2, pfa=1e-2)
    want, want_det, want_thresh = _direct(z, ref.chirp(3, 0.8), 1, 2, 1e-2)
    torch.testing.assert_close(power, want, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(thresh, want_thresh, rtol=1e-12, atol=1e-12)
    assert torch.equal(det, want_det) and bool(det.any())


def test_the_reference_chirp_and_window():
    tx = ref.chirp(8, 0.5)
    assert torch.allclose(tx.abs(), torch.ones(8, dtype=torch.float64))
    t = 3
    assert complex(tx[t]) == pytest.approx(
        complex(math.cos(math.pi * 0.5 * (t - 4) ** 2 / 8),
                math.sin(math.pi * 0.5 * (t - 4) ** 2 / 8)))
    assert ref.hann(4).tolist() == pytest.approx([0.0, 0.5, 1.0, 0.5])


# -- the registry and the readers ---------------------------------------------

def test_the_registry_takes_the_cell():
    reg = Registry()
    cell = Cell.load(reg, CELL)
    assert cell.config["name"] == "pulse_doppler_b64p128r4096"
    assert cell.config["reduced"] == []
    assert cell.entry["chips"] == cell.traffic["ranks"] == 1
    assert set(cell.config["limits"]) == {"rdm_rel_err", "det_mismatch"}
    assert {m["name"] for m in reg.end_to_end_for(CELL)} == {"throughput",
                                                             "setup_s"}
    assert {m["name"] for m in reg.per_layer_for(CELL)} == NEW
    p = cell.params
    assert (p["beams"], p["pulses"], p["range_samples"], p["taps"]) == (
        64, 128, 4096, 128)
    assert cell.traffic["samples_per_call"] == p["pulses"] * p["range_samples"]
    assert reg.reader("step_mfu.radar") is reg.reader("step_mfu")
    assert reg.reader("device_idle.radar") is reg.reader("device_idle")


def _cell(**traffic):
    return Cell.load(Registry(), CELL, SMALL, dict(
        samples_per_call=SMALL["pulses"] * SMALL["range_samples"],
        keep_within=2, trace_calls=3, trace_skip=1, **traffic))


def _result(cell, trace=False, **kw):
    record = run_cell(cell, 2 ** 31 + 99, 0.2, trace, torch.device("cpu"),
                      stop_window=lambda n, start: n >= 4, **kw)
    return run.assemble(Registry(), run.Context(cell, [record], 1.0), trace,
                        "cpu")


def test_a_mix_of_another_cpi_size_is_refused():
    cell = Cell.load(Registry(), CELL, SMALL)
    with pytest.raises(ValueError, match="samples a beam's CPI"):
        cell.system.System(cell.params, cell.traffic, torch.device("cpu"))


def test_the_program_metrics_in_a_traced_run():
    """On the CPU the device-trace metrics find no device time; the span and
    counter metrics read the program.  Products a map at 2 beams x 64
    pulses x 512 cells with 32 taps, in the CPU's blocks of 2^15 values:
    the range transforms of 1024 = 32 x 32 points, 4096 rows a factor in
    blocks of 1024 (8 a factor, 32 forward and inverse), and the 64-point
    Doppler transform of 1024 rows in blocks of 512 (4)."""
    from simpledsp_tpu_torch.utils import tracing
    for name in ("fft.dft_products", "radar.maps"):
        # What other runs in this process counted: the benchmark's own
        # process runs one cell.
        tracing.count(name, -tracing.counters().get(name, 0))
    result = _result(_cell(), trace=True)
    assert result["correct"], result["checks"]
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(got) == {"radar_host_ms", "dft_products"}
    assert got["dft_products"] == 32 + 4
    assert got["radar_host_ms"] > 0
    untraced = _result(_cell())
    assert set(untraced["metrics"]) == {"throughput", "setup_s"}


# -- faults --------------------------------------------------------------------

def train_off_by_one(call):
    """The CFAR run with one training cell a side too many."""
    from simpledsp_tpu_torch.models.radar import cfar_ca

    def broken(x, state):
        (power, _), state = call(x, state)
        det, _ = cfar_ca(power, guard=2, train=13, pfa=1e-5)
        return (power, det), state
    return broken


def beam_left_out(call):
    """The last beam's map and detections are the first beam's."""
    def broken(x, state):
        (power, det), state = call(x, state)
        power, det = power.clone(), det.clone()
        power[-1], det[-1] = power[0], det[0]
        return (power, det), state
    return broken


def not_a_number(call):
    """A NaN in one cell of the last beam's map."""
    def broken(x, state):
        (power, det), state = call(x, state)
        power = power.clone()
        power[-1, 0, 5] = float("nan")
        return (power, det), state
    return broken


def test_a_sound_run_is_correct():
    result = _result(_cell())
    assert result["correct"], result["checks"]
    assert result["failed"] == 0
    assert result["checks"]["det_mismatch"]["value"] == 0


@pytest.mark.parametrize("fault, number", [
    (train_off_by_one, "det_mismatch"), (beam_left_out, "rdm_rel_err"),
    (not_a_number, "rdm_rel_err")], ids=lambda f: getattr(f, "__name__", f))
def test_a_broken_step_is_not_correct(fault, number):
    result = _result(_cell(), fault=fault)
    assert not result["correct"], result["checks"]
    assert result["failed"] >= 1
    check = result["checks"][number]
    assert check["value"] == "inf" or check["value"] > check["limit"]


def test_the_control_fails_the_map_limit():
    result = _result(_cell(), control=True)
    assert not result["correct"]
    check = result["checks"]["rdm_rel_err"]
    assert check["value"] > check["limit"]


# -- on a card -----------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_program_under_and_control_over_the_limit_on_the_card(card):
    """8 of the 64 beams at the cell's widths."""
    cell = Cell.load(Registry(), CELL, {"beams": 8})
    limits = cell.config["limits"]
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        sound = run_cell(cell, seed, 0.5, False, card)
        control = run_cell(cell, seed, 0.5, False, card, control=True)
        assert all(sound["numbers"][k] <= v for k, v in limits.items()), (
            seed, sound["numbers"])
        assert any(control["numbers"][k] > v for k, v in limits.items()), (
            seed, control["numbers"])
