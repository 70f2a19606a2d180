"""A run of each cell with its timed path broken underneath comes out not
correct; a sound run comes out correct.  The cells run small on the CPU
(the port's plain versions of its kernels), past the harness's look for a
card."""

import argparse
import json

import pytest
import torch

from dspbench import run
from dspbench.harness import Cell, process_start, run_cell
from dspbench.pod import launch
from dspbench.registry import Registry

SMALL = {
    "chain_bulk": ({"channels": 4}, {"samples_per_call": 1 << 15}),
    "chain_blocking": ({"channels": 4}, {"samples_per_call": 1 << 14}),
    "fm_bank_bulk": ({"streams": 2}, {"samples_per_call": 1 << 14}),
}


def _cell(name):
    params, traffic = SMALL[name]
    return Cell.load(Registry(), name, params,
                     dict(traffic, keep_within=2, trace_calls=3,
                          trace_skip=1))


def _result(cell, **kw):
    record = run_cell(cell, 2 ** 31 + 99, 0.2, False, torch.device("cpu"),
                      stop_window=lambda n, start: n >= 4, **kw)
    return run.assemble(Registry(), run.Context(cell, [record], 1.0), False,
                        "cpu")


def unchanged(call):
    """A step that returns its state unchanged."""
    def broken(x, state):
        out, _ = call(x, state)
        return out, state
    return broken


def _rows(out):
    return list(out) if isinstance(out, tuple) else [out]


def _pack(out, parts):
    return tuple(parts) if isinstance(out, tuple) else parts[0]


def half_batch(call):
    """Half of the batch left out: the first half's rows stand in for the
    rest."""
    def broken(x, state):
        out, state = call(x, state)
        parts = []
        for t in _rows(out):
            t = t.clone()
            h = t.shape[0] // 2
            t[h:] = t[:h]
            parts.append(t)
        return _pack(out, parts), state
    return broken


def altered(call):
    """One answer altered where it is produced: a value of the last row
    off by a thousandth of the largest."""
    def broken(x, state):
        out, state = call(x, state)
        parts = [t.clone() for t in _rows(out)]
        flat = parts[0].reshape(parts[0].shape[0], -1)
        flat[-1, 5] += 1e-3 * flat.abs().max()
        return _pack(out, parts), state
    return broken


def not_a_number(call):
    """One answer that is not a number: a NaN in one value of the last
    row, as a kernel that reads memory it never wrote would leave."""
    def broken(x, state):
        out, state = call(x, state)
        parts = [t.clone() for t in _rows(out)]
        parts[0].reshape(parts[0].shape[0], -1)[-1, 5] = float("nan")
        return _pack(out, parts), state
    return broken


@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_sound_run_is_correct(name):
    result = _result(_cell(name))
    assert result["correct"], result["checks"]
    assert result["failed"] == 0


@pytest.mark.parametrize("fault", [unchanged, half_batch, altered,
                                   not_a_number],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_broken_step_is_not_correct(name, fault):
    result = _result(_cell(name), fault=fault)
    assert not result["correct"], result["checks"]
    assert result["failed"] >= 1
    json.dumps(result, allow_nan=False)


def _pod_result(capsys, fault):
    entry = {"name": "chain_pod_sp4", "config": "northstar_chain_n4096",
             "traffic": "ahead_sp4_2p24", "chips": 4}
    cell = Cell.from_entry(Registry(), entry, {"channels": 2},
                           {"samples_per_call": 4 * 8192, "keep_within": 2,
                            "trace_calls": 3, "trace_skip": 1,
                            "stop_every": 2})
    args = argparse.Namespace(seed=2 ** 31 + 5, seconds=0.5, trace=0)
    rc = launch(Registry(), cell, args, process_start(), device_type="cpu",
                fault=fault)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("fault", [None, "no_exchange"])
def test_the_pod_without_its_exchange_is_not_correct(capsys, fault):
    """Four gloo ranks on the CPU: the sharded chain is correct with its
    all_gather and all_reduce, and not correct with each shard starting
    from the stream's incoming state."""
    result = _pod_result(capsys, fault)
    assert result["correct"] == (fault is None), result["checks"]
    assert result["device"]["count"] == 4


def test_without_a_card_a_run_exits_nonzero_and_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    rc = run.main(["--workload", "chain_bulk", "--seed", "7",
                   "--seconds", "1"])
    assert rc == 2
    assert capsys.readouterr().out == ""
