"""The controls on the card: at a size a test run can hold, the program's
numbers stay under the cell's limits and the control's come out over them.
Run on a machine with a card:

    python3 -m pytest dspbench/tests -m cuda

The readings that set the limits are made at the cells' own sizes by
``python3 -m dspbench.controls`` (PERF.md)."""

import pytest
import torch

from dspbench.harness import Cell, run_cell
from dspbench.registry import Registry

SMALL = {
    "chain_bulk": ({"channels": 8}, {"samples_per_call": 1 << 18}),
    "chain_blocking": ({"channels": 8}, {"samples_per_call": 1 << 18}),
    "fm_bank_bulk": ({"streams": 4}, {"samples_per_call": 1 << 18}),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SMALL))
def test_program_under_and_control_over_the_limit(card, name):
    params, traffic = SMALL[name]
    cell = Cell.load(Registry(), name, params, traffic)
    limits = cell.config["limits"]
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        sound = run_cell(cell, seed, 0.5, False, card)
        control = run_cell(cell, seed, 0.5, False, card, control=True)
        for k, limit in limits.items():
            assert sound["numbers"][k] <= limit, (seed, sound["numbers"])
            assert control["numbers"][k] > limit, (seed, control["numbers"])


@pytest.fixture
def four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")


@pytest.mark.cuda
def test_pod_program_under_and_control_over_the_limit(four_cards):
    from dspbench.pod import spawn
    cell = Cell.load(Registry(), "chain_pod_sp4", {"channels": 8},
                     {"samples_per_call": 4 * (1 << 18), "stop_every": 2})
    limit = cell.config["limits"]["spec_rel_err"]
    seeds = [2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3]
    for control in (False, True):
        for seed, records in zip(seeds, spawn(cell, seeds, 0.5, False,
                                              control=control)):
            worst = max(r["numbers"]["spec_rel_err"] for r in records)
            assert (worst > limit) == control, (seed, control, worst)
