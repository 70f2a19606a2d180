"""The harness finds a configuration, a mix and a metric by name, and takes
up new ones as new files, with no edit to a file it has."""

import json
import shutil
import textwrap

import pytest
import torch

from dspbench.harness import Cell, run_cell
from dspbench.registry import BENCH_DIR, ROOT, Registry
from dspbench.run import Context, assemble


def test_every_cell_finds_its_pieces_by_name():
    reg = Registry()
    for w in reg.bench["workloads"]:
        cell = Cell.load(reg, w["name"])
        assert cell.config["name"] == w["config"]
        assert hasattr(cell.system, "System")
        assert cell.traffic["dispatch"] in ("ahead", "blocking")
        assert cell.traffic["ranks"] == w["chips"]
        assert set(cell.config["limits"])
        for m in reg.per_layer_for(w["name"]):
            assert callable(reg.reader(m["name"]).read)
        for m in reg.end_to_end_for(w["name"]):
            assert callable(reg.end_to_end(m["name"]).read)
        names = {m["name"] for m in reg.end_to_end_for(w["name"])}
        assert "setup_s" in names and len(names) >= 2
        assert reg.per_layer_for(w["name"])


def test_metric_lists_follow_benchmark_json():
    reg = Registry()
    assert {m["name"] for m in reg.per_layer_for("chain_bulk")} == {
        "chain_kernel_roofline", "chain_prepass_ms", "step_mfu",
        "device_idle"}
    assert {m["name"] for m in reg.end_to_end_for("chain_blocking")} == {
        "call_latency_ms", "setup_s"}


def test_a_suffixed_metric_is_read_by_its_stems_file():
    reg = Registry()
    assert reg.reader("device_idle.bank") is reg.reader("device_idle")
    assert reg.reader("step_mfu.pod") is reg.reader("step_mfu")
    assert reg.end_to_end("throughput.bank") is reg.end_to_end("throughput")
    with pytest.raises(KeyError):
        reg.reader("no_such_metric.bank")


def test_unknown_names_are_refused():
    reg = Registry()
    with pytest.raises(KeyError):
        reg.cell("no_such_cell")
    with pytest.raises(KeyError):
        reg.reader("no_such_metric")
    with pytest.raises(ValueError):
        reg.traffic("../configs/x")


TOY_SYSTEM = '''
import torch


class System:
    """y = 2 x on each row; the reference is the same product."""

    def __init__(self, params, traffic, device, mesh=None):
        self.rows_n = params["rows"]
        self.samples_per_call = params["rows"] * traffic["samples_per_call"]
        self.t = traffic["samples_per_call"]

    def block(self, seed, j):
        g = torch.Generator().manual_seed(seed * 7 + j)
        return torch.randn((self.rows_n, self.t), generator=g)

    def pool(self, seed, blocks):
        return [self.block(seed, j) for j in range(blocks)]

    def init_state(self):
        return 0

    def call(self, x, state):
        return 2 * x, state + 1

    def work(self):
        return {"flops": float(self.samples_per_call), "bytes": 0.0}

    def rows(self, seed, last):
        return list(range(self.rows_n))

    def check(self, seed, blocks, kept, reference):
        worst = 0.0
        for g, out, rows in kept:
            ref = reference.double_it(self.block(seed, g % blocks)[rows])
            worst = max(worst, float((out[rows] - ref).abs().max()))
        return {"numbers": {"toy_err": worst}, "compared": len(kept)}


def control(system):
    import contextlib
    return contextlib.nullcontext()
'''


def _toy_root(tmp_path):
    """A copy of the benchmark with one more configuration, mix, cell and
    per-layer metric, each a new file and a new entry."""
    shutil.copytree(BENCH_DIR, tmp_path / "dspbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    d = tmp_path / "dspbench"
    (d / "configs" / "toy.json").write_text(json.dumps({
        "name": "toy", "system": "toy", "reference": "toy",
        "params": {"rows": 3}, "limits": {"toy_err": 0.0}}))
    (d / "systems" / "toy.py").write_text(TOY_SYSTEM)
    (d / "reference" / "toy.py").write_text(
        "def double_it(x):\n    return 2 * x\n")
    (d / "traffic" / "toy_mix.json").write_text(json.dumps({
        "samples_per_call": 8, "dispatch": "ahead", "in_flight": 2,
        "pool": 2, "warmup_calls": 1, "trace_calls": 4, "trace_skip": 1,
        "keep_within": 2, "ranks": 1}))
    (d / "metrics" / "toy_calls.py").write_text(textwrap.dedent('''
        def read(ctx):
            return float(ctx.records[0]["attempted"])
    '''))
    bench["configs"].append({"name": "toy", "source": "a test",
                             "file": "dspbench/configs/toy.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "toy_cell", "config": "toy",
                               "traffic": "toy_mix", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("toy_cell")
    bench["per_layer"].append({"name": "toy_calls", "unit": "calls",
                               "better": "higher",
                               "source": "program_counter", "layer": "toy",
                               "moves": "throughput",
                               "workloads": ["toy_cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return Registry(tmp_path)


@pytest.mark.parametrize("trace", [False, True])
def test_a_new_cell_mix_and_metric_are_taken_up_as_files(tmp_path, trace):
    reg = _toy_root(tmp_path)
    cell = Cell.load(reg, "toy_cell")
    record = run_cell(cell, 5, 0.05, trace, torch.device("cpu"))
    result = assemble(reg, Context(cell, [record], 0.5), trace, "cpu")
    assert result["correct"] and result["failed"] == 0
    assert result["checks"] == {"toy_err": {"value": 0.0, "limit": 0.0}}
    if trace:
        assert result["metrics"]["toy_calls"]["value"] == record["attempted"]
        assert record["trace"]["calls"] == 4
    else:
        assert set(result["metrics"]) == {"throughput", "setup_s"}
        assert result["metrics"]["setup_s"]["value"] == 0.5
