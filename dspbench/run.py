"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 -m dspbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell's entry in ``BENCHMARK.json`` names
its configuration and traffic mix, found as files under ``dspbench/``
(``registry.py``).  Without a CUDA card, or with fewer cards than the cell
asks for, the run exits 2 and prints no result; with JAX or the JAX
package loaded once the window has closed it exits 3.  Otherwise it prints,
as the last line of standard output, one JSON object with ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and, traced,
``breakdown``) and, last, ``checks``: each number compared beside its
limit, which also end standard error.  An earlier line records the
nvcc seconds of the run's builds, the card's power limit and the module
check.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys

from dspbench.harness import (Cell, boot_clock, forbidden_modules,
                              process_start, run_cell, set_cache_dirs, worse)
from dspbench.registry import Registry
from dspbench.window import Window, pod_window


@dataclasses.dataclass
class Context:
    """What the readers of a cell's metrics see."""

    cell: Cell
    records: list           # one a rank
    setup_s: float

    @property
    def window(self) -> Window:
        return pod_window([Window(*r["window"]) for r in self.records])

    @property
    def traces(self) -> list:
        return [r["trace"] for r in self.records]

    @property
    def work(self) -> dict:
        """One rank's work of one call."""
        return self.records[0]["work"]


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m dspbench.run",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def power_limit() -> str:
    """``name, power.limit`` of each card, as ``nvidia-smi`` reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read: {e}"


def assemble(registry: Registry, ctx: Context, trace: bool, kind: str
             ) -> dict:
    """The result line of a run whose ranks left ``ctx.records``."""
    cell, records = ctx.cell, ctx.records
    metrics = {}
    entries = (registry.per_layer_for(cell.name) if trace
               else registry.end_to_end_for(cell.name))
    for m in entries:
        reader = (registry.reader(m["name"]) if trace
                  else registry.end_to_end(m["name"]))
        value = reader.read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind, "count": len(records),
              "memory_peak_bytes": max(r["memory_peak_bytes"]
                                       for r in records)}
    limits = cell.config["limits"]
    numbers = {}
    for r in records:
        for name, value in r["numbers"].items():
            numbers[name] = worse(numbers.get(name, 0.0), value)
    correct = (sorted(numbers) == sorted(limits)
               and all(numbers[k] <= limits[k] for k in limits))
    result = {"correct": correct,
              "attempted": sum(r["attempted"] for r in records),
              "failed": sum(r["failed"] for r in records),
              "metrics": metrics, "device": device}
    if trace:
        from dspbench.trace import breakdown
        device["busy_s"] = sum(t["busy_s"] for t in ctx.traces) / len(records)
        device["window_s"] = (sum(t["window_s"] for t in ctx.traces)
                              / len(records))
        result["breakdown"] = breakdown(ctx.traces)
    result["checks"] = {k: {"value": _plain(numbers.get(k)),
                            "limit": limits[k]} for k in limits}
    return result


def _plain(value):
    """A reading as strict JSON holds it: ``"inf"`` where it is not
    finite."""
    if value is None or math.isfinite(value):
        return value
    return repr(value)


def finish(registry: Registry, ctx: Context, trace: bool, kind: str,
           info: dict) -> int:
    """Check the modules, print the record line, the result line and the
    checks; the exit code."""
    loaded = forbidden_modules() + info.pop("rank_forbidden", [])
    if loaded:
        print(f"dspbench: JAX or the JAX package is loaded: {loaded}",
              file=sys.stderr)
        return 3
    info.update(forbidden_modules=loaded, power_limit=power_limit())
    result = assemble(registry, ctx, trace, kind)
    print(json.dumps(info), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    started = process_start()
    args = parse(argv)
    set_cache_dirs()
    registry = Registry()
    cell = Cell.load(registry, args.workload)
    import torch
    chips = cell.entry["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"dspbench: the cell {args.workload} needs {chips} CUDA "
              f"card(s); found {found}", file=sys.stderr)
        return 2
    if cell.traffic.get("ranks", 1) > 1:
        from dspbench.pod import launch
        return launch(registry, cell, args, started)
    torch.set_num_threads(4)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    record = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      device)
    from simpledsp_tpu_torch.kernels import _build
    ctx = Context(cell, [record], record["first_call"] - started)
    info = {"cell": cell.name, "seed": args.seed,
            "build_seconds": dict(_build.build_seconds),
            "calls": record["attempted"], "compared": record["compared"],
            "run_s": boot_clock() - started}
    return finish(registry, ctx, bool(args.trace),
                  torch.cuda.get_device_name(device), info)


if __name__ == "__main__":
    sys.exit(main())
