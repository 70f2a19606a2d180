"""Find a cell's pieces by name.

``BENCHMARK.json`` names the cells, configurations and metrics; each piece
is a file of its own under the benchmark's folder, found by its name:

- ``configs/<config>.json``: the deployment (the ``file`` of its entry in
  ``BENCHMARK.json``), naming the ``system`` that builds the port's object
  and the ``reference`` that checks it;
- ``systems/<system>.py``: builds the port's object, makes its inputs from
  the seed, calls it, and compares what it produced with the reference;
- ``reference/<reference>.py``: the plain float64 reference;
- ``traffic/<mix>.json``: call size, dispatch, depth in flight, layout
  over cards, read by the one window loop of ``harness.py``;
- ``metrics/<metric>.py``: the reader of one per-layer metric, ``read(ctx)``;
- ``end_to_end/<metric>.py``: the reader of one end-to-end metric.

A metric named ``<metric>.<suffix>`` without a file of its own is read by
``<metric>.py``: the suffix only tells apart the cells and the end-to-end
metric that one quantity moves (``device_idle.bank``).

A later cell, mix or metric is a new file and a new entry; no file here
changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent

_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _checked(name: str) -> str:
    if not _NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


class Registry:
    """The benchmark under ``root``: its ``BENCHMARK.json`` and the files
    under ``root / bench_dir``."""

    def __init__(self, root: Path = ROOT, bench_dir: str = BENCH_DIR.name):
        self.root = Path(root)
        self.dir = self.root / bench_dir
        with open(self.root / "BENCHMARK.json") as f:
            self.bench = json.load(f)
        self._modules: dict = {}

    # -- entries of BENCHMARK.json ------------------------------------------
    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (it has "
                       f"{[w['name'] for w in self.bench['workloads']]})")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                with open(self.root / c["file"]) as f:
                    return json.load(f)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def end_to_end_for(self, cell: str) -> list:
        """The cell's end-to-end metrics: those that list it, and those
        that list no cells."""
        return [m for m in self.bench["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer_for(self, cell: str) -> list:
        """The cell's per-layer metrics: those that list it; one that lists
        no cells belongs to every cell that reports its ``moves``."""
        e2e = {m["name"] for m in self.end_to_end_for(cell)}
        return [m for m in self.bench["per_layer"]
                if cell in m.get("workloads", [cell] if m["moves"] in e2e
                                 else [])]

    # -- files found by name -------------------------------------------------
    def traffic(self, name: str) -> dict:
        with open(self.dir / "traffic" / f"{_checked(name)}.json") as f:
            return json.load(f)

    def system(self, name: str) -> ModuleType:
        return self._load("systems", name)

    def reference(self, name: str) -> ModuleType:
        return self._load("reference", name)

    def reader(self, metric: str) -> ModuleType:
        return self._load("metrics", metric, by_stem=True)

    def end_to_end(self, metric: str) -> ModuleType:
        return self._load("end_to_end", metric, by_stem=True)

    def _load(self, kind: str, name: str, by_stem: bool = False
              ) -> ModuleType:
        path = self.dir / kind / f"{_checked(name)}.py"
        if by_stem and not path.is_file():
            path = self.dir / kind / f"{name.split('.', 1)[0]}.py"
        if path not in self._modules:
            if not path.is_file():
                raise KeyError(f"no {kind} file for {name!r}: {path}")
            spec = importlib.util.spec_from_file_location(
                f"dspbench_{kind}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}",
                path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            self._modules[path] = module
        return self._modules[path]
