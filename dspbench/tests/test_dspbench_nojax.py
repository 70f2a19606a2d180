"""Nothing the benchmark runs loads JAX or the JAX package."""

import json
import subprocess
import sys

from dspbench.harness import FORBIDDEN
from dspbench.registry import ROOT

PROBE = r'''
import json, sys
import torch
from dspbench import (controls, harness, inputs, pod, readers, registry,
                      roofline, run, trace, window)
from dspbench.harness import Cell, forbidden_modules, run_cell
reg = registry.Registry()
sizes = {"chain_bulk": ({"channels": 2}, {"samples_per_call": 8192}),
         "chain_blocking": ({"channels": 2}, {"samples_per_call": 8192}),
         "fm_bank_bulk": ({"streams": 1}, {"samples_per_call": 4096})}
for m in reg.bench["per_layer"]:
    reg.reader(m["name"])
for m in reg.bench["end_to_end"]:
    reg.end_to_end(m["name"])
for w in reg.bench["workloads"]:
    params, traffic = sizes.get(w["name"], ({}, {}))
    cell = Cell.load(reg, w["name"], params,
                     dict(traffic, keep_within=2, trace_calls=3, trace_skip=1))
    if w["name"] in sizes:
        # Runs the port's objects: what they import counts too.
        run_cell(cell, 11, 0.05, False, torch.device("cpu"))
import simpledsp_tpu_torch.parallel.mesh
import simpledsp_tpu_torch.models.northstar
print(json.dumps({"loaded": forbidden_modules(),
                  "modules": len(sys.modules)}))
'''


def test_no_module_of_jax_or_the_jax_package_is_loaded():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["loaded"] == [], got
    assert got["modules"] > 100


def test_the_check_compares_whole_top_level_names():
    assert "simpledsp_tpu" in FORBIDDEN
    names = ["simpledsp_tpu_torch", "simpledsp_tpu_torch.ops", "jaxtyping",
             "jax_cuda", "flaxen"]
    assert [n for n in names if n.split(".", 1)[0] in FORBIDDEN] == []
    assert [n for n in ["jax.numpy", "simpledsp_tpu.ops", "flax"]
            if n.split(".", 1)[0] in FORBIDDEN] == ["jax.numpy",
                                                     "simpledsp_tpu.ops",
                                                     "flax"]
