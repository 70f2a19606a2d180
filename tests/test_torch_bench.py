"""The port's headline benchmark (``simpledsp_tpu_torch/bench.py``), its
compiled-path smoke (``simpledsp_tpu_torch/tools/smoke.py``) and the CLI's
``bench`` command, on the CPU at small sizes.

The JSON line must carry the JAX ``bench.py``'s keys and metric string;
the smoke's three checks run on a gloo mesh of one rank, the kernel
wrappers on their plain versions.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from simpledsp_tpu_torch import bench
from simpledsp_tpu_torch.tools import smoke

REPO = Path(__file__).resolve().parent.parent
KEYS = {"metric", "value", "unit", "vs_baseline", "detail"}
DETAIL_KEYS = {"channels", "samples_per_channel", "seconds_per_call",
               "device", "dtype", "parity_snr_db", "baseline"}
SMALL = dict(channels=2, samples=2 ** 15, device="cpu", iters=2, loops=3)


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")


def test_bench_prints_one_json_line_with_bench_py_keys(capsys, monkeypatch):
    """One stdout line: bench.py's keys and metric string, the samples over
    the median seconds a call, and the 130 dB gate passed on the plain
    route."""
    monkeypatch.setenv("SDSP_SKIP_SMOKE", "1")
    result = bench.main(**SMALL)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec == result
    assert set(rec) == KEYS and set(rec["detail"]) == DETAIL_KEYS
    assert f'"metric": "{rec["metric"]}"' in (REPO / "bench.py").read_text()
    assert rec["unit"] == "Msamples/s"
    d = rec["detail"]
    assert (d["channels"], d["samples_per_channel"]) == (2, 2 ** 15)
    assert d["device"] == "cpu" and d["dtype"] == "float32"
    assert d["parity_snr_db"] >= 130.0
    msps = 2 * 2 ** 15 / d["seconds_per_call"] / 1e6
    assert rec["value"] == pytest.approx(msps, rel=1e-3, abs=0.1)
    assert rec["vs_baseline"] == pytest.approx(
        rec["value"] / bench.BASELINE_MSPS, abs=0.02)
    assert "47.1" in d["baseline"]


def test_bench_parity_gate_stops_before_the_line(capsys, monkeypatch):
    """Below 130 dB the run stops with SystemExit and prints no line."""
    monkeypatch.setenv("SDSP_SKIP_SMOKE", "1")
    monkeypatch.setattr(bench, "_parity_snr", lambda *a: 129.9)
    with pytest.raises(SystemExit, match="129.9 dB < 130 dB"):
        bench.main(**SMALL)
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("rc", [0, 1])
def test_bench_runs_the_smoke_after_its_line(capsys, monkeypatch, rc):
    """Without SDSP_SKIP_SMOKE the smoke runs after the JSON line, on the
    benchmark's device; a failed smoke exits nonzero, the line already
    out."""
    monkeypatch.delenv("SDSP_SKIP_SMOKE", raising=False)
    seen = []
    monkeypatch.setattr(bench, "run_smoke", lambda dev: seen.append(dev) or rc)
    if rc:
        with pytest.raises(SystemExit, match="smoke FAILED"):
            bench.main(**SMALL)
    else:
        bench.main(**SMALL)
    assert seen == [torch.device("cpu")]
    assert len(capsys.readouterr().out.splitlines()) == 1


def test_smoke_run_passes_on_a_gloo_mesh_of_one(tmp_path):
    """The three checks pass on the CPU (gloo), the record goes where it
    is told, and the process group the smoke started is gone after."""
    import torch.distributed as dist

    out = tmp_path / "sub" / "record.json"
    record = smoke.run(out, device="cpu")
    assert json.loads(out.read_text()) == record
    assert set(record) == {"compiled_smoke_ok", "chain_snr_db", "shard_dev",
                           "state_dev", "bank_dev", "spectra_scale",
                           "device"}
    assert record["compiled_smoke_ok"] is True
    assert record["chain_snr_db"] >= 130.0 and record["device"] == "cpu"
    assert record["shard_dev"] < 1e-4 * record["spectra_scale"]
    assert record["state_dev"] < 1e-4 and record["bank_dev"] == 0.0
    assert not dist.is_initialized()


def test_smoke_module_writes_its_record_and_never_the_jax_one(tmp_path):
    """``python -m simpledsp_tpu_torch.tools.smoke OUT --device cpu``
    exits 0, prints the record last and writes it to OUT; the JAX
    package's TPU_SMOKE.json is not touched."""
    jax_record = (REPO / "TPU_SMOKE.json").read_bytes()
    out = tmp_path / "smoke.json"
    proc = subprocess.run(
        [sys.executable, "-m", "simpledsp_tpu_torch.tools.smoke", str(out),
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    record = json.loads(proc.stdout.splitlines()[-1])
    assert json.loads(out.read_text()) == record
    assert record["compiled_smoke_ok"] is True
    assert (REPO / "TPU_SMOKE.json").read_bytes() == jax_record


def test_smoke_default_record_is_under_build():
    path = smoke.default_out_path()
    assert path.name == "smoke.json" and path.parent == REPO / "build"


@pytest.mark.parametrize("args", [["-m", "simpledsp_tpu_torch", "bench"],
                                  ["-m", "simpledsp_tpu_torch.tools.smoke"]])
def test_without_a_card_exits_2(args, tmp_path):
    """No quiet move to the CPU: without a card and without --device cpu,
    ``bench`` and the smoke exit 2 with resolve_device's message."""
    _no_card()
    proc = subprocess.run([sys.executable, *args, str(tmp_path / "r.json")]
                          if "smoke" in args[-1] else [sys.executable, *args],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 2
    assert "CUDA is not available" in proc.stderr
    assert proc.stdout == ""
    assert not (tmp_path / "r.json").exists()


@pytest.mark.parametrize("entry", ["bench", "smoke"])
def test_entry_defaults_to_cuda(entry, tmp_path, monkeypatch):
    """``bench.main()`` and ``smoke.run()`` with no device mean CUDA, and
    raise without a card before they print or write anything."""
    _no_card()
    monkeypatch.setenv("SDSP_SKIP_SMOKE", "1")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == "bench":
            bench.main(channels=2, samples=2 ** 15)
        else:
            smoke.run(tmp_path / "r.json")
    assert not (tmp_path / "r.json").exists()
