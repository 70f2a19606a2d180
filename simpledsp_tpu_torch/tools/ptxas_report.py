"""What ``nvcc -Xptxas -v`` says of the package's CUDA sources: each kernel
instance's registers, spill stores and loads, stack frame and static shared
memory, with the flags the package builds with.

    python3 simpledsp_tpu_torch/tools/ptxas_report.py [--root DIR] pfb.cu chain.cu

``--root`` names the checkout whose ``simpledsp_tpu_torch/csrc`` is compiled
(default: this one).  Needs ``nvcc``; prints one JSON object, and the raw
ptxas lines under ``chiprun_out/ptxas_<source>.txt`` when that directory
exists.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_USED = re.compile(r"Used (\d+) registers")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_STACK = re.compile(r"(\d+) bytes stack frame")
_SMEM = re.compile(r"(\d+) bytes smem")


def demangled(names):
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), text=True,
                             capture_output=True, check=True).stdout
        return out.splitlines()
    except (OSError, subprocess.CalledProcessError):
        return list(names)


def report(root: Path, source: str) -> dict:
    """{kernel: {registers, spill_stores, spill_loads, stack, smem}}."""
    sys.path.insert(0, str(root))
    from simpledsp_tpu_torch.kernels import _build

    csrc = root / "simpledsp_tpu_torch" / "csrc"
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared",)]
    cmd = [_build._nvcc(), *flags, "-Xptxas", "-v", "-c", str(csrc / source),
           "-o", "/dev/null"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    text = proc.stdout + proc.stderr
    out_dir = Path("chiprun_out")
    if out_dir.is_dir():
        (out_dir / f"ptxas_{Path(source).stem}.txt").write_text(text)
    kernels, current = {}, None
    for line in text.splitlines():
        m = _ENTRY.search(line)
        if m:
            current = m.group(1)
            kernels[current] = {}
            continue
        if current is None:
            continue
        rec = kernels[current]
        for key, rx in (("registers", _USED), ("stack", _STACK),
                        ("smem", _SMEM)):
            m = rx.search(line)
            if m and key not in rec:
                rec[key] = int(m.group(1))
        m = _SPILL.search(line)
        if m:
            rec["spill_stores"], rec["spill_loads"] = map(int, m.groups())
    names = demangled(list(kernels))
    return {name: kernels[mangled] for name, mangled in zip(names, kernels)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("sources", nargs="+")
    a = ap.parse_args()
    root = Path(a.root or Path(__file__).resolve().parents[2]).resolve()
    print(json.dumps({s: report(root, s) for s in a.sources}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
