"""What ``nvcc -Xptxas -v`` says of the package's CUDA sources: each kernel
instance's registers, spill stores and loads, stack frame and static shared
memory, with the flags the package builds with.

    python3 simpledsp_tpu_torch/tools/ptxas_report.py [--root DIR] [--sass NAME] pfb.cu chain.cu

``--root`` names the checkout whose ``simpledsp_tpu_torch/csrc`` is compiled
(default: this one).  ``--sass NAME`` adds, for each kernel instance whose
name holds NAME, the static count of its SASS instructions by opcode
(``cuobjdump -sass`` of the compiled cubin): what the code issues per trip
of a fully unrolled loop, not a dynamic count.  Needs ``nvcc``; prints one
JSON object, and the raw ptxas lines (and SASS) under
``chiprun_out/ptxas_<source>.txt`` (``sass_<source>.txt``) when that
directory exists.
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


_FUNC = re.compile(r"Function : (\S+)")
_OP = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)")


def sass_counts(root: Path, source: str, name: str) -> dict:
    """{kernel: {opcode: count, "total": n}} of the instances of ``source``
    whose demangled name holds ``name``."""
    import tempfile

    from simpledsp_tpu_torch.kernels import _build
    csrc = root / "simpledsp_tpu_torch" / "csrc"
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared",)]
    with tempfile.TemporaryDirectory() as tmp:
        cubin = Path(tmp) / "k.cubin"
        subprocess.run([_build._nvcc(), *flags, "-cubin", str(csrc / source),
                        "-o", str(cubin)], check=True, capture_output=True)
        tool = Path(_build._nvcc()).with_name("cuobjdump")
        text = subprocess.run([str(tool), "-sass", str(cubin)], check=True,
                              capture_output=True, text=True).stdout
    out_dir = Path("chiprun_out")
    if out_dir.is_dir():
        (out_dir / f"sass_{Path(source).stem}.txt").write_text(text)
    counts, current = {}, None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            current = m.group(1)
            counts[current] = {}
            continue
        m = _OP.search(line)
        if m and current is not None:
            op = m.group(1)
            counts[current][op] = counts[current].get(op, 0) + 1
    names = demangled(list(counts))
    out = {}
    for nice, mangled in zip(names, counts):
        if name in nice:
            c = dict(sorted(counts[mangled].items(), key=lambda kv: -kv[1]))
            out[nice] = {"total": sum(c.values()), **c}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--sass", default=None)
    ap.add_argument("sources", nargs="+")
    a = ap.parse_args()
    root = Path(a.root or Path(__file__).resolve().parents[2]).resolve()
    out = {s: report(root, s) for s in a.sources}
    if a.sass:
        out["sass"] = {s: sass_counts(root, s, a.sass) for s in a.sources}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
