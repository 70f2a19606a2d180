"""Time variants of the overlap-save kernel on the card: ``csrc/ols.cu``
as it is ("all"), stopped after its loads ("load"), after the forward
transform, the tap product and the inverse's first pass ("forward") or
before the inverse's last pass, which stores the samples ("unstored"), with
the forward transform's last pass and the inverse's first fused at every
last radix ("turn_always") or at none ("turn_never"; as it is, at every
radix but 16), and at other register budgets than its 64 a thread
(``__launch_bounds__``: "regs128", two 256-thread blocks an SM and one
512-thread block; "regs80", three 256-thread blocks).

Each variant is the source with one edit, built in a directory of its own
under ``build/`` (all at once, a process each), and timed through
``conv_ols_frames`` on the frames of 256 x 65536 float32 noise (seed 0)
with 301 / 1000 / 2000 random taps at nfft 4096 / 8192 / 16384 (phase 10
of ``chip_smoke.py``) as CUDA-graph replays: device time.  A whole
variant's output is held to the float64 plain version (SNR in dB).

    python3 simpledsp_tpu_torch/tools/ols_variants.py [--root DIR] [--variants all load ...]

``--root`` names the checkout whose kernel is built and timed (default:
this one), so that another commit unpacked beside it is timed in the same
call ("all" only, where the other edits do not apply).  Prints one JSON
object, {"variant@nfft": {"ms": ms, "snr_db": dB}}; raises without a card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

CASES = ((4096, 301), (8192, 1000), (16384, 2000))   # (nfft, taps)
_SYNC = '  asm volatile("cp.async.wait_all;\\n" ::: "memory");\n  __syncthreads();\n'
_INV = "  for (int p = 1; p < last; ++p) run_pass<kEPT>(s, s, s, itab, iplan, p, total);\n"
_LAST = "  run_pass<kEPT>(s, s,\n                 SkipSplitStore{"
_SINK = "  if (smem[tid] == 1.5e-30f) out[0] = smem[tid];\n  return;\n"
_BOUND = "__launch_bounds__(kNT, 1024 / kNT)"
_TURN = "const bool turn = plan.radix[npass - 1] != 16;"
# name -> (text of ols.cu, its replacement); "all" changes nothing.
VARIANTS = {
    "all": None,
    "load": (_SYNC, _SYNC + _SINK),
    "forward": (_INV, _SINK + _INV),
    "unstored": (_LAST, _SINK + _LAST),
    "turn_always": (_TURN, "const bool turn = true;"),
    "turn_never": (_TURN, "const bool turn = false;"),
    "regs128": (_BOUND, "__launch_bounds__(kNT, kNT >= 512 ? 1 : 2)"),
    "regs80": (_BOUND, "__launch_bounds__(kNT, kNT >= 512 ? 1 : 3)"),
}
PREBUILD = """import sys; sys.path.insert(0, {root!r})
from pathlib import Path
from simpledsp_tpu_torch.kernels import _build, ols
_build.CSRC_DIR = Path({csrc!r}); ols._library()"""


def run(root=None, variants=tuple(VARIANTS), per: int = 10) -> dict:
    root = str(Path(root or Path(__file__).resolve().parents[2]).resolve())
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from simpledsp_tpu_torch.kernels import _build
    from simpledsp_tpu_torch.kernels import ols as kols
    from simpledsp_tpu_torch.kernels.fft import _best_split
    from simpledsp_tpu_torch.tools._common import (build_all, edited_csrc,
                                                   graph_ms)
    if not torch.cuda.is_available():
        raise RuntimeError("the variants are timed on the card: no CUDA device")
    dev = torch.device("cuda", 0)
    csrc = _build.CSRC_DIR
    dirs = {name: edited_csrc(Path(root), VARIANTS[name] and {
        "ols.cu": [VARIANTS[name]]}, f"ols_{name}") for name in variants}
    build_all([[sys.executable, "-c", PREBUILD.format(root=root, csrc=str(d))]
               for d in dirs.values()], "a variant of the overlap-save kernel")

    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (256, 1 << 16), dtype=np.float32), device=dev)
    out = {"device": torch.cuda.get_device_name(0)}
    try:
        for nfft, m in CASES:
            taps = np.random.default_rng(m).standard_normal(m)
            n2 = _best_split(nfft)[1]
            o1 = -(-(m - 1) // n2)
            hop = nfft - o1 * n2
            nf = -(-(x.shape[1] + m - 1) // hop)
            frames = torch.nn.functional.pad(
                x, (o1 * n2, nf * hop - x.shape[1])).unfold(-1, nfft, hop)
            ref = kols.conv_ols_frames_reference(
                frames.double(), kols.ols_tables(nfft, taps, torch.float64,
                                                 dev), o1)
            for name, d in dirs.items():
                _build.CSRC_DIR = d
                _build.load_library.cache_clear()
                kols._library.cache_clear()

                def call():
                    return kols.conv_ols_frames(frames, taps, overlap_rows=o1)

                rec = {"ms": graph_ms(call, per=per)}
                if name not in ("load", "forward", "unstored"):
                    err = float(((call().double() - ref) ** 2).sum())
                    rec["snr_db"] = 10 * np.log10(float((ref ** 2).sum()) / err)
                out[f"{name}@{nfft}"] = rec
            del frames, ref
    finally:
        _build.CSRC_DIR = csrc
        _build.load_library.cache_clear()
        kols._library.cache_clear()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=list(VARIANTS))
    a = ap.parse_args()
    print(json.dumps(run(a.root, tuple(a.variants))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
