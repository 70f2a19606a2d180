"""Time the direct conv2d kernel on the card: ``csrc/conv2d.cu`` of this
checkout and of other checkouts unpacked beside it (``--roots``), in turns
in one call, and variants of this checkout's source, each a one-line edit
built apart:

- "all": the source as it is;
- "r4": threads of 4 x 8 outputs (64 x 128 tiles) and two blocks an SM, as
  it is 2 x 8 (32 x 128) and three;
- "noskip": no warp skips its arithmetic past the image's edge;
- "unroll2": the tap-row loop unrolled twice;
- "noload" / "notaps" / "ffma" / "nosync" (timed only, their results
  differ): the window / tap-row loads hoisted out of the tap-row loop,
  which bounds what the loads and their addressing cost; an FMA in place
  of each rounded product and sum, which halves the arithmetic's
  instructions; no barrier after a tile's arithmetic (a race).

Each (checkout, variant) is timed in a process of its own (the checkout's
package first on ``sys.path``), through that checkout's
``conv2d_valid_fused`` on 32 x 512 x 512 float32 noise (seed 7, phase 12 of
``chip_smoke.py``) with 3x3 / 9x9 / 13x13 random taps, and on the image
padded by 8 on every side (the 'same' path's 528 x 528 at 9x9, phase 13),
as CUDA-graph replays of 10 calls: device time, ms a call (``--batch``
images other than 32 to see what a launch costs beside its tiles).  Every output
is checked bit for bit against ``conv2d_valid_reference``, and
``F.conv2d`` (TF32 off) is timed beside it.  The turns run the checkouts
forward, then backward (parent, this, this, parent for two checkouts and
two turns).

    python3 simpledsp_tpu_torch/tools/conv2d_variants.py [--roots DIR ...] [--variants all r4 ...] [--turns 2]

``--roots`` defaults to this checkout; a root other than this one runs
"all" only.  Prints one JSON object with each turn's numbers and their
summary {"root@variant": {case: [ms, ...]}}; raises without a card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
CASES = {"3x3": (3, 0), "9x9": (9, 0), "13x13": (13, 0), "same9": (9, 8)}
BATCH = 32
_BOUND = "__launch_bounds__(kThreads, 3)"
_SKIP = "    return;  // every output of this warp lies past the image"
_WINDOW = "        window<kNQ>(w, base, i + o, tr, p.pitch, jb);"
_ILOOP = "  for (int i = 0; i < p.kh; ++i) {\n"
_PRODUCT = "acc[c] = __fadd_rn(acc[c], __fmul_rn(t[j], w[c + j]));"
_TAPS = "      tap_row<kKS>(tk, ks + i * p.kstride + jb);\n#pragma unroll\n"
# name -> edits of conv2d.cu (a text, its replacement); "all" changes nothing.
VARIANTS = {
    "all": None,
    "r4": [("constexpr int kR = 2; ", "constexpr int kR = 4; "),
           (_BOUND, "__launch_bounds__(kThreads, 2)")],
    "noskip": [(_SKIP, "    (void)0;")],
    "unroll2": [(_ILOOP, "#pragma unroll 2\n" + _ILOOP)],
    "ffma": [(_PRODUCT, "acc[c] = __fmaf_rn(t[j], w[c + j], acc[c]);")],
    "nosync": [("    __syncthreads();  // every read of this stage is done",
                "    (void)0;")],
    "noload": [(_WINDOW, _WINDOW.replace("i + o", "o"))],
    "notaps": [(_TAPS, _TAPS.replace("i * p.kstride + ", ""))],
}
# Variants that give other results, timed only: the window loads out of the
# tap-row loop ("noload": each thread reads the same rows for every tap
# row, which the compiler hoists), the tap loads out of it ("notaps"), one
# FMA for each product and sum ("ffma", half the instructions).
TIMING_ONLY = ("noload", "notaps", "ffma", "nosync")


def measure(root: str, csrc: str, build_only: bool = False,
            per: int = 10, batch: int = BATCH) -> dict:
    """In this process: build ``csrc``'s conv2d.cu with the package of
    ``root`` and time it at every case."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from simpledsp_tpu_torch.kernels import _build
    from simpledsp_tpu_torch.kernels import conv2d as k2d
    from simpledsp_tpu_torch.tools._common import graph_ms
    _build.CSRC_DIR = Path(csrc)
    k2d.conv2d_kernel.library()
    if build_only:
        return {}
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    x = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (batch, 512, 512), dtype=np.float32), device=dev)
    out = {"ms": {}, "f_conv2d_ms": {}, "equal_bits": {}}
    for case, (kk, pad) in CASES.items():
        k = np.random.default_rng(kk).standard_normal((kk, kk))
        k32 = torch.as_tensor(k, dtype=torch.float32, device=dev)
        xp = torch.nn.functional.pad(x, (pad,) * 4) if pad else x
        out["equal_bits"][case] = bool(torch.equal(
            k2d.conv2d_valid_fused(xp, k), k2d.conv2d_valid_reference(xp, k32)))
        out["ms"][case] = graph_ms(lambda: k2d.conv2d_valid_fused(xp, k),
                                   per=per)
        kflip = k32.flip(0, 1).reshape(1, 1, kk, kk).contiguous()
        out["f_conv2d_ms"][case] = graph_ms(
            lambda: torch.nn.functional.conv2d(xp[:, None], kflip), per=per)
    return out


def run(roots=None, variants=("all",), turns: int = 2,
        batch: int = BATCH) -> dict:
    sys.path.insert(0, str(HERE))
    from simpledsp_tpu_torch.tools._common import edited_csrc, time_in_turns
    arms = []
    for root in [Path(r).resolve() for r in (roots or [HERE])]:
        mine = root == HERE
        for v in (variants if mine else ("all",)):
            edits = VARIANTS[v] if mine else None
            csrc = edited_csrc(root, edits and {"conv2d.cu": edits},
                               f"conv2d_{v}")
            arms.append((f"{'this' if mine else root}@{v}", str(root),
                         str(csrc)))
    out = time_in_turns(__file__, arms, turns, ["--batch", str(batch)])
    out["summary"] = {}
    for r in out["runs"]:
        if r["arm"].split("@")[1] not in TIMING_ONLY and not all(
                r["equal_bits"].values()):
            raise RuntimeError(f"{r['arm']}: not bit for bit the plain "
                               f"version: {r['equal_bits']}")
        for case, ms in r["ms"].items():
            out["summary"].setdefault(r["arm"], {}).setdefault(
                case, []).append(ms)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", nargs="+", default=None)
    ap.add_argument("--variants", nargs="+", default=["all"],
                    choices=list(VARIANTS))
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--child", nargs=2, default=None)
    ap.add_argument("--build-only", action="store_true")
    a = ap.parse_args()
    if a.child:
        print(json.dumps(measure(*a.child, build_only=a.build_only,
                                 batch=a.batch)))
        return 0
    print(json.dumps(run(a.roots, tuple(a.variants), a.turns, a.batch)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
