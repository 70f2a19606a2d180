"""Time the contraction kernel (``kernels.probes.contract``) on the card:
``csrc/probes.cu`` of this checkout and of other checkouts unpacked beside
it (``--roots``), in turns in one call, and variants of this checkout's
source, each a one-line edit built apart:

- "all": the source as it is;
- "small": the tiled form's 64-row tiles at every size (as it is: 128-row
  tiles where they give every SM two blocks, as at the chain's size);
- "stages2": a ring of two K steps in the tiled form (as it is: three);
- "kg2" / "kg4": the skinny form's blocks of two / four warps splitting
  K at every size (as it is: four where the blocks are fewer than eight an
  SM, else two);
- "bounds1": the tiled form's 128-row instance built for one block an SM
  (as it is: two, under which ptxas caps it at 128 registers a thread).

Each (checkout, variant) is timed in a process of its own (the checkout's
package first on ``sys.path``) at the probe's and the 64 x 2^20 chain's
sizes of ``tools/probe_mosaic.py``, with its operand layouts: k1,
(64, 320) x (320, 320) and (16384, 320) x (320, 320); k2 with its
shift-in, (2048, 128) x (128, 10) and (524288, 128) x (128, 10) grouped by
32, B a transposed view; as CUDA-graph replays of 10
calls (device time, ms a call).  Every product is held to the float64
plain version (>= 120 dB, no more than 6 dB below the float32 plain
version).  The turns run the checkouts forward, then backward.
(``tools/probe_mosaic.py`` times the chain-size products beside
``torch.matmul``.)

    python3 simpledsp_tpu_torch/tools/contract_variants.py [--roots DIR ...] [--variants all small ...] [--turns 2]

Prints one JSON object with each turn's numbers and their summary
{"root@variant": {case: [ms, ...]}}; raises without a card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
# case -> (m, k, n, group of the shift-in or 0); as in probe_mosaic, k1's
# B is contiguous and k2's the transpose of a contiguous (10, 128).
CASES = {"k1_probe": (64, 320, 320, 0), "k2_probe": (2048, 128, 10, 32),
         "k1_chain": (16384, 320, 320, 0), "k2_chain": (524288, 128, 10, 32)}
_KG = "const bool many = (o.m + kSkinnyRows - 1) / kSkinnyRows >= 8LL * sms;"
# name -> edits of probes.cu (a text, its replacement); "all" changes nothing.
VARIANTS = {
    "all": None,
    "small": [("big_tiles >= 2LL * sm_count(device)", "big_tiles < 0")],
    "stages2": [("constexpr int kStages = 3;", "constexpr int kStages = 2;")],
    "kg2": [(_KG, "const bool many = sms > 0;")],
    "kg4": [(_KG, "const bool many = sms < 0;")],
    "bounds1": [("return bm == kSplitBM ? 3 : 2;",
                 "return bm == kSplitBM ? 3 : 1;")],
}


def measure(root: str, csrc: str, build_only: bool = False,
            per: int = 10) -> dict:
    """In this process: build ``csrc``'s probes.cu with the package of
    ``root`` and time ``contract`` at every case."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from simpledsp_tpu_torch.kernels import _build
    from simpledsp_tpu_torch.kernels import probes
    from simpledsp_tpu_torch.tools._common import graph_ms
    _build.CSRC_DIR = Path(csrc)
    probes.contract_kernel.library()
    if build_only:
        return {}
    dev = torch.device("cuda", 0)
    out = {"ms": {}, "snr_db": {}}
    for case, (m, k, n, group) in CASES.items():
        gen = torch.Generator(dev).manual_seed(m)
        a = torch.randn(m, k, generator=gen, device=dev)
        b = (torch.randn(n, k, generator=gen, device=dev).T if group else
             torch.randn(k, n, generator=gen, device=dev))
        sf = (torch.randn(m // group, n, generator=gen, device=dev)
              if group else None)

        def run(a=a, b=b, sf=sf, group=group):
            return probes.contract(a, b, sf=sf, group=group or 1)

        ref = probes.contract_reference(a.double(), b.double(),
                                        None if sf is None else sf.double(),
                                        group or 1)
        own = probes.contract_reference(a, b, sf, group or 1)

        def snr(got):
            err = float(((got.double() - ref) ** 2).sum())
            return float(10 * np.log10(float((ref ** 2).sum()) / err))

        got, plain = snr(run()), snr(own)
        if got < 120.0 or got < plain - 6.0:
            raise RuntimeError(f"{case}: {got:.2f} dB (float32 plain "
                               f"{plain:.2f} dB)")
        out["snr_db"][case] = got
        out["ms"][case] = graph_ms(run, per=per)
        del ref, own
    return out


def run(roots=None, variants=("all",), turns: int = 2) -> dict:
    sys.path.insert(0, str(HERE))
    from simpledsp_tpu_torch.tools._common import edited_csrc, time_in_turns
    arms = []
    for root in [Path(r).resolve() for r in (roots or [HERE])]:
        mine = root == HERE
        for v in (variants if mine else ("all",)):
            edits = VARIANTS[v] if mine else None
            csrc = edited_csrc(root, edits and {"probes.cu": edits},
                               f"probes_{v}")
            arms.append((f"{'this' if mine else root}@{v}", str(root),
                         str(csrc)))
    out = time_in_turns(__file__, arms, turns)
    out["summary"] = {}
    for r in out["runs"]:
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
    ap.add_argument("--child", nargs=2, default=None)
    ap.add_argument("--build-only", action="store_true")
    a = ap.parse_args()
    if a.child:
        print(json.dumps(measure(*a.child, build_only=a.build_only)))
        return 0
    print(json.dumps(run(a.roots, tuple(a.variants), a.turns)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
