"""Split the chain kernel's time on the card by stage, for "reg" (the IIR
block by column bands on the CUDA cores, ``csrc/chain.cu``) and "regs"
(split-bf16 products on the tensor cores, ``csrc/chain_tc.cu``).

Builds copies of both sources that stop every block after its loads, or
after its IIR block (the ``SDSP_CHAIN_CUT_AT`` hook of
``csrc/chain_natural.cuh``, 1 or 2, the values so far kept live) and times
them beside the whole kernels, on the frames and starts of 16 x 2^20
float32 noise (seed 17, as the chain-forms timer of commit e437957) at
N = 200, 1024, 4096 and 16384, as CUDA-graph replays: device time, without
the wrappers' host work.  A stage's time is the difference of two cuts:
"load", then "iir" (the loads and the IIR block), then "all".

    python3 simpledsp_tpu_torch/tools/chain_stages.py [--sizes 4096 ...]

Prints one JSON object, {"form@N": {"load": ms, "iir": ms, "all": ms}};
raises without a card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

SIZES = (200, 1024, 4096, 16384)
# One library built in a process of its own, so that all build at once.
PREBUILD = """import sys; sys.path.insert(0, {root!r})
from pathlib import Path
from simpledsp_tpu_torch.kernels import _build
from simpledsp_tpu_torch.kernels import chain as kc, chain_variants as kcv
_build.CSRC_DIR = Path({csrc!r}); {lib}()"""


def run(sizes=SIZES, per: int = 20) -> dict:
    root = str(Path(__file__).resolve().parents[2])
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from simpledsp_tpu_torch.kernels import _build
    from simpledsp_tpu_torch.kernels import chain as kc
    from simpledsp_tpu_torch.kernels import chain_variants as kcv
    from simpledsp_tpu_torch.models.northstar import default_design
    from simpledsp_tpu_torch.tools._common import (build_all, edited_csrc,
                                                   graph_ms)
    if not torch.cuda.is_available():
        raise RuntimeError("the stage split times the card: no CUDA device")
    dev = torch.device("cuda", 0)
    c, t = 16, 1 << 20
    x = torch.as_tensor(np.random.default_rng(17).standard_normal(
        (c, t), dtype=np.float32), device=dev)
    csrc = _build.CSRC_DIR
    cuts = {stage: edited_csrc(Path(root), {
        name: [("", f"#define SDSP_CHAIN_CUT_AT {at}\n")]
        for name in ("chain.cu", "chain_tc.cu")}, f"chain_cut_{stage}")
        for stage, at in (("load", 1), ("iir", 2))}

    def use(src_dir):
        _build.CSRC_DIR = src_dir
        _build.load_library.cache_clear()
        kc._library.cache_clear()
        kcv._tc_library.cache_clear()

    out = {"device": torch.cuda.get_device_name(0)}
    try:
        build_all([[sys.executable, "-c", PREBUILD.format(
            root=root, csrc=str(src_dir), lib=lib)]
            for src_dir in (*cuts.values(), csrc)
            for lib in ("kc._library", "kcv._tc_library")],
            "a build of the chain kernel")
        for n in sizes:
            ops = kc.FusedNorthStarOperators(default_design(), n, device=dev)
            s0 = torch.zeros(c, ops.state_dim, device=dev)
            x3, s3, _ = kc.chain_prepass(ops, x[:, :t - t % n].contiguous(), s0)
            tabs = ops.tables()
            forms = {"reg": lambda: kc.chain_frames(x3, s3, tabs),
                     "regs": lambda: kcv.chain_frames_regs(x3, s3, tabs)}
            for form, fn in forms.items():
                ms = {}
                for stage, src_dir in (*cuts.items(), ("all", csrc)):
                    use(src_dir)
                    ms[stage] = graph_ms(fn, per=per)
                out[f"{form}@{n}"] = ms
            del x3, s3
    finally:
        use(csrc)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=list(SIZES))
    print(json.dumps(run(ap.parse_args().sizes)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
