"""Time every form of the chain kernel family on the card: the full
spectrum and each half-spectrum ``layout=`` of ``fused_chain_frames``.

Each form runs through its wrapper on the frames and starts of 16 x 2^20
float32 noise (seed 17, phase 17 of ``chip_smoke.py``) at N = 200, 1024,
4096 and 16384; its time is the median of 7 windows of 20 back-to-back
launches timed by CUDA events, so the card's queue stays full and the
number is the kernel's device time, not the wrapper's host work.  The
grouped layouts take g as the checkout's ``group_frames`` resolves it from
the JAX tile.  Beside them, "ols@nfft": the overlap-save kernel through
``conv_ols_frames`` on the frames of 256 x 65536 float32 noise (seed 0)
with 301 / 1000 / 2000 taps at nfft 4096 / 8192 / 16384 (phase 10 of
``chip_smoke.py``), timed the same way; and "NorthStarChain@4096": the
chain's main path, ``NorthStarChain(fft_size=4096)`` on 64 x 2^20
float32 a call (phase 5 of ``chip_smoke.py``), in ms a call over 7
windows of 10 calls: host-bound, so host time and device time both.

    python3 simpledsp_tpu_torch/tools/chain_forms.py [--root DIR] [--sizes 4096 ...]

``--root`` names the checkout whose package is timed (default: this one),
so another commit unpacked beside it is timed by the same script; run the
two in turns in one call to compare them.  Prints one JSON object,
{"form@N": ms, ..., "g": {"layout@N": g}}; raises without a card.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

SIZES = (200, 1024, 4096, 16384)
OLS_CASES = ((4096, 301), (8192, 1000), (16384, 2000))   # (nfft, taps)
LAYOUTS = ("reg", "k1", "regs", "regw", "fmajor", "reg2", "reg4", "regp",
           "pair")


def run(root=None, sizes=SIZES, per: int = 20, reps: int = 7) -> dict:
    root = Path(root or Path(__file__).resolve().parents[2]).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    kc = importlib.import_module("simpledsp_tpu_torch.kernels.chain")
    kcv = importlib.import_module("simpledsp_tpu_torch.kernels.chain_variants")
    ns = importlib.import_module("simpledsp_tpu_torch.models.northstar")
    common = importlib.import_module("simpledsp_tpu_torch.tools._common")
    if not torch.cuda.is_available():
        raise RuntimeError("the chain forms are timed on the card: no CUDA "
                           "device")
    dev = torch.device("cuda", 0)
    c, t = 16, 1 << 20
    x = torch.as_tensor(np.random.default_rng(17).standard_normal(
        (c, t), dtype=np.float32), device=dev)
    out, groups = {}, {}
    for n in sizes:
        ops = kc.FusedNorthStarOperators(ns.default_design(), n, device=dev)
        s0 = torch.zeros(c, ops.state_dim, device=dev)
        x3, s3, _ = kc.chain_prepass(ops, x[:, :t - t % n].contiguous(), s0)
        tabs, ftabs = ops.tables(), ops.tables(full=True)
        r = kc._tile_frames(x3.shape[0], n, 4, 64)
        forms = {"full": lambda: kc.chain_frames_full(x3, s3, ftabs)}
        for layout in LAYOUTS:
            if layout in ("reg", "k1"):
                forms[layout] = lambda: kc.chain_frames(x3, s3, tabs)
            elif layout == "regs":
                forms[layout] = lambda: kcv.chain_frames_regs(x3, s3, tabs)
            elif layout in ("regw", "fmajor"):
                mode = "wide" if layout == "regw" else "fmajor"
                forms[layout] = (lambda mode=mode:
                                 kcv.chain_frames_store(x3, s3, tabs, mode))
            else:
                try:
                    g = kcv.group_frames(layout, ops.n1, ops.n2, r,
                                         ops.state_dim)
                except TypeError:   # a checkout whose group_frames has no n2
                    g = kcv.group_frames(layout, ops.n1, r, ops.state_dim)
                groups[f"{layout}@{n}"] = g
                forms[layout] = (lambda g=g:
                                 kcv.chain_frames_grouped(x3, s3, tabs, g))
        for name, fn in forms.items():
            out[f"{name}@{n}"] = common.median_ms(fn, reps=reps, per=per)
        del x3, s3
    kols = importlib.import_module("simpledsp_tpu_torch.kernels.ols")
    kfft = importlib.import_module("simpledsp_tpu_torch.kernels.fft")
    xo = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (256, 1 << 16), dtype=np.float32), device=dev)
    for nfft, m in OLS_CASES:
        taps = np.random.default_rng(m).standard_normal(m)
        n2 = kfft._best_split(nfft)[1]
        o1 = -(-(m - 1) // n2)
        hop = nfft - o1 * n2
        nf = -(-(xo.shape[1] + m - 1) // hop)
        frames = torch.nn.functional.pad(
            xo, (o1 * n2, nf * hop - xo.shape[1])).unfold(-1, nfft, hop)
        out[f"ols@{nfft}"] = common.median_ms(
            lambda: kols.conv_ols_frames(frames, taps, overlap_rows=o1),
            reps=reps, per=per)
        del frames
    chain = ns.NorthStarChain(fft_size=4096, device=dev)
    xc = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (64, 1 << 20), dtype=np.float32), device=dev)
    out["NorthStarChain@4096"] = common.median_ms(lambda: chain(xc),
                                                  reps=reps, per=10)
    out["g"] = groups
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--sizes", type=int, nargs="+", default=list(SIZES))
    args = ap.parse_args()
    print(json.dumps(run(args.root, args.sizes)))


if __name__ == "__main__":
    main()
