"""Split the PFB kernel's time on the card by stage.

Builds copies of a checkout's ``simpledsp_tpu_torch/csrc/pfb.cu`` that stop
after each stage and times each, with the full kernel, on the receiver
banks' fm_dec shape (16 streams x 2^20 samples, M = K = 16 by default, 64
audio taps, decim 4) as CUDA-graph replays: device time, without the
wrapper's host work.  A stage's time is the difference of two cuts.

    python3 simpledsp_tpu_torch/tools/pfb_stages.py [--root DIR] [--m 16 --k 16]

``--root`` names the checkout whose package and kernel are timed (default:
this one), so another commit unpacked beside it is split by the same
script.  The source is cut by defining its ``SDSP_PFB_CUT_AT`` hook (1
input, 2 FIR, 3 FFT, 4 demod).  Prints one JSON object; raises without a
card.
"""

from __future__ import annotations

import argparse
import importlib
import json
import shutil
import sys
from pathlib import Path

CUTS = 4
STAGES = ("input", "fir", "fft", "demod", "decim")


def cut_source(text: str, n: int) -> str:
    """pfb.cu stopped after stage n (1-4)."""
    return f"#define SDSP_PFB_CUT_AT {n}\n" + text


def run(root=None, m: int = 16, k: int = 16, per: int = 20) -> dict:
    root = Path(root or Path(__file__).resolve().parents[2]).resolve()
    sys.path.insert(0, str(root))
    import torch

    build = importlib.import_module("simpledsp_tpu_torch.kernels._build")
    kpfb = importlib.import_module("simpledsp_tpu_torch.kernels.pfb")
    chan_mod = importlib.import_module("simpledsp_tpu_torch.ops.channelizer")
    fir = importlib.import_module("simpledsp_tpu_torch.design.fir")
    common = importlib.import_module("simpledsp_tpu_torch.tools._common")
    if not torch.cuda.is_available():
        raise RuntimeError("the stage split times the card: no CUDA device")
    dev = torch.device("cuda", 0)
    b, t, kd, decim = 16, 1 << 20, 64, 4
    chan = chan_mod.PFBChannelizer(m, taps_per_channel=k, device=dev)
    ops = chan.kernel_ops
    g = t // m
    w = kpfb.flat_pad_to(ops, g)
    gen = torch.Generator(device=dev).manual_seed(6)
    xr = torch.randn(b, w, device=dev, generator=gen)
    xi = torch.randn(b, w, device=dev, generator=gen)
    pr, pi = (torch.randn(b, m, 1, device=dev, generator=gen) for _ in range(2))
    ah = torch.randn(b, m, kd - 1, device=dev, generator=gen)
    dtaps = torch.as_tensor(fir.lowpass_taps(kd, 0.4 / decim, fs=1.0),
                            dtype=torch.float32, device=dev)
    tabs = ops.tables(dev)

    def call():
        return kpfb.pfb_flat_kernel("fm_dec", tabs, xr, xi, pr, pi, ah, dtaps,
                                    gain=0.2, g=g, decim=decim, emit_sum=False,
                                    tile=None)

    src = build.CSRC_DIR / "pfb.cu"
    text = src.read_text()
    out = {"root": str(root), "m": m, "k": k, "device": torch.cuda.get_device_name(0),
           "ms": {}}
    csrc = build.CSRC_DIR
    try:
        for n in list(range(1, CUTS + 1)) + [None]:
            if n is not None:
                cut_dir = build.BUILD_DIR / f"pfb_cut{n}"
                shutil.rmtree(cut_dir, ignore_errors=True)
                shutil.copytree(csrc, cut_dir)
                (cut_dir / "pfb.cu").write_text(cut_source(text, n))
                build.CSRC_DIR = cut_dir
            else:
                build.CSRC_DIR = csrc
            build.load_library.cache_clear()
            kpfb._library.cache_clear()
            kpfb._tile.cache_clear()
            out["ms"][STAGES[n - 1] if n else "all"] = common.graph_ms(
                call, per=per)
    finally:
        build.CSRC_DIR = csrc
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--m", type=int, default=16)
    ap.add_argument("--k", type=int, default=16)
    a = ap.parse_args()
    print(json.dumps(run(a.root, a.m, a.k)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
