"""Which library call selects the rank of each window fastest on the card?

``ops/smooth``'s rank filters (``medfilt``, ``medfilt2d``,
``order_filter``) take the ``rank``-th smallest of every window of an
``unfold`` view.  This times the ways PyTorch offers to do that, on the
windows of 64 x 2^20 float32 noise (``chip_smoke.py`` phase 25's 1-D
size) at k = 3 and 9, and of 8 x 2^20 at k = 25 (``medfilt2d``'s 5x5
count): ``torch.sort`` (what the port runs), ``torch.median``,
``torch.kthvalue``, ``torch.topk``, and a sort along the leading axis of
the windows made k-major.  Every form is held bit for bit to the sort's
result; ms a call, median of 3 CUDA-event timings of one call, and the
byte bound (the input read and the output written once).

    python -m simpledsp_tpu_torch.tools.rank_forms
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from simpledsp_tpu_torch.tools._common import (HBM_BPS, cuda_device, main,
                                               median_ms, randn, same_bits)

CASES = ((64, 3), (64, 9), (8, 25))     # (rows of 2^20 samples, window)


def forms(win: torch.Tensor) -> dict:
    """name: a call giving the median of each window (odd k: the element of
    rank k // 2) over ``win``'s last axis."""
    rank = win.shape[-1] // 2
    return {
        "sort": lambda: torch.sort(win, -1).values[..., rank].contiguous(),
        "median": lambda: torch.median(win, -1).values,
        "kthvalue": lambda: torch.kthvalue(win, rank + 1, -1).values,
        "topk": lambda: torch.topk(win, rank + 1, -1, largest=False,
                                   sorted=True).values[..., -1].contiguous(),
        "k-major sort": lambda: torch.sort(
            win.permute(2, 0, 1).contiguous(), 0).values[rank],
    }


def run(device=None) -> dict:
    dev = cuda_device(device)
    out = {}
    for rows, k in CASES:
        x = randn((rows, 1 << 20), k, dev)
        win = F.pad(x, (k // 2, k // 2)).unfold(-1, k, 1)
        calls = forms(win)
        want = calls["sort"]()
        case = {"bound_ms": 2 * x.numel() * x.element_size() / HBM_BPS * 1e3}
        for name, call in calls.items():
            same_bits(call(), want, f"{name} at k = {k}")
            case[name] = median_ms(call, reps=3)
        out[f"{rows} x 2^20, k = {k}"] = case
        del x, win, want
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    main(run)
