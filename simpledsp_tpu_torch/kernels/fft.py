"""Host tables for the kernels' four-step FFT split.

Port of the host side of ``simpledsp_tpu/kernels/fft.py``: the frame split
N = n1 * n2 and the float64-built DFT and twiddle tables in the layouts the
kernels read.  The batched frames kernel itself (``_fft_frames``) is not
ported yet.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np

from simpledsp_tpu_torch.ops.fft import _dft_mats_f64, _twiddle_f64

__all__ = ["fft_split_supported"]


def _best_split(n: int) -> Optional[Tuple[int, int]]:
    """Factor n = n1 * n2 with n2 as LARGE as possible (<= 128), n1 <= 128.

    The chain kernel keeps n2 = 128 for N = 1024 ... 16384: each frame is
    n1 rows of 128 samples, which is also the IIR sub-block.
    """
    for n2 in range(min(n, 128), 0, -1):
        if n % n2 == 0 and n // n2 <= 128:
            return n // n2, n2
    return None


def fft_split_supported(n: int) -> bool:
    return _best_split(n) is not None


@functools.lru_cache(maxsize=None)
def _consts(n: int, inverse: bool, dtype_name: str):
    """Constant tables for n = n1 * n2, in the kernels' layouts."""
    n1, n2 = _best_split(n)
    dt = np.dtype(dtype_name)
    w1c, w1s = _dft_mats_f64(n1)   # true (re, im): W = c + i s, s = -sin fwd
    w2c, w2s = _dft_mats_f64(n2)
    tc, ts = _twiddle_f64(n1, n2)  # T[k1, n2]
    sgn = 1.0 if not inverse else -1.0
    return (n1, n2,
            w1c.astype(dt), (sgn * w1s).astype(dt),
            w2c.astype(dt), (sgn * w2s).astype(dt),
            # twiddle transposed to the post-step-1 (n2, k1) layout
            tc.T.copy().astype(dt), (sgn * ts.T).copy().astype(dt))
