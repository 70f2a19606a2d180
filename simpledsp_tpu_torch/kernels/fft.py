"""The batched frames FFT and the host tables of the kernels' four-step split.

Port of ``simpledsp_tpu/kernels/fft.py``.  :func:`_fft_frames` transforms F
frames of N = n1 * n2 samples (n1, n2 <= 128, :func:`_best_split`), forward
or inverse, complex or real input (``xi=None``), into (F, N) planes in
natural bin order:

- a CUDA tensor launches the kernel (``csrc/fft.cu`` on the FFT core
  ``csrc/fft_core.cuh``: a mixed-radix Stockham FFT in shared memory,
  radix-16 register passes for the powers of two and a direct small-DFT
  pass for each odd prime factor) or raises;
- a CPU tensor runs :func:`fft_frames_reference`, the TPU kernel's own math:
  a dense n1-point DFT, the twiddle, a dense n2-point DFT and the natural
  order reorder, as IEEE float32 (or float64) matmuls against the
  float64-built tables.

The TPU kernel's (n1, F, n2) output layout and the host transpose after it
are Mosaic workarounds and are not ported: the kernel writes natural order.
Only the HIGHEST precision tier is ported (``precision.py``), and the
kernel picks its own frames per block, so ``frames_per_tile`` is accepted
for the JAX signature and has no effect.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from simpledsp_tpu_torch.kernels import _build
from simpledsp_tpu_torch.ops.fft import _dft_mats_f64, _twiddle_f64
from simpledsp_tpu_torch.precision import ieee_fp32
from simpledsp_tpu_torch.utils import tracing

__all__ = ["fft_split_supported", "pallas_fft_supported",
           "fft_frames_reference", "fft_frames_ri", "rfft_frames",
           "fft_frames_kernel"]


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


pallas_fft_supported = fft_split_supported


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


def _check_precision(precision) -> None:
    if precision not in (None, "highest"):
        raise ValueError(f"only the HIGHEST precision tier is ported (IEEE "
                         f"float32, see precision.py), got {precision!r}")


def fft_frames_reference(xr: torch.Tensor, xi: Optional[torch.Tensor], *,
                         inverse: bool) -> torch.Tensor:
    """Plain version of the frames kernel: (..., N) planes (``xi=None`` for
    real input) -> the unscaled N-point DFT as (..., N) (re, im) planes in
    natural bin order, in the input's dtype.

    x viewed as (n1, n2) rows; step 1 contracts t1 with the n1-point DFT,
    step 2 multiplies by exp(-+2 pi i k1 t2 / N), step 3 contracts t2 with
    the n2-point DFT, and bin k = k1 + n1 k2 is out[k1, k2] read
    transposed."""
    n = xr.shape[-1]
    split = _best_split(n)
    if split is None:
        raise ValueError(f"size {n} not supported by the frames kernel")
    _, _, w1c, w1s, w2c, w2s, tct, tst = _consts(
        n, bool(inverse), torch.empty((), dtype=xr.dtype).numpy().dtype.name)
    n1, n2 = split
    lead = xr.shape[:-1]

    def tab(a):
        return torch.as_tensor(a, device=xr.device)

    w1c, w1s, w2c, w2s = map(tab, (w1c, w1s, w2c, w2s))
    tc, ts = tab(tct.T), tab(tst.T)                 # (k1, t2)
    x = xr.reshape(lead + (n1, n2))
    with ieee_fp32():
        cr, sr = w1c @ x, w1s @ x
        if xi is None:
            yr1, yi1 = cr, sr
        else:
            v = xi.reshape(lead + (n1, n2))
            yr1 = cr - w1s @ v
            yi1 = w1c @ v + sr
        tr = yr1 * tc - yi1 * ts
        ti = yi1 * tc + yr1 * ts
        # W2 is symmetric: contracting t2 is a right product with it.
        outr = tr @ w2c - ti @ w2s                  # (..., k1, k2)
        outi = ti @ w2c + tr @ w2s
    return (outr.transpose(-1, -2).reshape(lead + (n,)),
            outi.transpose(-1, -2).reshape(lead + (n,)))


# -- the CUDA kernel ----------------------------------------------------------

_MAX_N = 16384


def _plan(n: int) -> List[int]:
    """The passes of ``csrc/fft_core.cuh`` for an n-point transform: each
    odd prime factor (ascending), then radix 16 while 16 divides what is
    left, then one pass of 8, 4 or 2 for the rest of the power of two
    (4096 = 16 16 16, 2048 = 16 16 8, 16384 = 16 16 16 4)."""
    radices = []
    m = n
    while m % 2 == 0:
        m //= 2
    p = 3
    while m > 1:
        while m % p == 0:
            radices.append(p)
            m //= p
        p += 2
    pow2 = n // int(np.prod(radices, dtype=np.int64))
    while pow2 % 16 == 0:
        radices.append(16)
        pow2 //= 16
    if pow2 > 1:
        radices.append(pow2)
    return radices


def _kernel_table_f64(n: int, radices=None) -> np.ndarray:
    """The twiddles and small-DFT tables of ``csrc/fft_core.cuh`` in the
    order it reads them, (count, 2) float64 (re, im), for the plan
    ``radices`` (default :func:`_plan`): for each pass of radix r and stride
    ns, the (r - 1) ns twiddles exp(-2 pi i t k / (r ns)) laid out
    [t - 1][k]; then, for an odd r, exp(-2 pi i t / r), t < r.  Phases are
    exact integers mod n before the one trig evaluation."""
    parts = []
    ns = 1
    for r in (_plan(n) if radices is None else radices):
        t = np.arange(1, r, dtype=np.int64)[:, None]
        k = np.arange(ns, dtype=np.int64)[None, :]
        ph = (t * k * (n // (r * ns))) % n
        parts.append(((-2.0 * np.pi / n) * ph).reshape(-1))
        if r % 2:
            parts.append((-2.0 * np.pi / n) * (np.arange(r) * (n // r)))
        ns *= r
    ang = np.concatenate(parts) if parts else np.zeros(0)
    return np.stack([np.cos(ang), np.sin(ang)], -1)


def _split_table_f64(n: int) -> np.ndarray:
    """The real-FFT split twiddles exp(-2 pi i k / n), k <= n / 4, (count, 2)
    float64 (re, im), for an even n: the chain kernel turns the n/2-point
    complex FFT Z of z[t] = y[2t] + i y[2t+1] into the real FFT X of y with
    X[k] = (Z[k] + conj Z[n/2 - k]) / 2 - i w^k (Z[k] - conj Z[n/2 - k]) / 2,
    pairing bin k with bin n/2 - k, whose twiddle is -conj(w^k)."""
    ang = (-2.0 * np.pi / n) * np.arange(n // 4 + 1, dtype=np.int64)
    return np.stack([np.cos(ang), np.sin(ang)], -1)


@functools.lru_cache(maxsize=64)
def _kernel_tables(n: int, device: torch.device):
    """The kernel's float32 table on ``device`` (at least one entry) and its
    pass plan as a ctypes int array."""
    tab = _kernel_table_f64(n)
    if not len(tab):
        tab = np.zeros((1, 2))
    radices = _plan(n)
    plan = (ctypes.c_int * max(1, len(radices)))(*radices)
    return (torch.as_tensor(tab.astype(np.float32), device=device), plan,
            len(radices))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """``csrc/fft.cu`` built and loaded, its entry point typed."""
    lib = _build.load_library("sdsp_fft", ("fft.cu",), ("fft_core.cuh",))
    fn = lib.sdsp_fft_frames_f32
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 4
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


class _FFTFramesKernel:
    """The CUDA frames FFT kernel: built from ``csrc/fft.cu`` at first
    launch; ``launches`` counts its launches."""

    launches = tracing.Launches()

    def __init__(self):
        self.launch_counter = tracing.kernel_counter("fft_frames")

    def library(self) -> ctypes.CDLL:
        return _library()

    def __call__(self, xr: torch.Tensor, xi: Optional[torch.Tensor], *,
                 inverse: bool, scale: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """xr, xi (F, N) float32 planes on the card, any non-negative
        strides (xi None: real input) -> (F, N) contiguous output planes."""
        planes = (xr,) if xi is None else (xr, xi)
        for p in planes:
            if p.device.type != "cuda" or p.dtype != torch.float32:
                raise ValueError(f"the CUDA frames FFT takes float32 on a CUDA "
                                 f"device, got {p.dtype} on {p.device}")
            if p.dim() != 2 or p.shape != xr.shape:
                raise ValueError(f"expected (F, N) planes of one shape, got "
                                 f"{tuple(p.shape)} and {tuple(xr.shape)}")
        if xi is not None and xi.device != xr.device:
            raise ValueError(f"planes on {xr.device} and {xi.device}")
        f, n = xr.shape
        if not fft_split_supported(n):
            raise ValueError(f"the CUDA frames FFT takes N = n1 * n2 with n1, "
                             f"n2 <= 128, got N = {n}")
        tab, plan, npass = _kernel_tables(n, xr.device)
        yr = torch.empty((f, n), dtype=torch.float32, device=xr.device)
        yi = torch.empty_like(yr)
        si = (0, 0) if xi is None else xi.stride()
        stream = torch.cuda.current_stream(xr.device).cuda_stream
        rc = self.library().sdsp_fft_frames_f32(
            xr.data_ptr(), 0 if xi is None else xi.data_ptr(),
            xr.stride(0), xr.stride(1), si[0], si[1], f, n,
            ctypes.cast(plan, ctypes.c_void_p), npass, tab.data_ptr(),
            yr.data_ptr(), yi.data_ptr(), int(bool(inverse)), int(bool(scale)),
            xr.device.index, stream)
        if rc != 0:
            raise RuntimeError(f"frames FFT kernel launch failed: CUDA error "
                               f"{rc}")
        self.launches += 1
        return yr, yi


fft_frames_kernel = _FFTFramesKernel()


def _fft_frames(xr: torch.Tensor, xi: Optional[torch.Tensor], *,
                inverse: bool, frames_per_tile: int = 8, precision=None,
                scale: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Core entry: frames (F, N) float planes -> (F, N) output planes.

    ``scale=False`` skips the inverse 1/N factor (the unscaled contract of
    ``ops.fft._fft_ri``, whose public wrappers scale once at the top
    level)."""
    _check_precision(precision)
    if frames_per_tile < 1:
        raise ValueError(f"frames_per_tile must be >= 1, got {frames_per_tile}")
    if xr.dim() != 2:
        raise ValueError(f"frames must be (F, N), got {tuple(xr.shape)}")
    n = xr.shape[-1]
    if _best_split(n) is None:
        raise ValueError(f"size {n} not supported by the fused kernel")
    if xr.device.type == "cuda":
        return fft_frames_kernel(xr, xi, inverse=inverse,
                                 scale=inverse and scale)
    if xr.device.type != "cpu":
        raise ValueError(f"the frames FFT runs on CUDA or CPU tensors, got "
                         f"{xr.device}")
    yr, yi = fft_frames_reference(xr, xi, inverse=inverse)
    if inverse and scale:
        s = 1.0 / n
        return yr * s, yi * s
    return yr, yi


def fft_frames_ri(xr: torch.Tensor, xi: torch.Tensor, *,
                  inverse: bool = False, frames_per_tile: int = 8,
                  precision=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused-kernel FFT over the last axis of (..., F, N) (re, im) planes
    (the inverse scaled by 1/N)."""
    shape = xr.shape
    yr, yi = _fft_frames(xr.reshape(-1, shape[-1]), xi.reshape(-1, shape[-1]),
                         inverse=inverse, frames_per_tile=frames_per_tile,
                         precision=precision)
    return yr.reshape(shape), yi.reshape(shape)


def rfft_frames(x: torch.Tensor, *, frames_per_tile: int = 8,
                precision=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused-kernel forward FFT of REAL frames (..., N) -> (re, im) planes
    of all N bins; no imaginary input plane is read or made."""
    shape = x.shape
    yr, yi = _fft_frames(x.reshape(-1, shape[-1]), None, inverse=False,
                         frames_per_tile=frames_per_tile, precision=precision)
    return yr.reshape(shape), yi.reshape(shape)
