"""Fused overlap-save convolution: FFT -> tap-spectrum product -> inverse
FFT per frame, in one kernel.

Port of ``simpledsp_tpu/kernels/ols.py``.  A frame of nfft real samples
(o1 n2 samples of history, then hop new ones) gives hop = nfft - o1 n2
valid outputs of the linear convolution with real taps; o1 = ceil((m-1)/n2)
rounds the aliased overlap up to whole n2-sample rows of the four-step
split nfft = n1 n2 (``kernels/fft._best_split``).

:func:`conv_ols_frames` and :func:`convolve_ols_fused` launch the CUDA
kernel (``csrc/ols.cu``: two real frames per complex transform on the FFT
core ``csrc/fft_core.cuh``, with the frames FFT kernel's plan and table
from ``kernels/fft.py`` and the plan reversed for the inverse; the forward
transform's last pass turns into the inverse's first through conj(Z H) in
registers, the inverse's last pass stores the samples) on CUDA tensors and
run
:func:`conv_ols_frames_reference` on CPU tensors.  The reference is the JAX
kernel's own math: the forward four-step as matmuls against the float64-built
tables of :func:`_ols_consts`, the product with the 1/N-scaled spectrum,
the inverse four-step read straight from the forward layout, and the o1
aliased rows dropped.  There is no fallback from the kernel to the
reference: a CUDA tensor launches the kernel or raises.

Frames are read in place: :func:`convolve_ols_fused` hands the kernel the
unpadded signal with a frame stride of hop, and the kernel reads the zero
history and tail as zeros, so no framed or padded copy of the input is made.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from simpledsp_tpu_torch.kernels import _build
from simpledsp_tpu_torch.kernels.fft import (_best_split, _kernel_table_f64,
                                             _kernel_tables as _fft_tables,
                                             _plan)
from simpledsp_tpu_torch.ops.fft import _dft_mats_f64, _twiddle_f64
from simpledsp_tpu_torch.precision import ieee_fp32
from simpledsp_tpu_torch.utils import tracing

__all__ = ["OLSTables", "ols_supported", "ols_tables", "conv_ols_frames",
           "conv_ols_frames_reference", "convolve_ols_fused", "ols_kernel"]


def ols_supported(nfft: int) -> bool:
    return _best_split(nfft) is not None


@functools.lru_cache(maxsize=64)
def _ols_consts(nfft: int, taps_bytes: bytes, m: int, dtype_name: str):
    """Constant tables of the four-step form: forward DFT mats and twiddles,
    the inverse step-C table, and the tap spectrum in the (k1, k2) layout
    with the 1/N inverse scale folded in (the JAX package's tables, bit for
    bit)."""
    n1, n2 = _best_split(nfft)
    dt = np.dtype(dtype_name)
    w1c, w1s = _dft_mats_f64(n1)     # forward: W = c + i s, s = -sin
    w2c, w2s = _dft_mats_f64(n2)
    tc, ts = _twiddle_f64(n1, n2)    # (n1, n2), forward signs
    taps = np.frombuffer(taps_bytes, dtype=np.float64, count=m)
    H = np.fft.fft(taps, nfft) / nfft          # 1/N folded into H
    Hg = H.reshape(n2, n1).T                   # (k1, k2), bin k = k1 + n1 k2
    w1cs = np.concatenate([w1c, w1s], axis=0)  # forward step 1, (2 n1, n1)
    # Inverse step C: y = Re{W1+ (Br + i Bi)} = W1c Br + w1s Bi (w1s holds
    # -sin), one (n1, 2 n1) table against [Br; Bi].
    w1inv = np.concatenate([w1c, w1s], axis=1)
    return (n1, n2,
            w1cs.astype(dt),
            w2c.astype(dt), w2s.astype(dt),
            tc.astype(dt), ts.astype(dt),
            w1inv.astype(dt),
            np.ascontiguousarray(Hg.real).astype(dt),
            np.ascontiguousarray(Hg.imag).astype(dt))


class OLSTables(NamedTuple):
    """:func:`_ols_consts` as tensors, for the plain version."""

    w1cs: torch.Tensor    # (2 n1, n1)
    w2c: torch.Tensor     # (n2, n2)
    w2s: torch.Tensor     # (n2, n2)
    tc: torch.Tensor      # (n1, n2)
    ts: torch.Tensor      # (n1, n2)
    w1inv: torch.Tensor   # (n1, 2 n1)
    hr: torch.Tensor      # (n1, n2)
    hi: torch.Tensor      # (n1, n2)


def ols_tables(nfft: int, taps64, dtype=torch.float32,
               device=None) -> OLSTables:
    """The plain version's tables for ``nfft`` and the float64 taps, built
    in float64 on the host and cast to ``dtype`` on ``device``."""
    taps64 = np.asarray(taps64, np.float64)
    npdt = torch.empty((), dtype=dtype).numpy().dtype
    consts = _ols_consts(nfft, taps64.tobytes(), taps64.size, npdt.name)
    return OLSTables(*(torch.as_tensor(a, device=device) for a in consts[2:]))


def conv_ols_frames_reference(frames: torch.Tensor, tables: OLSTables,
                              overlap_rows: int) -> torch.Tensor:
    """Plain PyTorch version of the overlap-save kernel: frames
    (..., F, nfft) -> valid outputs (..., F, hop), in the frames' dtype."""
    n1, n2 = tables.tc.shape
    o1 = int(overlap_rows)
    lead = frames.shape[:-1]
    x = frames.reshape(lead + (n1, n2))
    t = tables
    with ieee_fp32():
        # forward four-step on the real frame: (k1, t2) after step 1 + twiddle
        cs = torch.matmul(t.w1cs, x)
        c, s = cs[..., :n1, :], cs[..., n1:, :]
        tr = c * t.tc - s * t.ts
        ti = s * t.tc + c * t.ts
        fr = tr @ t.w2c.T - ti @ t.w2s.T           # F (k1, k2)
        fi = ti @ t.w2c.T + tr @ t.w2s.T
        # product with H / N
        gr = fr * t.hr - fi * t.hi
        gi = fr * t.hi + fi * t.hr
        # inverse four-step on the (k1, k2) layout: conj(W2), conj twiddle,
        # then the stacked step C keeping only the real plane
        ar = gr @ t.w2c.T + gi @ t.w2s.T
        ai = gi @ t.w2c.T - gr @ t.w2s.T
        br = ar * t.tc + ai * t.ts
        bi = ai * t.tc - ar * t.ts
        y = torch.matmul(t.w1inv, torch.cat([br, bi], -2))   # (t1, t2)
    return y[..., o1:, :].reshape(lead + ((n1 - o1) * n2,))


@functools.lru_cache(maxsize=64)
def _inverse_table(nfft: int, device: torch.device) -> torch.Tensor:
    """The FFT core's table for the plan of ``kernels/fft.py`` reversed,
    float32 on ``device``: the kernel's inverse transform starts with the
    radix its forward transform ends with."""
    tab = _kernel_table_f64(nfft, _plan(nfft)[::-1])
    return torch.as_tensor(tab.astype(np.float32), device=device)


@functools.lru_cache(maxsize=64)
def _tap_spectrum(nfft: int, taps_bytes: bytes, m: int,
                  device: torch.device) -> torch.Tensor:
    """The kernel's tap spectrum on ``device``: the nfft-point spectrum of
    the taps divided by nfft, built in float64, (nfft, 2) float32 (re, im)
    in natural order."""
    H = np.fft.fft(np.frombuffer(taps_bytes, np.float64, count=m), nfft) / nfft
    return torch.as_tensor(np.stack([H.real, H.imag], -1).astype(np.float32),
                           device=device)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """``csrc/ols.cu`` built and loaded, its entry point typed."""
    lib = _build.load_library("sdsp_ols", ("ols.cu",), ("fft_core.cuh",))
    fn = lib.sdsp_ols_frames_f32
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_longlong] * 4
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def kernel_supports(nfft: int) -> bool:
    """Frame sizes the CUDA kernel takes: powers of two, 64 to 16384 (the
    route's 4096, 8192 and 16384 among them)."""
    return 64 <= nfft <= 16384 and nfft & (nfft - 1) == 0


class _OLSKernel:
    """The CUDA overlap-save kernel: built from ``csrc/ols.cu`` at first
    launch; ``launches`` counts its launches."""

    launches = tracing.Launches()

    def __init__(self):
        self.launch_counter = tracing.kernel_counter("ols")

    def library(self) -> ctypes.CDLL:
        return _library()

    def __call__(self, x: torch.Tensor, *, nf: int, frame_stride: int,
                 offset: int, valid: int, nfft: int, skip: int,
                 taps64: np.ndarray) -> torch.Tensor:
        """Frames of ``nfft`` samples read in place from the rows of x
        (R, W): frame f of a row starts at f frame_stride - offset, samples
        outside [0, valid) are zeros.  Returns (R nf, nfft - skip)."""
        if not kernel_supports(nfft):
            raise ValueError(f"the CUDA overlap-save kernel takes nfft a power "
                             f"of two from 64 to 16384, got {nfft}")
        if x.device.type != "cuda" or x.dtype != torch.float32:
            raise ValueError(f"the CUDA overlap-save kernel takes float32 on a "
                             f"CUDA device, got {x.dtype} on {x.device}")
        if x.dim() != 2 or x.stride(-1) != 1:
            raise ValueError(f"expected rows (R, W) with unit sample stride, "
                             f"got shape {tuple(x.shape)} strides {x.stride()}")
        rows, row_stride = x.shape[0], x.stride(0)
        tab, plan, npass = _fft_tables(nfft, x.device)
        itab = _inverse_table(nfft, x.device)
        hs = _tap_spectrum(nfft, taps64.tobytes(), taps64.size, x.device)
        out = torch.empty((rows * nf, nfft - skip), dtype=x.dtype,
                          device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = self.library().sdsp_ols_frames_f32(
            x.data_ptr(), row_stride, frame_stride, offset, valid, rows, nf,
            ctypes.cast(plan, ctypes.c_void_p), npass, tab.data_ptr(),
            itab.data_ptr(), hs.data_ptr(), out.data_ptr(), nfft, skip,
            x.device.index, stream)
        if rc != 0:
            raise RuntimeError(f"overlap-save kernel launch failed: CUDA error "
                               f"{rc}")
        self.launches += 1
        return out


ols_kernel = _OLSKernel()


def conv_ols_frames(frames: torch.Tensor, taps64, *,
                    overlap_rows: int) -> torch.Tensor:
    """Fused OLS: frames (F, nfft) or (B, F, nfft) real (each o1 n2 samples
    of history, then hop new ones) -> valid outputs (..., F, hop),
    hop = nfft - overlap_rows n2.  ``overlap_rows`` must satisfy
    overlap_rows * n2 >= len(taps) - 1.  The frames may be a strided view
    (``xp.unfold(-1, nfft, hop)``); the kernel reads them in place."""
    if frames.dim() not in (2, 3):
        raise ValueError(f"frames must be (F, nfft) or (B, F, nfft), got "
                         f"{tuple(frames.shape)}")
    taps64 = np.asarray(taps64, np.float64)
    nfft = frames.shape[-1]
    split = _best_split(nfft)
    if split is None:
        raise ValueError(f"size {nfft} not supported by the fused kernel")
    n1, n2 = split
    o1 = int(overlap_rows)
    if o1 * n2 < taps64.size - 1:
        raise ValueError(f"overlap {o1}*{n2} < taps-1 ({taps64.size - 1})")
    if o1 >= n1:
        raise ValueError(f"overlap rows {o1} leave no output (n1={n1})")
    if frames.device.type == "cuda":
        if frames.stride(-1) != 1:
            frames = frames.contiguous()
        lead, nf = frames.shape[:-2], frames.shape[-2]
        fs = frames.stride(-2)
        rows = frames if frames.dim() == 3 else frames[None]
        # Rows as (B, W) views over the frames' storage, W = the span the
        # frames of a row cover.
        span = (nf - 1) * fs + nfft if nf else 0
        src = rows.as_strided((rows.shape[0], span), (rows.stride(0), 1))
        y = ols_kernel(src, nf=nf, frame_stride=fs, offset=0, valid=span,
                       nfft=nfft, skip=o1 * n2, taps64=taps64)
        return y.reshape(lead + (nf, nfft - o1 * n2))
    if frames.device.type == "cpu":
        return conv_ols_frames_reference(
            frames, ols_tables(nfft, taps64, frames.dtype, frames.device), o1)
    raise ValueError(f"conv_ols_frames runs on CUDA or CPU tensors, got "
                     f"{frames.device}")


def convolve_ols_fused(x: torch.Tensor, taps64, *,
                       nfft: int = 4096) -> torch.Tensor:
    """FULL linear convolution of real (..., T) with real taps via the
    overlap-save kernel: returns (..., T + m - 1).

    Frame f of a row is xp[f hop : f hop + nfft], xp the signal with
    o = ceil((m-1)/n2) n2 zeros in front and zeros behind.  On CUDA the
    kernel reads the frames from x in place; on the CPU xp is padded and
    viewed with ``unfold`` for the plain version.
    """
    taps64 = np.asarray(taps64, np.float64)
    m = taps64.size
    split = _best_split(nfft)
    if split is None:
        raise ValueError(f"size {nfft} not supported by the fused kernel")
    n2 = split[1]
    o1 = -(-(m - 1) // n2)
    o = o1 * n2
    hop = nfft - o
    if hop <= 0:
        raise ValueError(f"taps ({m}) too long for nfft={nfft}")
    lead = x.shape[:-1]
    t = x.shape[-1]
    total = t + m - 1
    nf = -(-total // hop)
    x2 = x.reshape(-1, t)
    if x.device.type == "cuda":
        if x2.stride(-1) != 1:
            x2 = x2.contiguous()
        y = ols_kernel(x2, nf=nf, frame_stride=hop, offset=o, valid=t,
                       nfft=nfft, skip=o, taps64=taps64)
    elif x.device.type == "cpu":
        frames = F.pad(x2, (o, nf * hop - t)).unfold(-1, nfft, hop)
        y = conv_ols_frames_reference(
            frames, ols_tables(nfft, taps64, x.dtype, x.device), o1)
    else:
        raise ValueError(f"convolve_ols_fused runs on CUDA or CPU tensors, "
                         f"got {x.device}")
    return y.reshape(x2.shape[0], nf * hop)[:, :total].reshape(lead + (total,))
