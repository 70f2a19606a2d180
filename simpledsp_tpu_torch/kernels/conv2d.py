"""Direct VALID 2-D convolution in one kernel.

Port of ``simpledsp_tpu/kernels/conv2d.py``.  :func:`conv2d_valid_fused`
convolves a pre-padded (..., Hp, Wp) float32 image with already-flipped
host (kh, kw) taps: the CUDA kernel (``csrc/conv2d.cu``) on CUDA tensors,
:func:`conv2d_valid_reference` on CPU tensors, and nothing else: a CUDA
tensor launches the kernel or raises.  The kernel reads the image once and
writes the output once, and is bit for bit the plain version (the same
rounded products and sums, in the same tap order).

Gate (:func:`conv2d_fused_supported`): at most 169 taps (13 x 13), the
route choice of the JAX package, where larger kernels take the FFT route.
The JAX gate also bounds the TPU's VMEM (the whole padded image resident);
that term has no meaning on the card, where the kernel stages a tile of the
image in shared memory, and is dropped.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from simpledsp_tpu_torch.kernels import _build
from simpledsp_tpu_torch.utils import tracing

__all__ = ["conv2d_fused_supported", "conv2d_valid_fused",
           "conv2d_valid_reference", "conv2d_kernel"]

_MAX_TAPS = 169

def conv2d_fused_supported(kh: int, kw: int) -> bool:
    """Whether the fused kernel takes a (kh, kw) kernel: at most 169 taps,
    whatever the image size (see the module docstring)."""
    return kh * kw <= _MAX_TAPS


def conv2d_valid_reference(xp: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Plain version: VALID real 2-D convolution of the pre-padded
    (..., Hp, Wp) image with the already-flipped (kh, kw) tensor ``k`` (the
    image's dtype), as kh kw shifted multiply-adds, i outer and j inner."""
    kh, kw = k.shape
    oh = xp.shape[-2] - kh + 1
    ow = xp.shape[-1] - kw + 1
    acc = torch.zeros(xp.shape[:-2] + (oh, ow), dtype=xp.dtype,
                      device=xp.device)
    for i in range(kh):
        for j in range(kw):
            acc = acc + k[i, j] * xp[..., i: i + oh, j: j + ow]
    return acc


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """``csrc/conv2d.cu`` built and loaded, its entry point typed."""
    lib = _build.load_library("sdsp_conv2d", ("conv2d.cu",))
    fn = lib.sdsp_conv2d_valid_f32
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


class _Conv2dKernel:
    """The CUDA direct conv2d kernel: built from ``csrc/conv2d.cu`` at first
    launch; ``launches`` counts its launches."""

    launches = tracing.Launches()

    def __init__(self):
        self.launch_counter = tracing.kernel_counter("conv2d")

    def library(self) -> ctypes.CDLL:
        return _library()

    def __call__(self, x3: torch.Tensor, k64: np.ndarray) -> torch.Tensor:
        """x3 (B, Hp, Wp) float32 on the card, k64 (kh, kw) flipped host
        taps -> (B, Hp - kh + 1, Wp - kw + 1)."""
        kh, kw = k64.shape
        if kh * kw > _MAX_TAPS:
            raise ValueError(f"the CUDA conv2d kernel takes at most "
                             f"{_MAX_TAPS} taps, got {kh}x{kw}")
        if x3.device.type != "cuda" or x3.dtype != torch.float32:
            raise ValueError(f"the CUDA conv2d kernel takes float32 on a CUDA "
                             f"device, got {x3.dtype} on {x3.device}")
        x3 = x3.contiguous()
        b, hp, wp = x3.shape
        out = torch.empty((b, hp - kh + 1, wp - kw + 1), dtype=x3.dtype,
                          device=x3.device)
        taps = np.ascontiguousarray(k64, dtype=np.float32)
        stream = torch.cuda.current_stream(x3.device).cuda_stream
        rc = self.library().sdsp_conv2d_valid_f32(
            x3.data_ptr(), out.data_ptr(), b, hp, wp,
            taps.ctypes.data_as(ctypes.c_void_p), kh, kw, x3.device.index,
            stream)
        if rc != 0:
            raise RuntimeError(f"conv2d kernel launch failed: CUDA error {rc}")
        self.launches += 1
        return out


conv2d_kernel = _Conv2dKernel()


def conv2d_valid_fused(xp: torch.Tensor, k64) -> torch.Tensor:
    """VALID 2-D convolution of the pre-padded (..., Hp, Wp) float32 image
    with the already-flipped concrete (kh, kw) host kernel: the fused
    drop-in for the plain direct route (:func:`conv2d_valid_reference`)."""
    k64 = np.asarray(k64, dtype=np.float64)
    kh, kw = k64.shape
    lead = xp.shape[:-2]
    hp, wp = xp.shape[-2:]
    oh, ow = hp - kh + 1, wp - kw + 1
    if oh < 1 or ow < 1:
        raise ValueError(f"image {hp}x{wp} smaller than kernel {kh}x{kw}")
    x3 = xp.reshape((-1, hp, wp))
    if xp.device.type == "cuda":
        out = conv2d_kernel(x3, k64)
    elif xp.device.type == "cpu":
        out = conv2d_valid_reference(
            x3, torch.as_tensor(k64, dtype=xp.dtype, device=xp.device))
    else:
        raise ValueError(f"conv2d_valid_fused runs on CUDA or CPU tensors, "
                         f"got {xp.device}")
    return out.reshape(lead + (oh, ow))
