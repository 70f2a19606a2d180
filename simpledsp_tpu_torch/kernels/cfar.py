"""Cell-averaging CFAR along the last axis in one kernel.

:func:`cfar_rolled` is the plain version: the sum of 2 train rolled copies
of the map, the scale and the compare, as ``models/radar.cfar_ca`` has
always computed them.  :data:`cfar_kernel` (``csrc/cfar.cu``) gives the same
bits on the card in one pass that reads each row once and writes the
threshold and the mask once.  It replaces no TPU kernel: the JAX package's
CFAR is XLA's shifted adds.

Gate (:func:`cfar_kernel_supported`): a plain ``torch.Tensor`` (not a
subclass such as ``DTensor``), float32, on a CUDA device, with
guard + train at most :data:`MAX_SPAN`, the widest halo the kernel's
shared-memory tile holds.  ``cfar_ca`` runs :func:`cfar_rolled` otherwise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from simpledsp_tpu_torch.kernels import _build
from simpledsp_tpu_torch.utils import tracing

__all__ = ["MAX_SPAN", "cfar_kernel_supported", "cfar_rolled", "cfar_kernel"]

MAX_SPAN = 2048     # csrc/cfar.cu kMaxSpan


def cfar_kernel_supported(x: torch.Tensor, guard: int, train: int) -> bool:
    """Whether :data:`cfar_kernel` takes a CFAR of ``x`` with this window."""
    return (type(x) is torch.Tensor and x.device.type == "cuda"
            and x.dtype == torch.float32 and guard + train <= MAX_SPAN)


def cfar_rolled(x: torch.Tensor, guard: int, train: int,
                alpha: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version, along the last axis: 2 train shifted adds on rolled
    copies (the edges wrap), threshold alpha times their mean, detections
    where the cell exceeds it.  Returns (detections, threshold)."""
    acc = torch.zeros_like(x)
    for k in range(guard + 1, guard + train + 1):
        acc = acc + torch.roll(x, k, -1) + torch.roll(x, -k, -1)
    thresh = alpha * (acc / (2 * train))
    return x > thresh, thresh


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """``csrc/cfar.cu`` built and loaded, its entry point typed."""
    lib = _build.load_library("sdsp_cfar", ("cfar.cu",))
    fn = lib.sdsp_cfar_ca_f32
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 3 + [ctypes.c_double, ctypes.c_int,
                                           ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


class _CfarKernel:
    """The CUDA CA-CFAR kernel: built from ``csrc/cfar.cu`` at first launch;
    ``launches`` counts its launches."""

    launches = tracing.Launches()

    def __init__(self):
        self.launch_counter = tracing.kernel_counter("cfar")

    def library(self) -> ctypes.CDLL:
        return _library()

    def __call__(self, x: torch.Tensor, guard: int, train: int,
                 alpha: float) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (..., n) contiguous float32 on the card -> (detections,
        threshold) of x's shape, :func:`cfar_rolled`'s bits."""
        if not cfar_kernel_supported(x, guard, train):
            raise ValueError(
                f"the CUDA CFAR kernel takes a float32 torch.Tensor on a CUDA "
                f"device and guard + train <= {MAX_SPAN}, got {type(x).__name__} "
                f"{x.dtype} on {x.device}, span {guard + train}")
        if not x.is_contiguous():
            raise ValueError("the CUDA CFAR kernel takes a contiguous map")
        n = x.shape[-1] if x.dim() else 0
        if guard < 0 or train < 1 or n < 2 * (guard + train) + 1:
            raise ValueError(f"a CFAR window of guard {guard}, train {train} "
                             f"does not fit {n} cells")
        thresh = torch.empty_like(x)
        det = torch.empty(x.shape, dtype=torch.bool, device=x.device)
        rows = x.numel() // n
        if rows == 0:
            return det, thresh
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = self.library().sdsp_cfar_ca_f32(
            x.data_ptr(), thresh.data_ptr(), det.data_ptr(), rows, n, guard,
            train, alpha, x.device.index, stream)
        if rc != 0:
            raise RuntimeError(f"CFAR kernel launch failed: CUDA error {rc}")
        self.launches += 1
        return det, thresh


cfar_kernel = _CfarKernel()
