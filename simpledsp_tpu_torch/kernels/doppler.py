"""The radar's Doppler stage in one kernel: window, FFT across the pulses,
power and roll.

:func:`doppler_power_plain` is the plain version: the window on both planes,
the pulses moved to the last axis, the FFT engine (``ops/fft.fft_ri``), the
pulses moved back, the power and the roll by half the pulses, as
``models/radar.range_doppler_map`` has always computed them.
:data:`doppler_power` (``csrc/doppler.cu``) computes the same map on the card
in one pass that reads y where it lies and writes the map once.  It replaces
no TPU kernel: the JAX package's Doppler transform is XLA's dense DFT.

Gate (:func:`doppler_kernel_supported`): a plain ``torch.Tensor`` (not a
subclass such as ``DTensor``), float32, on a CUDA device, with a power-of-two
number of pulses from :data:`MIN_PULSES` to :data:`MAX_PULSES`, the sizes the
kernel's register FFT is built for.  ``range_doppler_map`` runs
:func:`doppler_power_plain` otherwise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from simpledsp_tpu_torch.kernels import _build
from simpledsp_tpu_torch.ops import fft as _fft
from simpledsp_tpu_torch.ops.fft import _cached_table
from simpledsp_tpu_torch.utils import tracing
from simpledsp_tpu_torch.utils.intmath import is_power_of_2

__all__ = ["MIN_PULSES", "MAX_PULSES", "doppler_kernel_supported",
           "doppler_power_plain", "doppler_power"]

MIN_PULSES = 16     # csrc/doppler.cu: its smallest plan, 4 x 4
MAX_PULSES = 512    # and its largest, 32 x 16


def doppler_kernel_supported(yr: torch.Tensor, n_pulses: int) -> bool:
    """Whether :data:`doppler_power` takes a map of ``yr``'s kind with
    ``n_pulses`` pulses."""
    return (type(yr) is torch.Tensor and yr.device.type == "cuda"
            and yr.dtype == torch.float32
            and MIN_PULSES <= n_pulses <= MAX_PULSES
            and is_power_of_2(n_pulses))


def doppler_power_plain(yr: torch.Tensor, yi: torch.Tensor,
                        w: torch.Tensor) -> torch.Tensor:
    """Plain version: y (..., n_pulses, n) as (re, im) planes and the window
    ``w`` (n_pulses, 1) -> the power of the windowed FFT across the pulses,
    bin k at row (k + n_pulses // 2) mod n_pulses."""
    n_pulses = yr.shape[-2]
    # Doppler FFT across the pulse axis: pulses to the last axis and back.
    dr, di = _fft.fft_ri((yr * w).transpose(-1, -2),
                         (yi * w).transpose(-1, -2))
    dr, di = dr.transpose(-1, -2), di.transpose(-1, -2)
    return torch.roll(dr * dr + di * di, n_pulses // 2, -2)


def _twiddles_f64(n_pulses: int) -> Tuple[np.ndarray]:
    """(cos, sin) of -2 pi t / n_pulses, t < n_pulses, as one (2, n_pulses)
    float64 table."""
    ang = (-2.0 * np.pi / n_pulses) * np.arange(n_pulses)
    return (np.stack([np.cos(ang), np.sin(ang)]),)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """``csrc/doppler.cu`` built and loaded, its entry point typed."""
    lib = _build.load_library("sdsp_doppler", ("doppler.cu",))
    fn = lib.sdsp_doppler_power_f32
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_longlong,
                                            ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


class _DopplerKernel:
    """The CUDA Doppler kernel: built from ``csrc/doppler.cu`` at first
    launch; ``launches`` counts its launches."""

    launches = tracing.Launches()

    def __init__(self):
        self.launch_counter = tracing.kernel_counter("doppler")

    def library(self) -> ctypes.CDLL:
        return _library()

    def __call__(self, yr: torch.Tensor, yi: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
        """y (..., n_pulses, n) float32 planes on the card, read where they
        lie (unit stride along n), and the window ``w`` (n_pulses values)
        -> the contiguous power map of :func:`doppler_power_plain`."""
        n_pulses = yr.shape[-2] if yr.dim() >= 2 else 0
        if not (doppler_kernel_supported(yr, n_pulses)
                and doppler_kernel_supported(yi, n_pulses)):
            raise ValueError(
                f"the CUDA Doppler kernel takes float32 torch.Tensors on a "
                f"CUDA device with a power-of-two number of pulses from "
                f"{MIN_PULSES} to {MAX_PULSES}, got {type(yr).__name__} "
                f"{yr.dtype} on {yr.device} with shape {tuple(yr.shape)}")
        if (yi.shape != yr.shape or yi.stride() != yr.stride()
                or yi.device != yr.device):
            raise ValueError("the CUDA Doppler kernel takes two planes of one "
                             "shape and layout on one device")
        n = yr.shape[-1]
        if n > 1 and yr.stride(-1) != 1:
            raise ValueError("the CUDA Doppler kernel takes planes with unit "
                             "stride along range")
        if (w.numel() != n_pulses or w.dtype != torch.float32
                or w.device != yr.device):
            raise ValueError(f"the window must hold {n_pulses} float32 values "
                             f"on {yr.device}")
        out = torch.empty(yr.shape, dtype=torch.float32, device=yr.device)
        if out.numel() == 0:
            return out
        try:
            beams = yr.view(-1, n_pulses, n)
        except RuntimeError as e:
            raise ValueError("the CUDA Doppler kernel takes leading axes that "
                             "merge into one beam axis without a copy") from e
        twiddles, = _cached_table(_twiddles_f64, (n_pulses,), torch.float32,
                                  yr.device)
        window = w.reshape(n_pulses).contiguous()
        stream = torch.cuda.current_stream(yr.device).cuda_stream
        rc = self.library().sdsp_doppler_power_f32(
            yr.data_ptr(), yi.data_ptr(), window.data_ptr(),
            twiddles.data_ptr(), out.data_ptr(), beams.shape[0], n_pulses, n,
            beams.stride(0), beams.stride(1), yr.device.index, stream)
        if rc != 0:
            raise RuntimeError(f"Doppler kernel launch failed: CUDA error {rc}")
        self.launches += 1
        return out


doppler_power = _DopplerKernel()
