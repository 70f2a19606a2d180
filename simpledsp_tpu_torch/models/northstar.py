"""The north-star signal chain: 8th-order Butterworth IIR -> framed FFT.

Port of ``simpledsp_tpu/models/northstar.py`` (the serial
:class:`NorthStarChain`).  Input is (C, T) real samples with the IIR state
carried from call to call; output is the packed one-sided spectrum of each
fft_size frame as (re, im) planes.

Two paths compute the same function:

- the fused path (``use_kernel=True``, the default on a CUDA device): the
  prepass matmuls, then one kernel per frame (``kernels/chain.py``, built
  from ``csrc/chain.cu``);
- the composable path (``use_kernel=False``): :class:`BlockIIR` over
  ``block_size`` blocks, then :func:`rfft_ri` and :func:`pack_rfft_ri`.

``use_pallas``, the JAX package's name for the switch, is an alias of
``use_kernel``.  The JAX ``precision`` argument is not taken: the port runs
IEEE float32 only.

There is no silent fallback: a CUDA chain that cannot run the kernel raises
at construction, and a chain asked for CUDA where there is none raises.
``device=None`` means CUDA (:func:`simpledsp_tpu_torch.device.resolve_device`);
a CPU caller passes ``device="cpu"``.  The input is moved to the chain's
device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from simpledsp_tpu_torch.design.biquad import BiquadCascadeDesign, design_lowpass
from simpledsp_tpu_torch.device import resolve_device, resolve_use_kernel
from simpledsp_tpu_torch.kernels import chain as _kchain
from simpledsp_tpu_torch.ops.fft import pack_rfft_ri, rfft_ri
from simpledsp_tpu_torch.ops.iir import BlockIIR, IIRState, iir_init

__all__ = ["default_design", "NorthStarChain"]


def default_design(fs: float = 39000.0) -> BiquadCascadeDesign:
    """The benchmark configuration: 8th-order (4-section) low-pass at
    2 kHz, fs = 39 kHz."""
    return design_lowpass(4, 2000.0, fs)


class NorthStarChain(nn.Module):
    """Streaming IIR -> framed FFT on one device.

    Call with x: (C, T), T a multiple of fft_size and block_size, or
    pre-framed (C, F, n1, n2) on the fused path; returns
    (((spec_re, spec_im) each (C, T // fft_size, fft_size // 2)), state).
    Bin k of the planes is X[k] for k < N/2; the real Nyquist bin X[N/2]
    sits in ``spec_im[..., 0]`` (the Im X[0] == 0 slot).
    ``ops.fft.unpack_rfft_ri`` recovers the N/2+1 form.
    """

    def __init__(self, design: Optional[BiquadCascadeDesign] = None,
                 fft_size: int = 4096, block_size: int = 256,
                 dtype=torch.float32, device=None,
                 use_kernel: Optional[bool] = None,
                 projection: Optional[str] = None,
                 use_pallas: Optional[bool] = None):
        super().__init__()
        device = resolve_device(device)
        self.design = design or default_design()
        self.fft_size = int(fft_size)
        if self.fft_size % 2:
            raise ValueError("fft_size must be even (one-sided output)")
        self.projection = projection
        self.iir = BlockIIR(self.design, block_size=block_size, dtype=dtype,
                            device=device)
        self.ops = None
        if resolve_use_kernel(use_kernel, use_pallas, device):
            # Raises ValueError for an fft_size with no n1 x n2 split.
            self.ops = _kchain.FusedNorthStarOperators(
                self.design, self.fft_size, dtype=dtype, device=device)
            if device.type == "cuda" and (
                    not _kchain.kernel_supports(self.ops.n1, self.ops.n2)
                    or dtype != torch.float32):
                raise ValueError(
                    f"the CUDA chain kernel needs float32 and fft_size = "
                    f"n1 * n2 with n2 even (the one-sided packing); got "
                    f"{dtype}, fft_size={self.fft_size} = {self.ops.n1} * "
                    f"{self.ops.n2}")

    @property
    def use_kernel(self) -> bool:
        return self.ops is not None

    @property
    def device(self) -> torch.device:
        return self.iir.H.device

    @property
    def dtype(self) -> torch.dtype:
        return self.iir.H.dtype

    def forward(self, x: torch.Tensor, state: Optional[IIRState] = None
                ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], IIRState]:
        if x.ndim == 4:
            if self.ops is None:
                raise ValueError(
                    "pre-framed (C, F, n1, n2) input requires the fused "
                    "kernel path (use_kernel=True); pass flat (C, T) input")
            c = x.shape[0]
            t = x.shape[1] * self.fft_size
        else:
            c, t = x.shape
        if t % self.fft_size or t % self.iir.block_size:
            raise ValueError(
                f"T={t} must be a multiple of fft_size={self.fft_size} "
                f"and block_size={self.iir.block_size}")
        m = self.design.nsections
        x = torch.as_tensor(x, dtype=self.dtype, device=self.device)
        if state is None:
            state = iir_init(m, (c,), dtype=self.dtype, device=self.device)
        s0 = state.y_hist.to(dtype=self.dtype, device=self.device).reshape(c, -1)
        if self.ops is not None:
            (sr, si), s_fin = _kchain.fused_chain_frames(
                self.ops, x, s0, half_spectrum=True, projection=self.projection)
            # (C, F, N/2 / n1, n1) planes flatten to natural bin order.
            sr = sr.reshape(c, -1, self.fft_size // 2)
            si = si.reshape(c, -1, self.fft_size // 2)
        else:
            y, s_fin = self.iir.run_blocks(
                x.reshape(c, -1, self.iir.block_size), s0)
            sr, si = pack_rfft_ri(*rfft_ri(y.reshape(c, -1, self.fft_size)))
        return (sr, si), IIRState(s_fin.reshape(c, m + 1, 2))

    def frame_input(self, x_host: np.ndarray) -> torch.Tensor:
        """Upload a host (C, T) sample block to the chain's device, in the
        fused kernel's framed view (C, F, n1, n2) when the chain runs it."""
        x = torch.as_tensor(np.asarray(x_host), dtype=self.dtype,
                            device=self.device)
        if self.ops is None:
            return x
        c, t = x.shape
        return x.reshape(c, t // self.fft_size, self.ops.n1, self.ops.n2)
