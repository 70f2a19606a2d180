"""The north-star signal chain: 8th-order Butterworth IIR -> framed FFT.

Port of ``simpledsp_tpu/models/northstar.py``: the serial
:class:`NorthStarChain` and the sharded :class:`ShardedNorthStarChain`.
Input is (C, T) real samples with the IIR state carried from call to call;
output is the packed one-sided spectrum of each fft_size frame as (re, im)
planes.

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
device.  The sharded chain runs on its mesh's device (``parallel/mesh.py``).
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

__all__ = ["default_design", "NorthStarChain", "ShardedNorthStarChain"]


def default_design(fs: float = 39000.0) -> BiquadCascadeDesign:
    """The benchmark configuration: 8th-order (4-section) low-pass at
    2 kHz, fs = 39 kHz."""
    return design_lowpass(4, 2000.0, fs)


def _fused_operators(design, fft_size, dtype, device, use_kernel,
                     use_pallas):
    """The fused path's tables, or None for the composable path.  Raises
    ValueError for an fft_size with no n1 x n2 split, and on CUDA for one
    the kernel does not take."""
    if not resolve_use_kernel(use_kernel, use_pallas, device):
        return None
    ops = _kchain.FusedNorthStarOperators(design, fft_size, dtype=dtype,
                                          device=device)
    if device.type == "cuda" and (
            not _kchain.kernel_supports(ops.n1, ops.n2)
            or dtype != torch.float32):
        raise ValueError(
            f"the CUDA chain kernel needs float32 and fft_size = n1 * n2 "
            f"with n2 even (the one-sided packing); got {dtype}, "
            f"fft_size={fft_size} = {ops.n1} * {ops.n2}")
    return ops


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
        self.ops = _fused_operators(self.design, self.fft_size, dtype,
                                    device, use_kernel, use_pallas)

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


class ShardedNorthStarChain(nn.Module):
    """North-star chain over a (dp, sp) mesh, one process a device.

    Channels shard over ``dp``; time shards over ``sp``.  The IIR runs
    sequence-parallel (one all_gather and one all_reduce of D-dim state
    vectors over ``sp``, ``parallel/iir.py``); each shard then frames its
    own output and transforms it locally, with no traffic in the FFT.

    Two paths, as :class:`NorthStarChain`: the fused path (``use_kernel``,
    the default on a CUDA mesh) runs :func:`kernels.chain.fused_chain_frames`
    on each shard with the ``sp`` group and the shard powers, one chain
    kernel launch a call a rank; the composable path
    (``use_kernel=False``) runs :meth:`ShardedBlockIIR._local`, then
    :func:`rfft_ri` and :func:`pack_rfft_ri`.  ``use_pallas`` is an alias
    of ``use_kernel``.  A CUDA mesh with an fft_size the kernel lacks
    raises at construction.

    Call with x (C, T), the global signal (the same on every rank) or a
    ``DTensor``, each rank's time shard a multiple of fft_size and
    block_size; returns (((spec_re, spec_im) each (C, T // fft_size,
    fft_size // 2)), state) with the planes ``DTensor`` s placed (dp, sp)
    in :class:`NorthStarChain`'s packed bin order, and the state's history
    placed on dp, replicated over sp.
    """

    def __init__(self, mesh, design: Optional[BiquadCascadeDesign] = None,
                 fft_size: int = 4096, block_size: int = 256,
                 dtype=torch.float32, use_kernel: Optional[bool] = None,
                 use_pallas: Optional[bool] = None):
        super().__init__()
        # torch.distributed.tensor takes a second or more to import: the
        # serial chain does not pay for it.
        from simpledsp_tpu_torch.parallel.iir import ShardedBlockIIR
        from simpledsp_tpu_torch.parallel.mesh import mesh_device
        self.mesh = mesh
        self.design = design or default_design()
        self.fft_size = int(fft_size)
        if self.fft_size % 2:
            raise ValueError("fft_size must be even (one-sided output)")
        self.dtype = dtype
        self.iir = ShardedBlockIIR(self.design, mesh, block_size=block_size,
                                   dtype=dtype)
        self.ops = _fused_operators(self.design, self.fft_size, dtype,
                                    mesh_device(mesh), use_kernel, use_pallas)
        self._powers = {}

    @property
    def use_kernel(self) -> bool:
        return self.ops is not None

    def _shard_powers(self, nf_local: int) -> torch.Tensor:
        """The fused path's shard powers for nf_local frames a shard, on
        the mesh's device in the compute dtype, built once."""
        if nf_local not in self._powers:
            self._powers[nf_local] = torch.as_tensor(
                self.ops.shard_powers(nf_local, self.iir.n_seq),
                dtype=self.dtype, device=self.iir.iir.H.device)
        return self._powers[nf_local]

    def forward(self, x, state: Optional[IIRState] = None
                ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], IIRState]:
        from simpledsp_tpu_torch.parallel import mesh as _mesh
        from simpledsp_tpu_torch.parallel.mesh import (ROWS, SEQ_AXIS,
                                                       SHARDED, SHARDED_FRAMES)
        c, t = x.shape
        t_local = t // self.iir.n_seq
        if (t_local * self.iir.n_seq != t or t_local % self.fft_size
                or t_local % self.iir.block_size):
            raise ValueError(
                f"local shard length must be a multiple of fft_size="
                f"{self.fft_size} and block_size={self.iir.block_size}")
        m = self.design.nsections
        if state is None:
            state = iir_init(m, (c,), dtype=self.dtype)
        xl = _mesh.local_part(self.mesh, x, SHARDED, self.dtype)
        cl = xl.shape[0]
        s0 = _mesh.local_part(self.mesh, state.y_hist, ROWS,
                              self.dtype).reshape(cl, -1)
        half = self.fft_size // 2
        if self.ops is not None:
            nf_local = t_local // self.fft_size
            (sr, si), s_fin = _kchain.fused_chain_frames(
                self.ops, xl, s0, half_spectrum=True,
                group=self.mesh.get_group(SEQ_AXIS),
                shard_powers=self._shard_powers(nf_local))
            sr, si = sr.reshape(cl, -1, half), si.reshape(cl, -1, half)
        else:
            apow = self.iir._apow(t_local // self.iir.block_size)
            y, s_fin = self.iir._local(apow, xl, s0)
            sr, si = pack_rfft_ri(*rfft_ri(y.reshape(cl, -1, self.fft_size)))
        return ((_mesh.from_local(self.mesh, sr, SHARDED_FRAMES),
                 _mesh.from_local(self.mesh, si, SHARDED_FRAMES)),
                IIRState(_mesh.from_local(
                    self.mesh, s_fin.reshape(cl, m + 1, 2), ROWS)))
