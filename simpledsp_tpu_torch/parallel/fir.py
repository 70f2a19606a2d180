"""Halo-exchange FIR / polyphase / channelizer over a device mesh.

Port of ``simpledsp_tpu/parallel/fir.py``.  FIR-family ops need the
previous ``hist`` input samples at every shard boundary (overlap-save).
With time sharded over the ``sp`` axis, the halo is ONE ring shift of each
shard's tail to its right neighbour (:func:`halo_exchange`); the first rank
takes the carried streaming state instead, so blockwise-across-calls ==
whole-signal still holds at shard granularity.

The local compute is the serial op's own (``PolyphaseResampler._run``,
``PFBChannelizer._run``, ``OverlapSaveFIR._run``, ``ops.conv.convolve``):
the parallel layer only supplies the halo, so on a CUDA mesh each shard
runs the serial op's kernels (the overlap-save convolution kernel, the
frames FFT kernel under the overlap-save filter's transforms).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from simpledsp_tpu_torch.ops.channelizer import PFBChannelizer
from simpledsp_tpu_torch.ops.fir import (FIRState, OverlapSaveFIR,
                                         PolyphaseResampler)
from simpledsp_tpu_torch.parallel import mesh as _mesh
from simpledsp_tpu_torch.parallel.mesh import (DATA_AXIS, ROWS, SEQ_AXIS,
                                               SHARDED, SHARDED_FRAMES)

__all__ = ["halo_exchange", "ShardedFIR", "ShardedChannelizer",
           "ShardedOverlapSaveFIR", "ShardedConvolve"]


def halo_exchange(xl: torch.Tensor, hist: int, carried: torch.Tensor,
                  group) -> torch.Tensor:
    """Prefix each time shard with its left neighbour's last ``hist``
    samples.

    xl: (..., T_local) local shard.  carried: (..., hist) streaming history
    for the global stream start (the first rank's prefix).  group: the
    process group of the ``sp`` axis (``mesh.get_group("sp")``; JAX names
    the axis).  Returns (..., hist + T_local).  One ring shift; the first
    rank, which has no left neighbour, takes the carried state.
    """
    if hist == 0:
        return xl
    if xl.shape[-1] < hist:
        raise ValueError(
            f"time shard of {xl.shape[-1]} samples is shorter than the "
            f"required halo of {hist}; use longer shards (T_local >= "
            f"filter history) or fewer sequence shards")
    recv = _mesh.ring_shift(xl[..., -hist:], +1, group)
    prefix = carried.to(xl.dtype) if _mesh.axis_index(group) == 0 else recv
    return torch.cat([prefix, xl], dim=-1)


def _replicated_tail(xp_l: torch.Tensor, hist: int, group) -> torch.Tensor:
    """Last ``hist`` samples of the *global* stream on every rank of the
    sequence axis (the next call's carried state): the last rank's tail,
    broadcast."""
    return _mesh.broadcast_from_last(xp_l[..., -hist:], group)


class _Sharded(nn.Module):
    """What the sharded FIR-family modules share: the mesh, its ``sp``
    group and sizes."""

    def __init__(self, mesh: DeviceMesh, dtype):
        super().__init__()
        self.mesh = mesh
        self.group = mesh.get_group(SEQ_AXIS)
        self.n_seq = mesh[SEQ_AXIS].size()
        self.n_data = mesh[DATA_AXIS].size()
        self.dtype = dtype

    @property
    def device(self) -> torch.device:
        return _mesh.mesh_device(self.mesh)

    def _streamed(self, op, x, state, dtype):
        """The halo-prefixed serial ``op._run`` on this rank's shard from
        the carried history: (y DTensor (dp, sp), FIRState DTensor on dp)."""
        hist = op.hist_len
        xl = _mesh.local_part(self.mesh, x, SHARDED, dtype)
        if state is None:
            carried = torch.zeros(xl.shape[:-1] + (hist,), dtype=dtype,
                                  device=xl.device)
        else:
            carried = _mesh.local_part(self.mesh, state.hist, ROWS, dtype)
        xp = halo_exchange(xl, hist, carried, self.group)
        y = op._run(xp)
        new_hist = _replicated_tail(xp, hist, self.group) if hist else carried
        return y, FIRState(_mesh.from_local(self.mesh, new_hist, ROWS))


class ShardedFIR(_Sharded):
    """Polyphase FIR / resampler sharded (channels over dp) x (time over
    sp).

    Wraps a :class:`~simpledsp_tpu_torch.ops.fir.PolyphaseResampler`: the
    serial op's semantics (scipy.upfirdn), with the shard halo supplied by
    :func:`halo_exchange`.  Each local shard length must be a multiple of
    ``down`` so every shard starts at output phase 0.
    """

    def __init__(self, taps: np.ndarray, mesh: DeviceMesh, up: int = 1,
                 down: int = 1, dtype=torch.float32):
        super().__init__(mesh, dtype)
        self.rs = PolyphaseResampler(taps, up=up, down=down, dtype=dtype,
                                     device=self.device)

    @property
    def hist_len(self) -> int:
        return self.rs.hist_len

    def forward(self, x, state: Optional[FIRState] = None
                ) -> Tuple[torch.Tensor, FIRState]:
        if x.ndim != 2:
            raise ValueError("ShardedFIR expects x of shape (C, T)")
        c, t = x.shape
        t_local = t // self.n_seq
        if t_local * self.n_seq != t or t_local % self.rs.down != 0:
            raise ValueError(
                f"T={t} must split into sp={self.n_seq} shards with local "
                f"length a multiple of down={self.rs.down}")
        y, state = self._streamed(self.rs, x, state, self.dtype)
        return _mesh.from_local(self.mesh, y, SHARDED), state


class ShardedChannelizer(_Sharded):
    """PFB channelizer sharded (channels over dp) x (time over sp).

    Local shards run the serial polyphase-branch + FFT
    (``PFBChannelizer._run``); the halo supplies the L-1 cross-shard
    history.  Output: (C, T // M, M) complex with the frame axis over sp,
    each rank holding the spectra of its own time span; with
    ``gather_output`` the frames are gathered over sp (one all_gather), so
    every rank holds the full (T // M, M) output of its channels.
    """

    def __init__(self, num_channels: int, mesh: DeviceMesh,
                 taps: Optional[np.ndarray] = None,
                 taps_per_channel: int = 16, dtype=torch.float32,
                 gather_output: bool = False):
        super().__init__(mesh, dtype)
        self.pfb = PFBChannelizer(num_channels, taps=taps,
                                  taps_per_channel=taps_per_channel,
                                  dtype=dtype, device=self.device)
        self.gather_output = gather_output

    def forward(self, x, state: Optional[FIRState] = None
                ) -> Tuple[torch.Tensor, FIRState]:
        if x.ndim != 2:
            raise ValueError("ShardedChannelizer expects x of shape (C, T)")
        c, t = x.shape
        m = self.pfb.m
        t_local = t // self.n_seq
        if t_local * self.n_seq != t or t_local % m != 0:
            raise ValueError(
                f"T={t} must split into sp={self.n_seq} shards with local "
                f"length a multiple of M={m}")
        x = x if torch.is_tensor(x) else torch.as_tensor(x)
        dtype = x.dtype if x.is_complex() else self.dtype
        y, state = self._streamed(self.pfb, x, state, dtype)
        if not self.gather_output:
            return _mesh.from_local(self.mesh, y, SHARDED_FRAMES), state
        # (P, C_l, G_l, M) -> (C_l, P G_l, M): the frames in global order.
        g = _mesh.all_gather(y, self.group).permute(1, 0, 2, 3)
        g = g.reshape(y.shape[0], -1, y.shape[-1])
        return _mesh.from_local(self.mesh, g, ROWS), state


class ShardedConvolve(_Sharded):
    """Centred ("same") convolution sharded (channels dp) x (time sp).

    ``ops.conv.convolve(x, h, mode="same")`` on the mesh: each shard runs
    the serial convolve (the same route choice: the overlap-save kernel
    for long taps on a CUDA mesh) on its halo-prefixed span, then ONE more
    ring shift moves shard outputs left by (m-1)//2 samples for the
    centred alignment: the left halo supplies trailing context, the right
    neighbour's head the centred look-ahead.  With one shard there is no
    halo, and the shard's output is the serial call's.
    """

    def __init__(self, taps: np.ndarray, mesh: DeviceMesh,
                 dtype=torch.float32, method: str = "auto"):
        super().__init__(mesh, dtype)
        self.h = np.asarray(taps, dtype=np.float64)
        if self.h.ndim != 1 or self.h.size == 0:
            raise ValueError("taps must be a non-empty 1-D array")
        self.m = self.h.size
        self.shift = (self.m - 1) // 2   # "same" centre offset
        self.method = method

    def _local(self, xl: torch.Tensor) -> torch.Tensor:
        from simpledsp_tpu_torch.ops.conv import convolve
        h = self.h
        if self.n_seq == 1:
            # One shard: the whole signal, the serial call.
            return convolve(xl, h, mode="same", method=self.method)
        t_local = xl.shape[-1]
        m, s = self.m, self.shift
        zeros_h = torch.zeros(xl.shape[:-1] + (m - 1,), dtype=xl.dtype,
                              device=xl.device)
        xp = halo_exchange(xl, m - 1, zeros_h, self.group)
        if s:
            xp = torch.cat([xp, torch.zeros(xl.shape[:-1] + (s,),
                                            dtype=xl.dtype,
                                            device=xl.device)], dim=-1)
        # Causal outputs y_full[t0 .. t0+T_local+s): the m-1 halo supplies
        # the left context, the s zeros stand in for the right neighbour.
        ye = convolve(xp, h, mode="full",
                      method=self.method)[..., m - 1: m - 1 + t_local + s]
        if s == 0:
            return ye
        # The right neighbour's first s causal outputs are this shard's
        # centred tail; the LAST shard's zero-padded tail is already right
        # (the convolution tail past the signal end).
        recv = _mesh.ring_shift(ye[..., :s], -1, self.group)
        last = _mesh.axis_index(self.group) == self.n_seq - 1
        tail = ye[..., t_local:] if last else recv
        return torch.cat([ye[..., s: t_local], tail], dim=-1)

    def forward(self, x) -> torch.Tensor:
        if x.ndim != 2:
            raise ValueError("ShardedConvolve expects x of shape (C, T)")
        c, t = x.shape
        t_local = t // self.n_seq
        if t_local * self.n_seq != t:
            raise ValueError(f"T={t} not divisible by sp={self.n_seq}")
        if t_local < self.m - 1 or t_local < self.shift:
            raise ValueError(
                f"local shard of {t_local} samples is shorter than the "
                f"{self.m - 1}-sample halo; use fewer sequence shards")
        xl = _mesh.local_part(self.mesh, x, SHARDED, self.dtype)
        return _mesh.from_local(self.mesh, self._local(xl), SHARDED)


class ShardedOverlapSaveFIR(_Sharded):
    """FFT-domain overlap-save convolution sharded (channels dp) x (time
    sp).

    Long-tap FIR whose per-shard compute is the serial
    :class:`~simpledsp_tpu_torch.ops.fir.OverlapSaveFIR` (its transforms on
    the frames FFT kernel on a CUDA mesh); the cross-shard overlap is the
    same single ring-shift halo as the direct form.
    """

    def __init__(self, taps: np.ndarray, mesh: DeviceMesh,
                 block_size: int = 1024, dtype=torch.float32):
        super().__init__(mesh, dtype)
        self.os = OverlapSaveFIR(taps, block_size=block_size, dtype=dtype,
                                 device=self.device)

    def forward(self, x, state: Optional[FIRState] = None
                ) -> Tuple[torch.Tensor, FIRState]:
        if x.ndim != 2:
            raise ValueError("ShardedOverlapSaveFIR expects x of shape (C, T)")
        c, t = x.shape
        t_local = t // self.n_seq
        if t_local * self.n_seq != t or t_local % self.os.block_size != 0:
            raise ValueError(
                f"T={t} must split into sp={self.n_seq} shards with local "
                f"length a multiple of block={self.os.block_size}")
        y, state = self._streamed(self.os, x, state, self.dtype)
        return _mesh.from_local(self.mesh, y, SHARDED), state
