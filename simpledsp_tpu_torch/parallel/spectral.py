"""Sequence-parallel STFT over a device mesh.

Port of ``simpledsp_tpu/parallel/spectral.py``.  The STFT's frame f covers
samples [f hop, f hop + nfft): with time sharded over the ``sp`` axis,
every shard owns the frames STARTING in its span and needs ``nfft - hop``
look-ahead samples from its right neighbour, the halo pattern of
``parallel/fir.py`` in the opposite direction (one ring shift).  The local
compute is the serial :func:`simpledsp_tpu_torch.ops.spectral.spectrogram_ri`
(on a CUDA mesh at nfft > 2048, the frames FFT kernel).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from simpledsp_tpu_torch.parallel import mesh as _mesh
from simpledsp_tpu_torch.parallel.mesh import (ROWS, SEQ_AXIS, SHARDED,
                                               SHARDED_FRAMES)

__all__ = ["ShardedSTFT"]


class ShardedSTFT(nn.Module):
    """STFT sharded (channels over dp) x (time/frames over sp).

    Same contract as :func:`~simpledsp_tpu_torch.ops.spectral.stft_ri` (no
    boundary padding): x (C, T) -> RI planes (C, nframes, nfft//2 + 1)
    with ``nframes = (T - nfft)//hop + 1``, each a ``DTensor`` with the
    frame axis over ``sp``.  Requires ``hop | nfft`` and local shards of at
    least ``nfft - hop`` samples.
    """

    def __init__(self, mesh: DeviceMesh, nfft: int = 1024,
                 hop: Optional[int] = None, window: str = "hann",
                 onesided: bool = True, dtype=torch.float32):
        super().__init__()
        self.nfft = int(nfft)
        self.hop = int(hop or nfft // 2)
        if self.nfft % self.hop:
            raise ValueError(
                f"ShardedSTFT needs hop | nfft, got {self.hop}/{self.nfft}")
        self.window = window
        self.onesided = onesided
        self.mesh = mesh
        self.group = mesh.get_group(SEQ_AXIS)
        self.n_seq = mesh[SEQ_AXIS].size()
        self.dtype = dtype

    @property
    def halo(self) -> int:
        return self.nfft - self.hop

    def _local(self, xl: torch.Tensor):
        from simpledsp_tpu_torch.ops.spectral import spectrogram_ri
        halo = self.halo
        # Right-neighbour look-ahead: shard i receives shard i+1's HEAD; the
        # last shard pads zeros, its trailing frames the global tail frames
        # that the unpadded form drops.
        recv = (_mesh.ring_shift(xl[..., :halo].contiguous(), -1, self.group)
                if halo else xl[..., :0])
        xe = torch.cat([xl, recv], dim=-1)
        return spectrogram_ri(xe, self.nfft, hop=self.hop,
                              window=self.window, onesided=self.onesided)

    def forward(self, x, *, padded: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``padded=False`` (default) returns exactly stft_ri's
        ``(T - nfft)//hop + 1`` frames: each rank keeps its frames of
        them, the last rank fewer, and the ``DTensor`` s carry the global
        shape.  ``padded=True`` keeps ``T//hop`` frames, evenly sharded, of
        which the last ``nfft//hop - 1`` are zero-lookahead tail frames to
        drop (or ignore)."""
        if x.ndim != 2:
            raise ValueError("ShardedSTFT expects x of shape (C, T)")
        c, t = x.shape
        t_local = t // self.n_seq
        if t_local * self.n_seq != t or t_local % self.hop:
            raise ValueError(
                f"T={t} must split into sp={self.n_seq} shards with local "
                f"length a multiple of hop={self.hop}")
        if t_local < self.halo:
            raise ValueError(
                f"local shard of {t_local} samples is shorter than the "
                f"{self.halo}-sample look-ahead; use fewer sequence shards")
        xl = _mesh.local_part(self.mesh, x, SHARDED, self.dtype)
        sr, si = self._local(xl)
        if padded:
            return (_mesh.from_local(self.mesh, sr, SHARDED_FRAMES),
                    _mesh.from_local(self.mesh, si, SHARDED_FRAMES))
        return self._trimmed(sr, c, t), self._trimmed(si, c, t)

    def _trimmed(self, plane: torch.Tensor, c: int, t: int) -> torch.Tensor:
        """The first (T - nfft)//hop + 1 frames of a padded plane as a
        ``DTensor``.  Where the rank-order split of those frames is the
        even-chunk layout a ``DTensor`` shard has (the last rank holding
        fewer), each rank keeps its own; otherwise the frames are gathered
        over sp and kept whole on every rank of it."""
        nframes = (t - self.nfft) // self.hop + 1
        per, n = plane.shape[1], self.n_seq
        i = _mesh.axis_index(self.group)
        shape = (c, nframes, plane.shape[-1])
        if n == 1 or -(-nframes // n) == per:
            keep = min(per, max(0, nframes - i * per))
            return _mesh.from_local(self.mesh, plane[:, :keep],
                                    SHARDED_FRAMES, shape=shape)
        whole = _mesh.all_gather(plane, self.group).permute(1, 0, 2, 3)
        whole = whole.reshape(plane.shape[0], -1, plane.shape[-1])
        return _mesh.from_local(self.mesh, whole[:, :nframes], ROWS)
