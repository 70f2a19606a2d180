"""Sequence-parallel cascaded-biquad IIR over a device mesh.

Port of ``simpledsp_tpu/parallel/iir.py``: the streaming contract,
"processing in blocks is exactly processing the whole signal", promoted
from blocks in time to blocks across ranks.

Math
----
The cascade is LTI with one-step form s' = A s + p x.  Condensing a
B-sample block gives (``ops/iir.py``)

    y_blk  = H x_blk + Phi s_in
    s_out  = F s_blk_in + K x_blk ,   F = A^B

and a whole time shard of nb blocks has

    s_shard_out = Fs s_shard_in + k_shard,    Fs = F^nb,

with k_shard the input-driven final state of a zero-init local scan.  Fs is
the same matrix on every rank (equal shard lengths), so the state entering
shard i has the closed form

    s_in(i) = Fs^i s0 + sum_{j<i} Fs^{i-1-j} k_j

and the cross-rank dependency is ONE all_gather of the small (channels, D)
vectors k_j over the ``sp`` axis and a local weighted sum with host-built Fs
powers.  The global final state is the matching sum over ranks (one
all_reduce), so streaming across sharded calls works.

The operators are float64 on the host, cast once to the compute dtype; every
product runs in IEEE float32 (:func:`precision.ieee_fp32`).  JAX's
``precision`` argument is not taken.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from simpledsp_tpu_torch.design.biquad import BiquadCascadeDesign
from simpledsp_tpu_torch.ops.iir import (BlockIIR, IIRState,
                                         block_operators_f64, iir_init,
                                         state_scan)
from simpledsp_tpu_torch.parallel import mesh as _mesh
from simpledsp_tpu_torch.parallel.mesh import (DATA_AXIS, ROWS, SEQ_AXIS,
                                               SHARDED)
from simpledsp_tpu_torch.precision import ieee_fp32

__all__ = ["ShardedBlockIIR", "transition_powers", "shard_states"]


def transition_powers(F64: np.ndarray, steps: int, n_shards: int
                      ) -> np.ndarray:
    """(n_shards + 1, D, D) stack of Fs^p, Fs = F64^steps, in float64: the
    cross-shard transition powers of a shard of ``steps`` transitions."""
    Fs = np.linalg.matrix_power(F64, steps)
    D = Fs.shape[0]
    out = np.empty((n_shards + 1, D, D))
    out[0] = np.eye(D)
    for i in range(1, n_shards + 1):
        out[i] = Fs @ out[i - 1]
    return out


def shard_states(group, apow: torch.Tensor, s0: torch.Tensor,
                 k_shard: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The closed form over the ranks of ``group`` (the ``sp`` axis): (the
    state entering this rank's shard, the global final state), both
    (C_l, D), from the global incoming state s0, this shard's input-driven
    final state k_shard and ``apow`` (P + 1, D, D) = Fs^p.  One all_gather
    of k_shard and one all_reduce; every product in IEEE float32."""
    n, i = _mesh.axis_size(group), _mesh.axis_index(group)
    kall = _mesh.all_gather(k_shard, group)                  # (P, C_l, D)
    # w[j] = Fs^{i-1-j} for j < i, else 0: views of apow and a zero block,
    # with no host-to-device copy (which would wait for the card).
    zero = torch.zeros_like(apow[0])
    w = torch.stack([apow[i - 1 - j] if j < i else zero for j in range(n)])
    with ieee_fp32():
        s_in = (torch.einsum("de,ce->cd", apow[i], s0)
                + torch.einsum("jde,jce->cd", w, kall))
        own = torch.einsum("de,ce->cd", apow[n - 1 - i], k_shard)
        s_fin = (torch.einsum("de,ce->cd", apow[n], s0)
                 + _mesh.psum(own, group))
    return s_in, s_fin


class ShardedBlockIIR(nn.Module):
    """Block-state-space IIR sharded (channels over dp) x (time over sp).

    Usage::

        f = ShardedBlockIIR(design, mesh, block_size=256)
        y, state = f(x, state)     # x: (C, T) with T % (sp * block_size) == 0

    ``x`` is the global signal (the same on every rank) or a ``DTensor``;
    ``y`` is a ``DTensor`` placed (dp, sp) and the state's history one
    placed on dp, replicated over sp.  Splitting a stream at multiples of
    ``sp * block_size`` across successive calls is exact.
    """

    def __init__(self, design: BiquadCascadeDesign, mesh: DeviceMesh,
                 block_size: int = 256, dtype=torch.float32):
        super().__init__()
        self.design = design
        self.mesh = mesh
        self.block_size = int(block_size)
        self.dtype = dtype
        self.group = mesh.get_group(SEQ_AXIS)
        self.n_seq = mesh[SEQ_AXIS].size()
        self.n_data = mesh[DATA_AXIS].size()
        self.iir = BlockIIR(design, block_size=self.block_size, dtype=dtype,
                            device=_mesh.mesh_device(mesh))
        self._F64 = block_operators_f64(design, self.block_size)[3]
        self.state_dim = self._F64.shape[0]
        self._apow_cache = {}

    def _apow(self, nb_local: int) -> torch.Tensor:
        """(P+1, D, D) stack of Fs^p, Fs = F^nb_local, built in float64 on
        the host and cast once to the compute dtype on the mesh's device."""
        if nb_local not in self._apow_cache:
            self._apow_cache[nb_local] = torch.as_tensor(
                transition_powers(self._F64, nb_local, self.n_seq),
                dtype=self.dtype, device=self.iir.H.device)
        return self._apow_cache[nb_local]

    def _local(self, apow: torch.Tensor, xl: torch.Tensor, s0: torch.Tensor):
        """This rank's work: xl (C_l, T_l) its time shard, s0 (C_l, D) the
        global incoming state.  Returns (y (C_l, T_l), the global final
        state (C_l, D))."""
        H, Phi, K, F = self.iir.operators
        B = self.block_size
        xb = xl.reshape(xl.shape[0], -1, B)
        with ieee_fp32():
            conv = torch.matmul(xb, H.T)                     # (C_l, nb, B)
            kx = torch.matmul(xb, K.T)                       # (C_l, nb, D)
        # Zero-init local scan: the shard's input-driven final state.
        _, k_shard = state_scan(kx, torch.zeros_like(s0), F)
        s_in, s_fin = shard_states(self.group, apow, s0, k_shard)
        # Correct-init local scan for the blocks' starts, then the outputs.
        s_starts, _ = state_scan(kx, s_in, F)
        with ieee_fp32():
            y = conv + torch.matmul(s_starts, Phi.T)
        return y.reshape(xl.shape), s_fin

    def forward(self, x, state: Optional[IIRState] = None
                ) -> Tuple[torch.Tensor, IIRState]:
        if x.ndim != 2:
            raise ValueError("ShardedBlockIIR expects x of shape (C, T)")
        c, t = x.shape
        stride = self.n_seq * self.block_size
        if t % stride != 0:
            raise ValueError(
                f"T={t} must be a multiple of sp*block = {stride}")
        if c % self.n_data != 0:
            raise ValueError(f"C={c} must be a multiple of dp={self.n_data}")
        m = self.design.nsections
        if state is None:
            state = iir_init(m, (c,), dtype=self.dtype)
        xl = _mesh.local_part(self.mesh, x, SHARDED, self.dtype)
        s0 = _mesh.local_part(self.mesh, state.y_hist, ROWS,
                              self.dtype).reshape(xl.shape[0], -1)
        apow = self._apow(xl.shape[-1] // self.block_size)
        y, s_fin = self._local(apow, xl, s0)
        return (_mesh.from_local(self.mesh, y, SHARDED),
                IIRState(_mesh.from_local(
                    self.mesh, s_fin.reshape(-1, m + 1, 2), ROWS)))
