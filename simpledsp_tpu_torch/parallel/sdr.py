"""dp-sharded SDR receiver banks: many streams across ranks.

Port of ``simpledsp_tpu/parallel/sdr.py``.  The banks are embarrassingly
parallel over streams: the batch axis shards over the ``dp`` mesh axis with
no collective, and every per-stream state leaf (channelizer history, demod
carry, decimator history, AM dc) shards alongside.  Each rank runs the
bank's own forward on its streams, so on a CUDA mesh it reaches the flat
PFB kernel.  Time stays local: the banks are one-pass streaming kernels
whose only cross-call coupling is the small per-stream history.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from simpledsp_tpu_torch.models.sdr import SDRState
from simpledsp_tpu_torch.parallel import mesh as _mesh
from simpledsp_tpu_torch.parallel.mesh import DATA_AXIS, ROWS

__all__ = ["ShardedReceiverBank"]


def _map_state(fn, state):
    """``state`` with ``fn`` applied to each tensor leaf (NamedTuples
    rebuilt, None kept)."""
    if state is None:
        return None
    if isinstance(state, tuple):
        return type(state)(*(_map_state(fn, leaf) for leaf in state))
    return fn(state)


class ShardedReceiverBank(nn.Module):
    """Wrap an :class:`FMReceiverBank` / :class:`AMReceiverBank` on the
    mesh's ``dp`` axis.

    Call with x: (B, T) complex (or an (xr, xi) float-plane pair, or real
    samples), B a multiple of the dp axis size; returns (audio, state) as
    the wrapped bank does, each a ``DTensor`` (each state leaf one) placed
    on dp and replicated over sp: stream for stream the serial bank's
    result.  The bank must live on the mesh's device.
    """

    def __init__(self, bank, mesh: DeviceMesh):
        super().__init__()
        if bank.device.type != mesh.device_type:
            raise ValueError(f"the bank lives on {bank.device}, the mesh on "
                             f"{mesh.device_type}")
        self.bank = bank
        self.mesh = mesh
        self.n_data = mesh[DATA_AXIS].size()

    def init_state(self, batch: int) -> SDRState:
        return self.bank.init_state(batch)

    def forward(self, x: Union[torch.Tensor,
                               Tuple[torch.Tensor, torch.Tensor]],
                state: Optional[SDRState] = None
                ) -> Tuple[torch.Tensor, SDRState]:
        kw = dict(dtype=self.bank.dtype)
        if isinstance(x, (tuple, list)):
            xr, xi = x
        elif isinstance(x, np.ndarray) and np.iscomplexobj(x):
            xr, xi = torch.as_tensor(x.real), torch.as_tensor(x.imag)
        elif torch.is_tensor(x) and x.is_complex():
            xr, xi = x.real, x.imag
        else:
            xr = torch.as_tensor(x)
            xi = torch.zeros(xr.shape, **kw)
        b, t = xr.shape
        if b % self.n_data:
            raise ValueError(
                f"batch {b} must be a multiple of the dp axis size "
                f"{self.n_data}")
        if t % (self.bank.m * self.bank.decim) != 0:
            raise ValueError(
                f"T={t} must be a multiple of M*decim="
                f"{self.bank.m * self.bank.decim}")
        if state is None:
            state = self.init_state(b)
        xr, xi = (_mesh.local_part(self.mesh, v, ROWS, **kw) for v in (xr, xi))
        local = _map_state(
            lambda leaf: _mesh.local_part(self.mesh, leaf, ROWS, **kw), state)
        audio, new = self.bank._forward(xr, xi, local)
        return (_mesh.from_local(self.mesh, audio, ROWS),
                _map_state(lambda leaf: _mesh.from_local(self.mesh, leaf, ROWS),
                           new))
