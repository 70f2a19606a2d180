"""Device meshes and the collectives of the sharded signal pipeline.

Port of ``simpledsp_tpu/parallel/mesh.py``.  The framework's two
parallelism axes:

* ``"dp"``: data/channel parallelism, independent channels or batches of
  the signal chain;
* ``"sp"``: sequence/block parallelism, contiguous time shards of one long
  signal, tied together by the streaming state.

JAX runs one controller over every device of a ``Mesh``; the port runs one
process a device on ``torch.distributed``, and a mesh is a
:class:`~torch.distributed.device_mesh.DeviceMesh` over the world's ranks,
laid out (dp, sp) row-major.  A sharded module takes the global tensor (the
same on every rank) or a :class:`~torch.distributed.tensor.DTensor`, runs
a plain local function on this rank's part (:func:`local_part`) and returns
``DTensor`` s placed as JAX's ``out_specs`` (:func:`from_local`).

The collectives the modules use live here, beside the mesh, each over one
axis of it: :func:`ring_shift` (JAX's ``ppermute`` by one step),
:func:`all_gather`, :func:`psum`, :func:`broadcast_from_last`, and
:func:`axis_index` / :func:`axis_size`.  None is caught: a failed
collective raises.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

from simpledsp_tpu_torch.device import resolve_device

__all__ = [
    "DATA_AXIS",
    "SEQ_AXIS",
    "make_mesh",
    "single_device_mesh",
    "shard_signal",
    "replicate",
    "mesh_device",
    "backend",
    "local_part",
    "from_local",
    "axis_index",
    "axis_size",
    "ring_shift",
    "all_gather",
    "psum",
    "broadcast_from_last",
]

DATA_AXIS = "dp"
SEQ_AXIS = "sp"

# The placements of JAX's P(dp, ..., sp), P(dp, sp, None) (frames over
# sp), P(dp, None) and P().
SHARDED = (Shard(0), Shard(-1))
SHARDED_FRAMES = (Shard(0), Shard(1))
ROWS = (Shard(0), Replicate())
REPLICATED = (Replicate(), Replicate())


def backend(device: torch.device) -> str:
    """The process-group backend of ``device``'s ranks: NCCL on CUDA, gloo
    on the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def _bind_device(device: torch.device) -> torch.device:
    """This rank's device of ``device``'s type: on CUDA the card of index
    ``LOCAL_RANK`` (default: the rank modulo the cards), made current."""
    if device.type != "cuda":
        return device
    import os
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    index = local % torch.cuda.device_count()
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def make_mesh(dp: Optional[int] = None, sp: Optional[int] = None,
              device=None) -> DeviceMesh:
    """Build a ``(dp, sp)`` mesh over the ranks of the default process
    group, on ``device``'s type (``None``: CUDA, raising without a card).

    With neither size given, all ranks go to the sequence axis.  Sizes must
    multiply to the world size.  The group must be initialized
    (:func:`single_device_mesh` or :func:`multihost.initialize`).
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(torch.distributed.init_process_group, "
                           "parallel.multihost.initialize or "
                           "single_device_mesh)")
    device = _bind_device(resolve_device(device))
    n = dist.get_world_size()
    if dp is None and sp is None:
        dp, sp = 1, n
    elif dp is None:
        dp = n // sp
    elif sp is None:
        sp = n // dp
    if dp * sp != n:
        raise ValueError(f"mesh {dp}x{sp} != device count {n}")
    return init_device_mesh(device.type, (dp, sp),
                            mesh_dim_names=(DATA_AXIS, SEQ_AXIS))


def single_device_mesh(device=None) -> DeviceMesh:
    """1x1 mesh on one device, so the sharded pipeline runs unmodified on
    one card (``device=None``: CUDA, raising without one; ``"cpu"``: gloo).

    Starts a process group of one (NCCL on CUDA, gloo on the CPU, an
    in-memory store) if none exists; the caller ends it with
    ``torch.distributed.destroy_process_group()``.
    """
    device = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend(device), store=dist.HashStore(),
                                rank=0, world_size=1)
    if dist.get_world_size() != 1:
        raise ValueError(f"single_device_mesh needs a group of one process, "
                         f"this one has {dist.get_world_size()}; use "
                         f"make_mesh")
    return make_mesh(1, 1, device)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device of the mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_index(group) -> int:
    """This rank's index in ``group``, the process group of one mesh axis
    (``mesh.get_group("sp")``): JAX's ``axis_index``."""
    return dist.get_rank(group)


def axis_size(group) -> int:
    """The number of ranks of ``group``: JAX's ``axis_size``."""
    return dist.get_world_size(group)


def _coordinate(mesh: DeviceMesh, axis: str):
    """(size, this rank's index) of the mesh along ``axis``.  Not through
    ``mesh[axis]``, which builds a sub-mesh (about 0.15 ms a call)."""
    dim = mesh.mesh_dim_names.index(axis)
    return mesh.size(dim), mesh.get_coordinate()[dim]


def _placements(placements: Sequence[Placement], ndim: int):
    return [Shard(p.dim % ndim) if isinstance(p, Shard) else p
            for p in placements]


def local_part(mesh: DeviceMesh, x, placements: Sequence[Placement],
               dtype=None) -> torch.Tensor:
    """This rank's part of ``x`` under ``placements`` (one a mesh axis,
    ``Shard(-1)`` the last dim), on the mesh's device in ``dtype``.

    ``x`` is the global tensor, the same on every rank (then sliced here,
    with no communication; each sharded dim must split evenly), or a
    ``DTensor`` on ``mesh`` (then redistributed).
    """
    device = mesh_device(mesh)
    if isinstance(x, DTensor):
        if x.device_mesh != mesh:
            raise ValueError("the DTensor lives on another mesh")
        placements = _placements(placements, x.ndim)
        if list(x.placements) != placements:
            x = x.redistribute(mesh, placements)
        local = x.to_local()
        return local.to(device=device, dtype=dtype or local.dtype)
    x = torch.as_tensor(x)
    for axis, p in zip((DATA_AXIS, SEQ_AXIS), _placements(placements,
                                                          x.ndim)):
        if isinstance(p, Shard):
            n, i = _coordinate(mesh, axis)
            size = x.shape[p.dim]
            if size % n:
                raise ValueError(f"dim {p.dim} of size {size} does not split "
                                 f"over the {n} ranks of {axis!r}")
            x = x.narrow(p.dim, i * (size // n), size // n)
    return x.to(device=device, dtype=dtype or x.dtype)


def from_local(mesh: DeviceMesh, local: torch.Tensor,
               placements: Sequence[Placement], shape=None) -> DTensor:
    """The ``DTensor`` of which ``local`` is this rank's part (JAX's
    ``out_specs``).  ``shape`` is the global shape, needed where the shards
    are uneven; by default the shards are even."""
    placements = _placements(placements, local.ndim)
    if shape is None:
        shape = list(local.shape)
        for axis, p in zip((DATA_AXIS, SEQ_AXIS), placements):
            if isinstance(p, Shard):
                shape[p.dim] *= _coordinate(mesh, axis)[0]
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return DTensor.from_local(local.contiguous(), mesh, placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=tuple(stride))


def shard_signal(mesh: DeviceMesh, x: torch.Tensor) -> DTensor:
    """Place a (channels, T) signal with channels over dp and time over sp
    (a 1-D signal: time over sp)."""
    placements = ((Replicate(), Shard(0)) if x.ndim == 1 else SHARDED)
    return from_local(mesh, local_part(mesh, x, placements), placements,
                      shape=x.shape)


def replicate(mesh: DeviceMesh, x: torch.Tensor) -> DTensor:
    """``x`` whole on every rank of the mesh."""
    return from_local(mesh, local_part(mesh, x, REPLICATED), REPLICATED)


# -- collectives over the process group of one mesh axis ------------------

def ring_shift(x: torch.Tensor, shift: int, group) -> torch.Tensor:
    """Rank i of ``group`` sends ``x`` to rank i + shift (shift = +1 or -1)
    and returns what rank i - shift sent; a rank with no such neighbour
    gets zeros (JAX's ``ppermute`` over the open ring).  One
    ``batch_isend_irecv``; none with a group of one."""
    n, i = axis_size(group), axis_index(group)
    if n == 1:
        return torch.zeros_like(x)
    x = x.contiguous()
    recv = torch.zeros_like(x)
    ops = []
    if 0 <= i + shift < n:
        ops.append(dist.P2POp(dist.isend, _real(x),
                              dist.get_global_rank(group, i + shift), group))
    if 0 <= i - shift < n:
        ops.append(dist.P2POp(dist.irecv, _real(recv),
                              dist.get_global_rank(group, i - shift), group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(P, *x.shape): every rank's ``x`` in rank order, on every rank of
    ``group``.  One gather into a contiguous (P x.shape[0], ...) buffer."""
    x = x.contiguous()
    out = torch.empty((axis_size(group),) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    flat = _real(out).reshape((-1,) + tuple(_real(x).shape[1:]))
    gather(flat, _real(x), group=group)
    return out


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``, on each of them."""
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def broadcast_from_last(x: torch.Tensor, group) -> torch.Tensor:
    """The last rank of ``group``'s ``x``, on every rank of it; no
    collective with a group of one."""
    n = axis_size(group)
    out = x.contiguous().clone()
    if n > 1:
        dist.broadcast(_real(out), dist.get_global_rank(group, n - 1),
                       group=group)
    return out


def _real(x: torch.Tensor) -> torch.Tensor:
    """A real view of ``x`` for the collectives (complex as (..., 2))."""
    return torch.view_as_real(x) if x.is_complex() else x
