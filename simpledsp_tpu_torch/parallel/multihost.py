"""Multi-node runtime: process-group launch and node-sharded data feeding.

Port of ``simpledsp_tpu/parallel/multihost.py``.  JAX runs one process a
host, each driving all of its host's chips; torch runs one process a
device.  So the mesh is (dp = nodes, sp = ranks a node): channel
parallelism crosses nodes, and the sequence axis, whose halo and state
collectives are the latency-sensitive ones, stays inside a node.

Usage, one process a device::

    from simpledsp_tpu_torch.parallel import multihost
    multihost.initialize()                          # env:// (torchrun) or
    multihost.initialize(coordinator="h0:1234",
                         num_processes=8, process_id=r)   # explicit
    mesh = multihost.pod_mesh()                     # dp = nodes, sp = local
    x_node = loader.next_block()                    # each node loads ITS channels
    x = multihost.host_sharded(mesh, x_node)        # global DTensor, no transfer
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from simpledsp_tpu_torch.device import resolve_device
from simpledsp_tpu_torch.parallel import mesh as _mesh
from simpledsp_tpu_torch.parallel.mesh import SHARDED

__all__ = ["initialize", "pod_mesh", "host_sharded", "is_initialized"]

_initialized = False


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None) -> None:
    """Start the default process group: NCCL for ``device=None`` (CUDA,
    raising without a card), gloo for ``device="cpu"``.  With a
    ``coordinator`` ("host:port"), rendezvous there over TCP as rank
    ``process_id`` of ``num_processes``; with no arguments, take them from
    the environment (``env://``: MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
    RANK, as torchrun sets them).  A second call does nothing.  A failure
    raises with its context; nothing is left half started."""
    global _initialized
    if _initialized:
        return
    backend = _mesh.backend(resolve_device(device))
    init_method = f"tcp://{coordinator}" if coordinator else "env://"
    try:
        dist.init_process_group(
            backend, init_method=init_method,
            world_size=-1 if num_processes is None else num_processes,
            rank=-1 if process_id is None else process_id)
    except Exception as e:  # surface clearly, do not half-init
        raise RuntimeError(
            f"multi-host init failed (coordinator={coordinator!r}, "
            f"num_processes={num_processes}, process_id={process_id}); "
            f"check that every host runs the same binary and can reach the "
            f"coordinator: {e}") from e
    _initialized = True


def is_initialized() -> bool:
    return _initialized or (dist.is_initialized()
                            and dist.get_world_size() > 1)


def _local_world_size(device: torch.device) -> int:
    """Ranks a node: ``LOCAL_WORLD_SIZE`` (torchrun sets it), else the
    node's cards on CUDA, else the whole world (one node)."""
    if "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_WORLD_SIZE"])
    if device.type == "cuda":
        return torch.cuda.device_count()
    return dist.get_world_size()


def pod_mesh(device=None) -> DeviceMesh:
    """(dp = nodes, sp = ranks a node) mesh over every rank, ranks
    numbered node by node.  Channel parallelism crosses nodes; the sequence
    axis stays inside each node, where the halo and state collectives are
    cheap.  ``device=None`` means CUDA."""
    device = resolve_device(device)
    per_node = _local_world_size(device)
    world = dist.get_world_size()
    if per_node < 1 or world % per_node:
        raise ValueError(f"{world} ranks do not split into nodes of "
                         f"{per_node}")
    return _mesh.make_mesh(world // per_node, per_node, device)


def host_sharded(mesh: DeviceMesh, local_channels) -> torch.Tensor:
    """Assemble a global (C_total, ..., T) ``DTensor`` from each node's own
    channel block (C_node, ..., T), the same on every rank of the node,
    without cross-node transfer: each rank keeps its ``sp`` span of time.
    JAX's one process a host hands its whole block to its chips; here each
    of the node's ranks slices its own."""
    x = torch.as_tensor(np.asarray(local_channels))
    n, i = mesh["sp"].size(), mesh.get_local_rank("sp")
    t = x.shape[-1]
    if t % n:
        raise ValueError(f"T={t} does not split over sp={n}")
    local = x[..., i * (t // n):(i + 1) * (t // n)]
    shape = (x.shape[0] * mesh["dp"].size(),) + tuple(x.shape[1:])
    return _mesh.from_local(mesh, local.to(_mesh.mesh_device(mesh)),
                            SHARDED, shape=shape)
