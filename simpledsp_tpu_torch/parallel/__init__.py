"""The mesh/sharding layer on ``torch.distributed``: one process a device.

Port of ``simpledsp_tpu/parallel/``.  JAX's ``Mesh`` plus ``shard_map`` is
one controller over many devices; the port runs one process a device and
maps each piece one for one (the collectives are ``parallel/mesh.py``'s):

+--------------------------------+--------------------------------------------------------------+
| JAX (file:line)                | Port                                                         |
+================================+==============================================================+
| ``Mesh(devices, ("dp",         | ``init_device_mesh(device_type, (dp, sp),                    |
| "sp"))``, ``make_mesh``        | mesh_dim_names=("dp", "sp"))``;                              |
| ``mesh.py:38``,                | ``single_device_mesh(device=None)`` starts a group of one if |
| ``single_device_mesh`` :60     | none exists (``init_process_group(backend,                   |
|                                | store=HashStore(), rank=0, world_size=1)``, NCCL on CUDA,    |
|                                | gloo on the CPU). ``device=None`` means CUDA and raises      |
|                                | without a card.                                              |
+--------------------------------+--------------------------------------------------------------+
| ``NamedSharding`` /            | ``DTensor`` placements ``[Shard(0), Shard(x.ndim - 1)]`` /   |
| ``PartitionSpec``,             | ``[Replicate(), Replicate()]``; a 1-D signal ``[Replicate(), |
| ``shard_signal`` :67,          | Shard(0)]``, as ``P("sp")``.                                 |
| ``replicate`` :76              |                                                              |
+--------------------------------+--------------------------------------------------------------+
| ``jax.shard_map(f, in_specs,   | ``local_part`` (the global tensor sliced, or                 |
| out_specs)``                   | ``DTensor.to_local()``) on the way in, a plain local         |
|                                | function, ``DTensor.from_local`` on the way out. A module    |
|                                | takes the global tensor (the same on every rank) or a        |
|                                | ``DTensor`` and returns ``DTensor`` s placed as JAX's        |
|                                | ``out_specs``; read them with ``.full_tensor()``.            |
+--------------------------------+--------------------------------------------------------------+
| ``jax.lax.ppermute`` ring      | ``ring_shift``: ``dist.batch_isend_irecv`` of ``P2POp`` s    |
| shift (``fir.py:53``,          | over the ``sp`` group, peers ``dist.get_global_rank(group, i |
| ``fir.py:250``,                | +- 1)``; no exchange with ``sp == 1``.                       |
| ``spectral.py:66``)            |                                                              |
+--------------------------------+--------------------------------------------------------------+
| ``jax.lax.all_gather``         | ``all_gather``: one gather into a contiguous (P C_l, D)      |
| (``iir.py:128``,               | buffer.                                                      |
| ``chain.py:624``)              |                                                              |
+--------------------------------+--------------------------------------------------------------+
| ``jax.lax.psum``               | ``psum`` (``dist.all_reduce(SUM)``) for the state sums;      |
| (``iir.py:145``,               | ``_replicated_tail`` a ``dist.broadcast`` from the last      |
| ``chain.py:652``,              | ``sp`` rank; the gathered channelizer output an all_gather   |
| ``fir.py:70``, ``fir.py:171``) | along frames.                                                |
+--------------------------------+--------------------------------------------------------------+
| ``jax.lax.axis_index`` /       | ``axis_index(group)`` / ``axis_size(group)`` of              |
| ``axis_size``                  | ``mesh.get_group("sp")``.                                    |
+--------------------------------+--------------------------------------------------------------+
| ``jax.distributed.initialize`` | ``init_process_group(backend,                                |
| , ``multihost.py:34``          | init_method=f"tcp://{coordinator}",                          |
|                                | world_size=num_processes, rank=process_id)``, or ``env://``  |
|                                | with no arguments; JAX's error message with its context, and |
|                                | idempotent.                                                  |
+--------------------------------+--------------------------------------------------------------+
| ``pod_mesh`` :60,              | (dp = nodes, sp = ranks a node, from ``LOCAL_WORLD_SIZE``);  |
| ``host_sharded`` :73           | ``host_sharded`` slices the node's channels to the rank's    |
|                                | ``sp`` span and calls ``DTensor.from_local``. JAX runs one   |
|                                | process a host, torch one a device.                          |
+--------------------------------+--------------------------------------------------------------+

The modules are ``mesh``, ``iir`` (``ShardedBlockIIR``), ``fir``
(``halo_exchange``, ``ShardedFIR``, ``ShardedChannelizer``,
``ShardedConvolve``, ``ShardedOverlapSaveFIR``), ``sdr``
(``ShardedReceiverBank``), ``spectral`` (``ShardedSTFT``) and
``multihost``; ``models.northstar.ShardedNorthStarChain`` runs the chain on
a mesh.  The names below are the JAX package's; each resolves on first
access (``_lazy.py``).
"""

from simpledsp_tpu_torch import _lazy

_lazy.install(globals(), {
    "parallel.mesh": ("DATA_AXIS", "SEQ_AXIS", "make_mesh", "replicate",
                      "shard_signal", "single_device_mesh"),
    "parallel.iir": ("ShardedBlockIIR",),
    "parallel.sdr": ("ShardedReceiverBank",),
    "parallel.fir": ("ShardedChannelizer", "ShardedConvolve", "ShardedFIR",
                     "ShardedOverlapSaveFIR", "halo_exchange"),
    "parallel.spectral": ("ShardedSTFT",),
})
