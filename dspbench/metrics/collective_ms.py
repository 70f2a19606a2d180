"""Device ms a call of the NCCL kernels (the all_gather and the all_reduce
of the shard states, ``parallel/iir.py`` under ``ShardedNorthStarChain``),
the mean over the ranks."""

from dspbench.readers import per_call_ms


def read(ctx):
    return per_call_ms(ctx, lambda name: "nccl" in name.lower())
