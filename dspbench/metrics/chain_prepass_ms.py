"""Device ms a call of the chain's work beside its kernel: the prepass
GEMMs of ``kernels/chain.py`` (cuBLAS, IEEE float32) and the small
operations around them, every device operation of the call but
``chain_natural_kernel``."""

from dspbench.readers import per_call_ms


def read(ctx):
    return per_call_ms(ctx, lambda name: "chain_natural_kernel" not in name)
