"""The chain kernel's share of the chain's roofline: the least time of the
call's algorithm (each sample read once, the packed spectra written once,
the biquad recursion and 2.5 N log2 N a frame) over the device time a call
of ``chain_natural_kernel`` (``csrc/chain.cu``)."""

from dspbench.readers import roofline


def read(ctx):
    return roofline(ctx, "chain_natural_kernel")
