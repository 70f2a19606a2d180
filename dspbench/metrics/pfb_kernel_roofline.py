"""The PFB kernel's share of the bank's roofline: the least time of the
call's algorithm (the input planes read once, the audio written once; the
branch FIR, the M-point DFT, the discriminator and the decimator) over the
device time a call of ``pfb_kernel`` (``csrc/pfb.cu``)."""

from dspbench.readers import roofline


def read(ctx):
    return roofline(ctx, "pfb_kernel")
