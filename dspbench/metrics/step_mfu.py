"""The whole call's share of the card's roofline: the least time of the
call's algorithm (``roofline.py``, the larger of its operations over the
float32 peak and its bytes over the memory bandwidth) over the traced
window's wall time a call, in %, the mean over the ranks."""

from dspbench.readers import step_mfu


def read(ctx):
    return step_mfu(ctx)
