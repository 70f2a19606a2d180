"""Input samples of every call of the window over its seconds, in
Msamples/s; a complex sample counts once."""

from dspbench.window import msamples_per_s


def read(ctx):
    return msamples_per_s(ctx.window)
