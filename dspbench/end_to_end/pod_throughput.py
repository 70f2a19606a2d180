"""Input samples of every call of every rank over the window of the ranks
together (the earliest first submission to the latest return of a final
synchronize), in Msamples/s."""

from dspbench.window import msamples_per_s


def read(ctx):
    return msamples_per_s(ctx.window)
