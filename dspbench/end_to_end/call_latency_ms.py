"""The mean host time of a call where the caller waits for each call before
it submits the next: the window's seconds over its calls, in ms."""

from dspbench.window import mean_call_ms


def read(ctx):
    return mean_call_ms(ctx.window)
