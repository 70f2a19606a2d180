"""The share of the traced window in which no operation ran on the card,
in %, the mean over the ranks (``trace.py``: the window runs from the
first call's span to the end of the last synchronize)."""

from dspbench.readers import idle_share


def read(ctx):
    return idle_share(ctx)
