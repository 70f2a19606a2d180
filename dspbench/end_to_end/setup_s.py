"""Seconds from the start of the process (the launcher's, on several cards)
to the first timed call: imports, the build or the load of the kernels,
the port's tables, the inputs made on the card and the warm-up."""


def read(ctx):
    return ctx.setup_s
