"""Host ms a call inside ``NorthStarChain.__call__``, the mean over the
measured window's calls: the harness's own clock around each call, read
in the untraced window of a traced run, since the profiler's own host
cost would swamp it in the traced segment."""


def read(ctx):
    r = ctx.records[0]
    return r["call_host_s"] / r["window"][2] * 1e3
