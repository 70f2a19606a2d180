"""Host ms a call inside the program's span ``sdsp.chan.forward``
(``ops/channelizer.PFBChannelizer.process_real``), the mean over the calls
of the traced segment after ``trace_skip`` calls (the span opens a call of
the tracer).  The span is recorded under the profiler, so the reading
includes the profiler's own host cost of each operation; a program without
the span gives nothing."""


def read(ctx):
    try:
        from simpledsp_tpu_torch.utils.tracing import span_stats
    except ImportError:
        return None
    stats = span_stats(profiled_only=True,
                       skip_calls=ctx.cell.traffic["trace_skip"])
    call = stats.get("sdsp.chan.forward")
    if not call or not call["count"]:
        return None
    return call["total_ms"] / call["count"]
