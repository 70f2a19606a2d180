"""Host ms a call inside the program's span ``sdsp.chain.launch``
(``kernels/chain.py`` ``_on_device``: the chain kernel's checks, tables
and launch), the mean over the traced segment's calls after
``trace_skip``.  The spans are recorded under the profiler, so the reading
includes the profiler's own host cost of each operation; a program without
spans gives nothing."""


def read(ctx):
    try:
        from simpledsp_tpu_torch.utils.tracing import span_stats
    except ImportError:
        return None
    stats = span_stats(profiled_only=True,
                       skip_calls=ctx.cell.traffic["trace_skip"])
    call, part = stats.get("sdsp.chain.forward"), stats.get(
        "sdsp.chain.launch")
    if not call or not part:
        return None
    return part["total_ms"] / call["count"]
