"""Host ms a call inside the program's span ``sdsp.bank.forward``
(``models/sdr.py`` ``FMReceiverBank.forward``: the input planes, the
[hist | x | pad] copies, the state) less its child ``sdsp.pfb.launch``, the
mean over the traced segment's calls after ``trace_skip``.  The spans are
recorded under the profiler, so the reading includes the profiler's own
host cost of each operation; a program without spans gives nothing."""


def read(ctx):
    try:
        from simpledsp_tpu_torch.utils.tracing import span_stats
    except ImportError:
        return None
    stats = span_stats(profiled_only=True,
                       skip_calls=ctx.cell.traffic["trace_skip"])
    call = stats.get("sdsp.bank.forward")
    if not call:
        return None
    launch = stats.get("sdsp.pfb.launch", {"total_ms": 0.0})
    return (call["total_ms"] - launch["total_ms"]) / call["count"]
