"""Host ms a call inside the program's spans ``sdsp.radar.map``
(``models/radar.range_doppler_map``) and ``sdsp.radar.cfar``
(``cfar_ca``), the mean over the maps of the traced segment after
``trace_skip`` calls (one ``sdsp.radar.map`` span a map, as the counter
``radar.maps`` counts them).  The two spans open a call each, so a call of
the system opens two of the tracer's calls.  The spans are recorded under
the profiler, so the reading includes the profiler's own host cost of each
operation; a program without spans gives nothing."""


def read(ctx):
    try:
        from simpledsp_tpu_torch.utils.tracing import span_stats
    except ImportError:
        return None
    stats = span_stats(profiled_only=True,
                       skip_calls=2 * ctx.cell.traffic["trace_skip"])
    rdm, cfar = stats.get("sdsp.radar.map"), stats.get("sdsp.radar.cfar")
    if not rdm or not cfar or rdm["count"] != cfar["count"]:
        return None
    return (rdm["total_ms"] + cfar["total_ms"]) / rdm["count"]
