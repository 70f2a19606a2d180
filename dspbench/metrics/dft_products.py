"""Products the small-DFT route launches a radar call: the program's
counter ``fft.dft_products`` (``ops/fft._dft_last``, one a plane and a
block of fixed shape) over ``radar.maps`` (``models/radar.
range_doppler_map``).  Every call of a run has the same shapes, so the mean
is each call's count; a program without the counters gives nothing."""


def read(ctx):
    try:
        from simpledsp_tpu_torch.utils.tracing import counters
    except ImportError:
        return None
    c = counters()
    if not c.get("radar.maps") or "fft.dft_products" not in c:
        return None
    return c["fft.dft_products"] / c["radar.maps"]
