"""The frames FFT kernel's share of its roofline in the F-engine's calls:
the least time of the half-spectrum transforms' complex part alone (one
M/2-point FFT a spectrum, each reading its input and writing its output
once; ``roofline_fengine.half_transforms_work``) over the device time a
call of ``fft_frames_kernel`` (``csrc/fft.cu``), in %."""

from dspbench.readers import per_call_ms
from dspbench.roofline import bound_s


def read(ctx):
    w = ctx.work
    if "fft_flops" not in w:
        return None
    ms = per_call_ms(ctx, lambda name: "fft_frames_kernel" in name)
    if ms is None:
        return None
    return 100.0 * bound_s(w["fft_flops"], w["fft_bytes"]) / (ms * 1e-3)
