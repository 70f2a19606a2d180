"""Device ms a call of every operation of the radar's call but the frames
FFT kernel and the Doppler transform's GEMMs: the pads, the spectral
product, the transposes, the small-DFT route's zero-padded copy and half
sums, the window, the power and its roll, and the CFAR's rolls, adds and
compare (``models/radar.py``)."""

from dspbench.readers import per_call_ms


def read(ctx):
    return per_call_ms(ctx, lambda name: "fft_frames_kernel" not in name
                       and "gemm" not in name.lower())
