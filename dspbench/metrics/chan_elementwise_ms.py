"""Device ms a call of every operation of the F-engine's call but the
frames FFT kernel: the history concatenation and copy, the branch FIRs'
flip, products and adds (``ops/channelizer.py``), and the half-spectrum
transform's de-interleave, concatenations, flips and post-twiddle
(``ops/fft.rfft_ri``)."""

from dspbench.readers import per_call_ms


def read(ctx):
    return per_call_ms(ctx, lambda name: "fft_frames_kernel" not in name)
