"""Device ms a call of the Doppler transform's products: the small-DFT
route's fixed-shape ``torch.bmm`` launches (``ops/fft._dft_last``, cuBLAS,
IEEE float32), the call's only GEMM kernels, by name."""

from dspbench.readers import per_call_ms


def read(ctx):
    return per_call_ms(ctx, lambda name: "gemm" in name.lower())
