"""simpledsp_tpu_torch — the PyTorch / CUDA port of ``simpledsp_tpu``.

Mirrors the JAX package's layout, one module per counterpart:

  design/    host-side float64 coefficient design (NumPy)
  ops/       functional torch ops: fft (1-D and 2-D, RI planes and complex
             wrappers), iir, fir (polyphase and overlap-save), demod,
             channelizer, conv (convolve / correlate / fftconvolve /
             oaconvolve) and conv2d (convolve2d / correlate2d)
  kernels/   hand-written CUDA kernels for Hopper (csrc/) with their plain
             PyTorch versions, plus the host tables they read: the chain,
             the PFB, overlap-save convolution and direct 2-D convolution
  models/    the north-star chain and the SDR receiver banks

It imports torch, NumPy and SciPy, never JAX.  This file imports nothing so
that importing one submodule stays cheap.
"""
