"""simpledsp_tpu_torch — the PyTorch / CUDA port of ``simpledsp_tpu``.

Mirrors the JAX package's layout, one module per counterpart:

  design/    host-side float64 coefficient design (NumPy)
  ops/       functional torch ops: fft, iir, fir, demod, channelizer
  kernels/   hand-written CUDA kernels for Hopper (csrc/) with their plain
             PyTorch versions, plus the host tables they read
  models/    the north-star chain and the SDR receiver banks

It imports torch, NumPy and SciPy, never JAX.  This file imports nothing so
that importing one submodule stays cheap.
"""
