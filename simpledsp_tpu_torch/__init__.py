"""simpledsp_tpu_torch — the PyTorch / CUDA port of ``simpledsp_tpu``.

Mirrors the JAX package's layout, one module per counterpart:

  design/    host-side float64 coefficient design (NumPy)
  ops/       functional torch ops: fft (1-D and 2-D, RI planes and complex
             wrappers), iir, fir (polyphase and overlap-save), demod,
             channelizer, conv (convolve / correlate / fftconvolve /
             oaconvolve), conv2d (convolve2d / correlate2d), transforms
             (chirp-z / Bluestein, zoom FFT, DCT, Hilbert, Goertzel) and
             spectral (stft / istft, spectrograms, Welch, CSD, coherence,
             periodogram, Lomb-Scargle, envelope)
  kernels/   hand-written CUDA kernels for Hopper (csrc/) with their plain
             PyTorch versions, plus the host tables they read: the chain,
             the PFB, overlap-save convolution, direct 2-D convolution and
             the batched frames FFT under the FFT engine
  models/    the north-star chain, the SDR receiver banks and the
             pulse-Doppler radar (matched filter, range-Doppler map, CFAR)
  device.py  the default device of the objects that hold tables: CUDA
             unless the caller passes ``device="cpu"``

It imports torch, NumPy and SciPy, never JAX.  This file imports nothing so
that importing one submodule stays cheap.
"""
