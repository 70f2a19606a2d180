"""Functional torch ops on tensors: FFT and the transforms and spectral
analysis built on it, IIR, FIR, demodulation, channelizer, convolution."""
