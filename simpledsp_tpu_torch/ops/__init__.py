"""Functional torch ops on tensors: IIR and FFT."""
