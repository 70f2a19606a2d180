"""Matmul precision of the port: the JAX package's tiers mapped to the card.

The JAX package picks a ``jax.lax.Precision`` per dot.  On a TPU, DEFAULT
rounds float32 operands to bf16 (about 54 dB SNR), HIGH is a 3-pass bf16
product (about 100 dB) and HIGHEST a 6-pass one that holds float32
accuracy.  On an NVIDIA card the matching trap is TF32, which keeps about
three decimal digits:

    JAX tier   port           torch setting
    HIGHEST    IEEE float32   torch.backends.cuda.matmul.allow_tf32 = False
    HIGH       3xTF32         not ported
    DEFAULT    TF32           not ported

The chain holds >= 130 dB against a float64 oracle only at HIGHEST: its
two-step prepass projection loses about 37 dB at reduced precision (the
F-power cancellation recorded in ``simpledsp_tpu/kernels/chain.py``).  So every matmul of
the port runs inside :func:`ieee_fp32`, whatever the caller has set.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["ieee_fp32"]


@contextlib.contextmanager
def ieee_fp32():
    """Run the enclosed float32 matmuls and cuDNN convolutions in IEEE
    float32 (no TF32), then restore the caller's two ``allow_tf32``
    settings, also when the body raises."""
    prev_mm = torch.backends.cuda.matmul.allow_tf32
    prev_conv = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_mm
        torch.backends.cudnn.allow_tf32 = prev_conv
