"""The device an object of the port is built on when the caller names none.

The port runs on the card: an object that holds tables (a chain, a bank, a
filter, a transform plan) and is built with ``device=None`` goes to CUDA,
and where there is no card it raises instead of falling back to the CPU.
A CPU caller asks for the CPU with ``device="cpu"``.  Plain functions on
tensors follow their input's device and do not call this.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means CUDA.  Raises
    RuntimeError for CUDA (named or by default) where CUDA is not
    available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        how = ("no device was given, so the default is CUDA"
               if device is None else f"device={str(device)!r} was asked for")
        raise RuntimeError(f"CUDA is not available and {how}; pass "
                           f"device='cpu' to run on the CPU")
    return dev
