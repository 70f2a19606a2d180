"""The device an object of the port is built on when the caller names none.

The port runs on the card: an object that holds tables (a chain, a bank, a
filter, a transform plan) and is built with ``device=None`` goes to CUDA,
and where there is no card it raises instead of falling back to the CPU.
A CPU caller asks for the CPU with ``device="cpu"``.  Plain functions on
tensors follow their input's device and do not call this.

The models choose their kernel path here too: ``use_kernel=None`` means
"on a CUDA device", and ``use_pallas``, the JAX package's name for the
same switch, is taken as an alias.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "resolve_use_kernel"]


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


def resolve_use_kernel(use_kernel, use_pallas, device: torch.device) -> bool:
    """Whether a model runs its CUDA kernel path: ``use_kernel``, or its
    JAX-package alias ``use_pallas``; with neither given, whether
    ``device`` is CUDA.  Raises ValueError when both are given and
    differ."""
    if use_kernel is not None and use_pallas is not None \
            and bool(use_kernel) != bool(use_pallas):
        raise ValueError(f"use_kernel={use_kernel!r} and use_pallas="
                         f"{use_pallas!r} disagree; use_pallas is an alias "
                         f"of use_kernel")
    chosen = use_kernel if use_kernel is not None else use_pallas
    return device.type == "cuda" if chosen is None else bool(chosen)
