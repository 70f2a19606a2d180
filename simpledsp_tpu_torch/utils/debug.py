"""Numerical-safety checks.

Port of ``simpledsp_tpu/utils/debug.py``.  The failure modes are numerical:
NaN or Inf escaping a chain (an unstable filter design, float32 overflow).
``checked`` wraps a step function and checks its output; ``assert_stable``
checks a biquad design's poles before anything runs.

The JAX ``checked`` instruments every operation (``checkify``) and so names
the operation that made the first NaN, and takes ``jit=``; PyTorch has no
counterpart of either, so the port checks the output's leaves and names the
leaf.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from simpledsp_tpu_torch.design.biquad import BiquadCascadeDesign
from simpledsp_tpu_torch.utils.host import tree_items

__all__ = ["checked", "assert_stable", "pole_radii"]


def checked(fn: Callable) -> Callable:
    """Wrap ``fn`` so that a NaN or Inf in any floating (or complex) tensor
    of its output raises a RuntimeError that names the leaf, in place of
    flowing on."""
    name = getattr(fn, "__qualname__", repr(fn))

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        for path, leaf in tree_items(out):
            if not (torch.is_tensor(leaf)
                    and (leaf.is_floating_point() or leaf.is_complex())):
                continue
            bad = ~torch.isfinite(leaf)
            if bool(bad.any()):
                raise RuntimeError(
                    f"{name}: output{path} has {int(bad.sum())} non-finite "
                    f"value(s) of {leaf.numel()} (NaN or Inf)")
        return out

    return wrapper


def pole_radii(design: BiquadCascadeDesign) -> np.ndarray:
    """|pole| per section; all must be < 1 for stability."""
    return np.asarray([np.abs(np.roots(design.a[k])).max()
                       for k in range(design.nsections)])


def assert_stable(design: BiquadCascadeDesign, margin: float = 1e-9) -> None:
    """Raise ValueError if any section's pole is on or outside the unit
    circle."""
    r = pole_radii(design)
    if (r >= 1.0 - margin).any():
        raise ValueError(
            f"unstable design: section pole radii {r} (limit < 1); "
            f"check f0/fs/Q parameters")
