"""Carried verbatim from ``simpledsp_tpu/utils/intmath.py``: pure Python.

Host-side integer math for shape/radix validation.

Parity with the reference's constexpr utilities (reference:
include/sdsp/fft.h:12-43 — log2/log4/isPowerOf2/isPowerOf4 used in
static_asserts); here they gate jit-specialization arguments, the
trace-time analog of template instantiation.
"""

from __future__ import annotations

__all__ = ["ilog2", "ilog4", "is_power_of_2", "is_power_of_4", "is_power_of"]


def ilog2(n: int) -> int:
    """Floor log2 for positive ints (reference: fft.h:12-21)."""
    if n < 1:
        raise ValueError(f"ilog2 needs n >= 1, got {n}")
    return n.bit_length() - 1


def ilog4(n: int) -> int:
    """Floor log4 (reference: fft.h:23-31)."""
    return ilog2(n) // 2


def is_power_of(n: int, base: int) -> bool:
    if n < 1 or base < 2:
        return False
    while n % base == 0:
        n //= base
    return n == 1


def is_power_of_2(n: int) -> bool:
    """Reference: fft.h:33-37."""
    return n >= 1 and (n & (n - 1)) == 0


def is_power_of_4(n: int) -> bool:
    """Reference: fft.h:39-43."""
    return is_power_of_2(n) and (ilog2(n) % 2 == 0)
