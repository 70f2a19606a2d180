"""Host-side integer math for shape/radix validation (the radix gates)."""

from __future__ import annotations

__all__ = ["is_power_of"]


def is_power_of(n: int, base: int) -> bool:
    if n < 1 or base < 2:
        return False
    while n % base == 0:
        n //= base
    return n == 1
