"""Seeds of the inputs: every block of samples, and every sample drawn for a
check, follows from ``--seed`` alone."""

from __future__ import annotations

import hashlib
import random

import torch


def sub_seed(seed: int, *parts) -> int:
    """A 63-bit seed for one part of a run, from the run's seed and the
    part's labels."""
    text = ":".join(str(p) for p in (seed,) + parts)
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") >> 1


def block_generator(device, seed: int, block: int, shard: int
                    ) -> torch.Generator:
    """The generator of one block's shard, on the device that makes it."""
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "block", block, shard))
    return gen


def draw(seed: int, label: str, n: int, k: int) -> list:
    """``k`` distinct indices of ``range(n)``, in order, drawn from the
    seed."""
    return sorted(random.Random(sub_seed(seed, label)).sample(range(n),
                                                              min(k, n)))
