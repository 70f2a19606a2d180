"""End-to-end user scenarios through the port's public API, each with its
ground truth: ports of the JAX package's ``examples/*.py``.

    python -m simpledsp_tpu_torch.examples.fm_receiver [--device cpu]
    python -m simpledsp_tpu_torch.examples.channelize_resample [--device cpu]
    python -m simpledsp_tpu_torch.examples.radar_rdm [--device cpu]

Each module has ``run(device=None) -> dict`` (the arrays and figures the
scenario checks, and ``"laps"``, its progress lines with their seconds),
``check(result)`` (the scenario's asserts) and ``main(argv=None)``, which
prints the JAX script's lines and asserts the same ground truth.  The
device defaults to CUDA; without a card and without ``--device cpu`` a
scenario exits 2 with ``resolve_device``'s message.
"""

from __future__ import annotations

import argparse
import time

import torch

from simpledsp_tpu_torch.device import resolve_device

__all__ = ["parse_device", "Laps"]


def parse_device(argv=None, doc: str = "") -> torch.device:
    """The scenario's ``--device`` (None: CUDA), resolved; exits 2 with
    ``resolve_device``'s message where that device is not there."""
    p = argparse.ArgumentParser(description=doc)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; there is no "
                        "fallback: pass cpu to run on the CPU)")
    args = p.parse_args(argv)
    try:
        return resolve_device(args.device)
    except RuntimeError as e:
        p.exit(2, f"{p.prog}: {e} (on the command line: --device cpu)\n")


class Laps(list):
    """Progress lines, each with the seconds since the scenario began."""

    def __init__(self):
        super().__init__()
        self.t0 = time.time()

    def __call__(self, msg: str) -> None:
        self.append(f"[{time.time() - self.t0:6.1f}s] {msg}")
