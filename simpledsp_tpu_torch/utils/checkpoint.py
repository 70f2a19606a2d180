"""Checkpoint and resume of a streaming pipeline's carried state.

Port of ``simpledsp_tpu/utils/checkpoint.py``, in the same file format, so
that a state saved by either package resumes in the other: an ``.npz`` with
leaf ``i`` of the flattened state as ``leaf{i}`` (or ``leaf{i}_re`` and
``leaf{i}_im`` when it is complex) and ``__meta__``, the UTF-8 bytes of a
JSON object with ``n`` (the leaf count), ``kinds`` ("real" or "complex" for
each leaf) and ``treedef`` (a string that shows the structure; neither
package's loader reads it).  The leaves are numbered as ``jax.tree_util``
numbers them (``utils.host.tree_leaves``): None holds no leaf.
"""

from __future__ import annotations

import json
import pathlib
from typing import Any

import numpy as np
import torch

from simpledsp_tpu_torch.utils.host import to_numpy, tree_leaves, tree_map

__all__ = ["save_state", "load_state"]


def save_state(path, state: Any) -> None:
    """Save a state tree (IIRState, FIRState, SDRState, tuples...) to
    ``path`` (.npz).  Complex leaves are stored as two float planes and
    joined again on load."""
    arrays = {}
    meta = []
    for i, leaf in enumerate(tree_leaves(state)):
        a = to_numpy(leaf)
        if np.iscomplexobj(a):
            arrays[f"leaf{i}_re"] = a.real
            arrays[f"leaf{i}_im"] = a.imag
            meta.append("complex")
        else:
            arrays[f"leaf{i}"] = a
            meta.append("real")
    treedef = repr(tree_map(lambda _: "*", state))
    arrays["__meta__"] = np.frombuffer(
        json.dumps({"n": len(meta), "kinds": meta,
                    "treedef": treedef}).encode(), dtype=np.uint8)
    np.savez(pathlib.Path(path), **arrays)


def load_state(path, like: Any) -> Any:
    """Load a state saved by :func:`save_state` (of either package).

    ``like`` gives the structure, for example a freshly initialised state
    of the same pipeline: each of its tensor leaves is replaced by the
    saved array of the same index, on the leaf's device and in its dtype.
    Raises ValueError when the leaf counts or a leaf's shape differ."""
    with np.load(pathlib.Path(path)) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        protos = tree_leaves(like)
        if meta["n"] != len(protos):
            raise ValueError(f"checkpoint has {meta['n']} leaves, prototype "
                             f"has {len(protos)}")
        saved = []
        for i, (kind, proto) in enumerate(zip(meta["kinds"], protos)):
            a = (data[f"leaf{i}_re"] + 1j * data[f"leaf{i}_im"]
                 if kind == "complex" else data[f"leaf{i}"])
            shape = (tuple(proto.shape) if torch.is_tensor(proto)
                     else np.shape(proto))
            if a.shape != shape:
                raise ValueError(f"checkpoint leaf {i} has shape {a.shape}, "
                                 f"prototype has {shape}")
            saved.append(a)
    it = iter(saved)

    def place(proto):
        a = next(it)
        if torch.is_tensor(proto):
            return torch.as_tensor(a).to(device=proto.device,
                                         dtype=proto.dtype)
        return np.asarray(a, dtype=np.asarray(proto).dtype)

    return tree_map(place, like)
