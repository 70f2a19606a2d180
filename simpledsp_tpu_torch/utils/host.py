"""Host transfers and the nested containers the port's states are made of.

Port of ``simpledsp_tpu/utils/host.py``.  A carried state is a tree of
tensors: tuples (NamedTuples among them), lists and dicts, with None for an
absent part (``SDRState.dc`` on an FM bank).  The walk below flattens such a
tree as ``jax.tree_util`` does, so that leaf ``i`` of a state means the same
tensor in both packages: None holds no leaf, and a dict's items go in the
order of its sorted keys.  (``torch.utils._pytree`` counts None as a leaf
and keeps a dict's insertion order, so it cannot be used for that.)
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

import numpy as np
import torch

__all__ = ["to_numpy", "tree_map", "tree_items", "tree_leaves"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable[[Any], Any], tree):
    """``tree`` with each leaf replaced by ``fn(leaf)``, visited in
    :func:`tree_leaves` order; None stays None."""
    if tree is None:
        return None
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def tree_items(tree, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of every leaf, in ``jax.tree_util`` order; the path
    reads like the access that reaches the leaf (``.chan.hist_r``,
    ``[0]``, ``['key']``)."""
    if tree is None:
        return
    if _is_namedtuple(tree):
        for name, v in zip(tree._fields, tree):
            yield from tree_items(v, f"{path}.{name}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from tree_items(v, f"{path}[{i}]")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], f"{path}[{k!r}]")
    else:
        yield path, tree


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in tree_items(tree)]


def _fetch(x) -> np.ndarray:
    if not torch.is_tensor(x):
        return np.asarray(x)
    x = x.detach()
    if x.is_complex():
        return x.real.cpu().numpy() + 1j * x.imag.cpu().numpy()
    return x.cpu().numpy()


def to_numpy(tree):
    """Fetch a tensor, or a tree of tensors, to host numpy; complex
    tensors travel as their (real, imag) planes, as in the JAX package."""
    return tree_map(_fetch, tree)
