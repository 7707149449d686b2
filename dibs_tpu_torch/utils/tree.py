"""Minimal parameter-tree toolkit (counterpart of ``dibs_tpu/utils/tree.py``).

A tree is a tensor, or a list or tuple of trees. ``LinearGaussian``'s
``Theta [P, d, d]`` is a one-leaf tree; ``DenseNonlinearGaussian``'s
parameters are ``[(W1, b1), (W2, b2), ...]``. Leaves are visited depth
first, in order, which is the order of ``jax.tree_util.tree_leaves`` for the
same nesting.
"""
from __future__ import annotations

from typing import Callable, List

import torch

__all__ = ["tree_leaves", "tree_map", "tree_unflatten", "tree_rows",
           "tree_select", "tree_mul"]


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of ``tree``, depth first."""
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and the trees of the same
    structure in ``rest``; keeps the nesting and the list/tuple types."""
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *subs) for subs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_unflatten(like, leaves) -> object:
    """The tree with the structure of ``like`` whose leaves, depth first,
    are ``leaves``."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def tree_rows(tree) -> torch.Tensor:
    """``[B, n]``: every leaf flattened to ``[B, -1]`` (``B`` its leading
    dim) and concatenated over the leaves in order (a one-leaf tree is only
    reshaped)."""
    rows = [leaf.reshape(leaf.shape[0], -1) for leaf in tree_leaves(tree)]
    return rows[0] if len(rows) == 1 else torch.cat(rows, dim=1)


def tree_select(tree, mask: torch.Tensor):
    """Every leaf indexed along its leading dim by the boolean ``mask``."""
    return tree_map(lambda leaf: leaf[mask], tree)


def tree_mul(tree, c):
    """Every leaf multiplied by the scalar ``c``."""
    return tree_map(lambda leaf: leaf * c, tree)
