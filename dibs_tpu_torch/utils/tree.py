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
           "tree_index", "tree_select", "tree_mul", "tree_shapes",
           "tree_expand_leading_by", "tree_key_split", "tree_zeros_like"]


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of ``tree``, depth first."""
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and the trees of the same
    structure in ``rest``; keeps the nesting and the list/tuple types
    (named tuples too)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *subs) for subs in zip(tree, *rest)))
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


def tree_index(pytree, idx):
    """Every leaf indexed along its leading dim with ``idx``."""
    return tree_map(lambda leaf: leaf[idx], pytree)


def tree_select(pytree, bool_mask: torch.Tensor):
    """Every leaf indexed along its leading dim by the boolean mask."""
    return tree_map(lambda leaf: leaf[bool_mask], pytree)


def tree_mul(pytree, c):
    """Every leaf multiplied by the scalar ``c``."""
    return tree_map(lambda leaf: leaf * c, pytree)


def tree_shapes(pytree):
    """Every leaf replaced by a tensor of its shape."""
    return tree_map(lambda leaf: torch.tensor(tuple(leaf.shape)), pytree)


def tree_expand_leading_by(pytree, n: int):
    """Every leaf with ``n`` singleton dims prepended."""
    return tree_map(lambda leaf: leaf.reshape((1,) * n + tuple(leaf.shape)),
                    pytree)


def tree_key_split(generator: torch.Generator, pytree):
    """One fresh ``torch.Generator`` per leaf, in the tree's structure,
    each seeded from ``generator`` (the reference splits a JAX key)."""
    seeds = torch.randint(0, 2 ** 62, (len(tree_leaves(pytree)),),
                          generator=generator).tolist()
    return tree_unflatten(pytree, [torch.Generator().manual_seed(s)
                                   for s in seeds])


def tree_zeros_like(pytree):
    """Every leaf replaced by zeros of its shape, dtype and device."""
    return tree_map(torch.zeros_like, pytree)
