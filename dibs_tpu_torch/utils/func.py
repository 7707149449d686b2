"""Primitive tensor utilities (PyTorch twin of ``dibs_tpu/utils/func.py``).

Functions that take particles take parameter trees
(:mod:`dibs_tpu_torch.utils.tree`); a bare tensor is a one-leaf tree.
"""
from __future__ import annotations

import math

import torch

from dibs_tpu_torch.utils.tree import tree_leaves

__all__ = ["expand_by", "zero_diagonal", "pytree_sq_norm_matrix",
           "signed_logsumexp"]


def expand_by(arr: torch.Tensor, n: int) -> torch.Tensor:
    """Appends ``n`` singleton dimensions at the end of ``arr``."""
    if n == 0:
        return arr
    return arr.reshape(tuple(arr.shape) + (1,) * n)


def zero_diagonal(g: torch.Tensor) -> torch.Tensor:
    """Sets the diagonal of the trailing ``[d, d]`` block to zero (by an
    elementwise mask, as the reference does)."""
    d = g.shape[-1]
    mask = 1 - torch.eye(d, dtype=g.dtype, device=g.device)
    return g * mask


def pytree_sq_norm_matrix(xs, ys) -> torch.Tensor:
    """``[A, B]`` squared Frobenius distances between two particle batches
    (trees whose leaves have leading dims ``A`` and ``B``), summed over the
    leaves.

    Gram form ``||x||^2 + ||y||^2 - 2 x.y`` per leaf at full float32 (the
    caller keeps TF32 off), clamped at 0; when ``xs is ys`` and the result
    is square the self-distances are pinned to exactly 0, as in the
    reference.
    """
    total = 0.0
    for xl, yl in zip(tree_leaves(xs), tree_leaves(ys)):
        a = xl.reshape(xl.shape[0], -1)
        b = yl.reshape(yl.shape[0], -1)
        a_sq = (a * a).sum(-1)
        b_sq = (b * b).sum(-1)
        total = total + (a_sq[:, None] + b_sq[None, :] - 2.0 * (a @ b.T))
    total = torch.clamp(total, min=0.0)
    if xs is ys and total.shape[0] == total.shape[1]:
        total = total * (1.0 - torch.eye(total.shape[0], dtype=total.dtype,
                                         device=total.device))
    return total


def signed_logsumexp(a: torch.Tensor, b: torch.Tensor, dim: int):
    """``(log |sum b exp(a)|, sign)`` along ``dim``, as ``jax.scipy``'s
    ``logsumexp(a, b=b, return_sign=True)`` (torch's ``logsumexp`` has no
    ``b``): entries with ``b == 0`` are dropped, and an all-``-inf`` slice
    uses a 0 shift instead of ``-inf - -inf``."""
    a = torch.where(b != 0, a, torch.full_like(a, -math.inf))
    amax = a.amax(dim=dim, keepdim=True)
    amax = torch.where(torch.isfinite(amax), amax, torch.zeros_like(amax))
    sumexp = (torch.exp(a - amax) * b).sum(dim=dim)
    return torch.log(sumexp.abs()) + amax.squeeze(dim), torch.sign(sumexp)
