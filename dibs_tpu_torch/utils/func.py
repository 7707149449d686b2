"""Primitive tensor utilities (PyTorch twin of ``dibs_tpu/utils/func.py``).

Functions that take particles take parameter trees
(:mod:`dibs_tpu_torch.utils.tree`); a bare tensor is a one-leaf tree.
"""
from __future__ import annotations

import math

import torch

from dibs_tpu_torch.utils.tree import tree_leaves

__all__ = ["expand_by", "zero_diagonal", "squared_norm_pytree",
           "pytree_sq_norm_matrix", "masked_logdet_pd", "masked_slogdet",
           "standardize", "signed_logsumexp"]


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


def squared_norm_pytree(x, y) -> torch.Tensor:
    """``||x - y||^2`` summed over the leaves of two trees."""
    return sum(torch.sum(torch.square(a - b))
               for a, b in zip(tree_leaves(x), tree_leaves(y)))


def pytree_sq_norm_matrix(xs, ys) -> torch.Tensor:
    """``[A, B]`` squared Frobenius distances between two particle batches
    (trees whose leaves have leading dims ``A`` and ``B``), summed over the
    leaves.

    Gram form ``||x||^2 + ||y||^2 - 2 x.y`` per leaf at full float32 (the
    caller keeps TF32 off), clamped at 0; when ``xs is ys`` and the result
    is square the self-distances are pinned to exactly 0, as in the
    reference.
    """
    return batched_sq_norm_matrix(xs, ys, 0)


def batched_sq_norm_matrix(xs, ys, batch_dims: int) -> torch.Tensor:
    """:func:`pytree_sq_norm_matrix` with ``batch_dims`` leading axes before
    the particles (a fleet's datasets): one ``[A, B]`` matrix per index of
    those axes."""
    total = 0.0
    for xl, yl in zip(tree_leaves(xs), tree_leaves(ys)):
        a = xl.reshape(*xl.shape[:batch_dims + 1], -1)
        b = yl.reshape(*yl.shape[:batch_dims + 1], -1)
        a_sq = (a * a).sum(-1)
        b_sq = (b * b).sum(-1)
        total = total + (a_sq[..., :, None] + b_sq[..., None, :]
                         - 2.0 * (a @ b.transpose(-1, -2)))
    total = torch.clamp(total, min=0.0)
    if xs is ys and total.shape[-2] == total.shape[-1]:
        total = total * (1.0 - torch.eye(total.shape[-1], dtype=total.dtype,
                                         device=total.device))
    return total


def _masked_submatrix(m, mask):
    """``s s^T * M + (I - s s^T * I)``: the masked submatrix padded by the
    identity, positive definite for PD ``M`` and ``s`` in ``[0, 1]``."""
    d = mask.shape[-1]
    outer = mask[..., :, None] * mask[..., None, :]
    eye = torch.eye(d, dtype=m.dtype, device=m.device)
    return outer * m + (1.0 - outer) * eye


def masked_logdet_pd(m: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Log-determinant of the (possibly soft-)masked submatrix of a
    positive-definite ``m`` by Cholesky (the reference implementation;
    :func:`dibs_tpu_torch.ops.logdet.masked_logdet_pd` carries the closed-
    form backward). Batched over leading dims."""
    chol = torch.linalg.cholesky(_masked_submatrix(m, mask))
    return 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)


def masked_slogdet(m: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``log |det|`` of the submatrix of ``m [..., d, d]`` selected by the
    (possibly soft) ``mask [..., d]``, the rest replaced by the identity, so
    that it stays differentiable for soft masks."""
    return torch.linalg.slogdet(_masked_submatrix(m, mask))[1]


def standardize(x: torch.Tensor, *, return_stats: bool = False, eps=1e-8):
    """Column-standardized observations ``(x - mean) / std`` (population
    std, bounded below by ``eps``), and ``(mean, std)`` with
    ``return_stats=True``: apply the same stats to held-out data."""
    mu = x.mean(dim=0)
    sd = torch.clamp(x.std(dim=0, correction=0), min=eps)
    x_std = (x - mu) / sd
    return (x_std, (mu, sd)) if return_stats else x_std


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
