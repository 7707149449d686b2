"""Masked positive-definite log-determinants (PyTorch twin of
``dibs_tpu/ops/logdet.py``).

:func:`masked_logdet_pd` is the log-determinant of a (possibly soft-)masked
submatrix of a PD matrix, by unpivoted elimination up to d = 64 and by
Cholesky past it, as the reference; its backward is the reference's closed
form ``d logdet(A) / dA = A^{-1}`` chained through the mask, not autograd
through the factorisation. :func:`batched_masked_logdet_pd` takes one
matrix and ``[B, d]`` masks.

:func:`masked_logdet_pd_pair` returns the two BGe determinants
``(logdet R[Pa, Pa], logdet R[Pa u j, Pa u j])`` by the reference's tiers:
node ``j`` permuted last and one unpivoted elimination for ``d <= 32``, two
eliminations for ``32 < d <= 64``, one Cholesky of the permuted matrix past
that (forward only). It is independent of the BGe kernel's bordered sweep
(:mod:`dibs_tpu_torch.ops.bge_kernel`), and the tests hold that kernel's
plain twin against it. Batched over leading dims.
"""
from __future__ import annotations

import torch

from dibs_tpu_torch.utils.func import _masked_submatrix as _masked_matrix

__all__ = ["masked_logdet_pd", "batched_masked_logdet_pd",
           "masked_logdet_pd_pair"]

_GE_MAX_D = 64


def _ge_logdets(a):
    """``(logdet of leading (d-1) block, logdet)`` by unpivoted elimination."""
    d = a.shape[-1]
    idx = torch.arange(d, device=a.device)
    acc = torch.zeros(a.shape[:-2], dtype=a.dtype, device=a.device)
    acc_lead = acc
    for i in range(d):
        pivot = a[..., i, i]
        col = a[..., :, i] / pivot[..., None]
        upd = col[..., :, None] * a[..., i, None, :]
        trailing = (idx[:, None] > i) & (idx[None, :] > i)
        a = torch.where(trailing, a - upd, a)
        log_p = torch.log(pivot)
        acc = acc + log_p
        if i < d - 1:
            acc_lead = acc_lead + log_p
    return acc_lead, acc


def _sum_to(t, shape):
    """``t`` summed over the dims broadcasting added to ``shape``."""
    lead = t.dim() - len(shape)
    t = t.sum(dim=tuple(range(lead))) if lead else t
    dims = tuple(i for i, n in enumerate(shape) if n == 1 and t.shape[i] != 1)
    return t.sum(dim=dims, keepdim=True) if dims else t


class _MaskedLogdetPD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, m, mask):
        a = _masked_matrix(m, mask)
        if a.shape[-1] <= _GE_MAX_D:
            out = _ge_logdets(a)[1]
        else:
            chol = torch.linalg.cholesky(a)
            out = 2.0 * torch.log(torch.diagonal(chol, dim1=-2,
                                                 dim2=-1)).sum(-1)
        ctx.save_for_backward(m, mask)
        return out

    @staticmethod
    def backward(ctx, g):
        m, mask = ctx.saved_tensors
        # d logdet(A) / dA = A^{-1}; chain through A = s s^T M + (I - s s^T I)
        inv = torch.linalg.inv(_masked_matrix(m, mask))
        outer = mask[..., :, None] * mask[..., None, :]
        g2 = g[..., None, None]
        d_m = g2 * outer * inv
        eye = torch.eye(m.shape[-1], dtype=m.dtype, device=m.device)
        d_mask = g[..., None] * 2.0 * (inv * (m - eye)
                                       * mask[..., None, :]).sum(-1)
        return _sum_to(d_m, m.shape), _sum_to(d_mask, mask.shape)


def masked_logdet_pd(m: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Log-determinant of the (possibly soft-)masked submatrix of PD ``m``
    ``[..., d, d]`` selected by ``mask [..., d]`` (leading dims broadcast),
    with the closed-form backward."""
    return _MaskedLogdetPD.apply(m, mask)


def batched_masked_logdet_pd(m: torch.Tensor,
                             masks: torch.Tensor) -> torch.Tensor:
    """One PD ``[d, d]`` matrix, ``[B, d]`` masks -> ``[B]``."""
    return masked_logdet_pd(m, masks)


def _j_last(m, mask_full, e_j):
    d = e_j.shape[-1]
    idx = torch.arange(d, device=e_j.device).expand(e_j.shape)
    key = torch.where(e_j > 0.5, torch.full_like(idx, d), idx)
    perm = torch.argsort(key, dim=-1, stable=True)
    m_p = torch.take_along_dim(m, perm[..., :, None], dim=-2)
    m_p = torch.take_along_dim(m_p, perm[..., None, :], dim=-1)
    return m_p, torch.take_along_dim(mask_full, perm, dim=-1)


def masked_logdet_pd_pair(m: torch.Tensor, parents: torch.Tensor,
                          e_j: torch.Tensor):
    """``(logdet R[Pa, Pa], logdet R[Pa u j, Pa u j])`` for PD ``m``
    ``[..., d, d]``, parent mask ``parents [..., d]`` (``parents[j] == 0``)
    and the one-hot ``e_j [..., d]`` of node ``j``."""
    d = parents.shape[-1]
    batch = torch.broadcast_shapes(m.shape[:-2], parents.shape[:-1],
                                   e_j.shape[:-1])
    m = m.expand(batch + (d, d))
    parents = parents.expand(batch + (d,))
    e_j = e_j.expand(batch + (d,))
    mask_full = parents + e_j
    if d > _GE_MAX_D:
        m_p, mask_p = _j_last(m, mask_full, e_j)
        chol = torch.linalg.cholesky(_masked_matrix(m_p, mask_p))
        log_diag = torch.log(torch.diagonal(chol, dim1=-2, dim2=-1))
        lead = 2.0 * log_diag[..., : d - 1].sum(-1)
        return lead, lead + 2.0 * log_diag[..., d - 1]
    if d > 32:
        return (_ge_logdets(_masked_matrix(m, parents))[1],
                _ge_logdets(_masked_matrix(m, mask_full))[1])
    m_p, mask_p = _j_last(m, mask_full, e_j)
    return _ge_logdets(_masked_matrix(m_p, mask_p))
