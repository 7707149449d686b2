"""Latent-embedding edge operations: ``Z -> (scores, probs, graphs)``.

PyTorch twin of ``dibs_tpu/ops/edges.py``. ``Z`` is ``[..., d, k, 2]`` with
``U = Z[..., 0]`` and ``V = Z[..., 1]``; the edge score ``s_ij = u_i . v_j``
is one batched matmul. Every op masks the diagonal.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from dibs_tpu_torch.utils.func import zero_diagonal

__all__ = [
    "edge_scores",
    "edge_probs",
    "edge_log_probs",
    "particle_to_g_lim",
    "grad_latent_log_prob_batch",
]


def edge_scores(z: torch.Tensor) -> torch.Tensor:
    """Raw edge scores ``s_ij = u_i . v_j`` of shape ``[..., d, d]``."""
    return torch.matmul(z[..., 0], z[..., 1].transpose(-1, -2))


def edge_probs(z: torch.Tensor, alpha) -> torch.Tensor:
    """Edge probabilities ``sigmoid(alpha * s_ij)``, diagonal-masked."""
    return zero_diagonal(torch.sigmoid(alpha * edge_scores(z)))


def edge_log_probs(z: torch.Tensor, alpha):
    """``(log p_ij, log (1 - p_ij))`` as a log-sigmoid pair; the diagonal of
    both is zeroed (consumers multiply by diagonal-free graphs)."""
    s = alpha * edge_scores(z)
    return zero_diagonal(F.logsigmoid(s)), zero_diagonal(F.logsigmoid(-s))


def particle_to_g_lim(z: torch.Tensor) -> torch.Tensor:
    """Hard graph in the ``alpha -> inf`` limit: ``1[u_i . v_j > 0]`` (int32)."""
    return zero_diagonal((edge_scores(z) > 0).to(torch.int32))


def grad_latent_log_prob_batch(gs: torch.Tensor, z: torch.Tensor,
                               alpha) -> torch.Tensor:
    """Closed-form ``grad_Z log p(G | Z)`` for a batch of graph samples.

    With ``r_ij = alpha (g_ij - p_ij)`` off the diagonal,
    ``grad_u_i = sum_j r_ij v_j`` and ``grad_v_j = sum_i r_ij u_i``.

    Args:
        gs: ``[..., M, d, d]`` graph samples
        z: ``[..., d, k, 2]`` (leading dims match those of ``gs``)
        alpha: edge-prob inverse temperature

    Returns:
        ``[..., M, d, k, 2]``
    """
    u, v = z[..., 0], z[..., 1]
    p = edge_probs(z, alpha)
    resid = zero_diagonal(alpha * (gs - p.unsqueeze(-3)))  # [..., M, d, d]
    grad_u = torch.matmul(resid, v.unsqueeze(-3))
    grad_v = torch.matmul(resid.transpose(-1, -2), u.unsqueeze(-3))
    return torch.stack([grad_u, grad_v], dim=-1)
