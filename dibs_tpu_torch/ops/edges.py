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
    "particle_to_soft_graph",
    "particle_to_hard_graph",
    "sample_g",
    "latent_log_prob",
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


def particle_to_soft_graph(z: torch.Tensor, eps: torch.Tensor, alpha,
                           tau) -> torch.Tensor:
    """Gumbel-softmax relaxed sample ``sigmoid(tau (eps + alpha s))`` with
    ``eps ~ Logistic(0, 1)`` broadcastable to ``[..., d, d]``."""
    return zero_diagonal(torch.sigmoid(tau * (eps + alpha * edge_scores(z))))


def particle_to_hard_graph(z: torch.Tensor, eps: torch.Tensor,
                           alpha) -> torch.Tensor:
    """Gumbel-max sample ``1[eps + alpha s > 0]`` (float32)."""
    return zero_diagonal(
        ((eps + alpha * edge_scores(z)) > 0.0).to(torch.float32))


def sample_g(p: torch.Tensor, generator: torch.Generator,
             n_samples: int) -> torch.Tensor:
    """``n_samples`` Bernoulli adjacency samples ``[n_samples, d, d]``
    (int32, zero diagonal) from the edge-probability matrix ``p [d, d]``;
    ``generator`` lives on ``p``'s device."""
    g = torch.bernoulli(p.expand(n_samples, *p.shape), generator=generator)
    return zero_diagonal(g.to(torch.int32))


def latent_log_prob(single_g: torch.Tensor, single_z: torch.Tensor,
                    alpha) -> torch.Tensor:
    """Bernoulli log-likelihood ``log p(G | Z)`` of one graph sample."""
    log_p, log_1_p = edge_log_probs(single_z, alpha)
    return (single_g * log_p + (1 - single_g) * log_1_p).sum()


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
