"""Posterior evaluation metrics against a ground-truth DAG (PyTorch twin of
the reference's ``metrics.py``, trimmed to what the port's smoke run reads:
``ParticleDistribution``, ``expected_shd`` and ``threshold_metrics``).

Cyclic-particle fallbacks as the reference: E-SHD -> d(d-1)/2, AUROC -> 0.5.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from dibs_tpu_torch.ops import rocprc
from dibs_tpu_torch.ops.acyclic import elwise_acyclic_constr
from dibs_tpu_torch.utils.func import signed_logsumexp

__all__ = [
    "ParticleDistribution",
    "pairwise_structural_hamming_distance",
    "expected_shd",
    "threshold_metrics",
]


class ParticleDistribution(NamedTuple):
    """Sampled particles ``(G[, Theta])`` with their log-weights ``[M]``."""

    logp: Any
    g: Any
    theta: Any = None


def pairwise_structural_hamming_distance(*, x, y):
    """Pairwise SHD matrix ``[N, M]``; a reversal counts once."""
    pw_diff = torch.abs(x[:, None] - y[None, :])
    pw_diff = pw_diff + pw_diff.transpose(-1, -2)
    pw_diff = torch.clamp(pw_diff, max=1)
    return pw_diff.sum(dim=(-2, -1)) / 2


def _dag_filter(dist: ParticleDistribution, n_vars: int):
    return elwise_acyclic_constr(dist.g.to(torch.float32), n_vars) == 0


def _dag_log_weights(dist, is_dag):
    logp = dist.logp[is_dag]
    return logp - torch.logsumexp(logp, dim=0)


def expected_shd(*, dist: ParticleDistribution, g):
    """``E_p[SHD(G, G*)]`` over acyclic particles; ``d(d-1)/2`` if none."""
    n_vars = g.shape[0]
    is_dag = _dag_filter(dist, n_vars)
    if int(is_dag.sum()) == 0:
        return n_vars * (n_vars - 1) / 2
    particles = dist.g[is_dag]
    shds = pairwise_structural_hamming_distance(
        x=particles.to(torch.float32), y=g[None].to(torch.float32))[:, 0]
    lse, sign = signed_logsumexp(_dag_log_weights(dist, is_dag), shds, 0)
    return float(sign * torch.exp(lse))


def threshold_metrics(*, dist: ParticleDistribution, g):
    """ROC / precision-recall metrics of the weighted edge-belief matrix."""
    n_vars = g.shape[0]
    g_flat = g.detach().cpu().numpy().reshape(-1)
    is_dag = _dag_filter(dist, n_vars)
    if int(is_dag.sum()) == 0:
        density = float(g.sum() / (n_vars * (n_vars - 1)))
        return {"roc_auc": 0.5, "prc_auc": density, "ave_prec": density}
    particles = dist.g[is_dag].to(torch.float32)
    log_w = _dag_log_weights(dist, is_dag)
    log_belief, sign = signed_logsumexp(log_w[:, None, None], particles, 0)
    p_edge = (sign * torch.exp(log_belief)).detach().cpu().numpy().reshape(-1)

    fpr, tpr, _ = rocprc.roc_curve(g_flat, p_edge)
    precision, recall, _ = rocprc.precision_recall_curve(g_flat, p_edge)
    return {
        "fpr": fpr.tolist(),
        "tpr": tpr.tolist(),
        "roc_auc": rocprc.auc(fpr, tpr),
        "precision": precision.tolist(),
        "recall": recall.tolist(),
        "prc_auc": rocprc.auc(recall, precision),
        "ave_prec": rocprc.average_precision_score(g_flat, p_edge),
    }

