"""Posterior evaluation metrics against a ground-truth DAG (PyTorch twin of
``dibs_tpu/metrics.py``).

Cyclic-particle fallbacks as the reference: E-SHD and CPDAG-SHD ->
d(d-1)/2, AUROC -> 0.5, PRC/AP -> edge density, expected edges -> the
cyclic graphs' edges, held-out likelihoods -> the empty graph. Weighted
means over particles are signed log-sum-exps (``utils.func.
signed_logsumexp``, the counterpart of ``logsumexp(..., b=,
return_sign=True)``). Every metric returns a Python float.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from dibs_tpu_torch.ops import rocprc
from dibs_tpu_torch.ops.acyclic import elwise_acyclic_constr
from dibs_tpu_torch.ops.cpdag import (
    dag_to_cpdag,
    eltwise_dag_to_cpdag,
    pdag_shd,
)
from dibs_tpu_torch.utils.func import signed_logsumexp
from dibs_tpu_torch.utils.tree import tree_mul, tree_select

__all__ = [
    "ParticleDistribution",
    "pairwise_structural_hamming_distance",
    "expected_shd",
    "expected_cpdag_shd",
    "expected_edges",
    "threshold_metrics",
    "neg_ave_log_marginal_likelihood",
    "neg_ave_log_likelihood",
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


def _weighted_mean(log_weights, values):
    """``sum_i exp(log_w_i) values_i`` in signed log space, as a float."""
    lse, sign = signed_logsumexp(log_weights,
                                 values.to(log_weights.dtype), 0)
    return float(sign * torch.exp(lse))


def expected_cpdag_shd(*, dist: ParticleDistribution, g):
    """``E_p[SHD(CPDAG(G), CPDAG(G*))]`` over acyclic particles: charges
    nothing for orientations the equivalence class leaves free;
    ``d(d-1)/2`` if no particle is a DAG. Host-side numpy CPDAGs."""
    n_vars = g.shape[0]
    is_dag = _dag_filter(dist, n_vars)
    if int(is_dag.sum()) == 0:
        return n_vars * (n_vars - 1) / 2
    shds = pdag_shd(eltwise_dag_to_cpdag(dist.g[is_dag]),
                    dag_to_cpdag(g)[None])
    log_w = _dag_log_weights(dist, is_dag)
    return _weighted_mean(log_w, torch.as_tensor(shds, device=log_w.device))


def expected_edges(*, dist: ParticleDistribution):
    """``E_p[|edges(G)|]`` over acyclic particles; if none is a DAG, the
    (unnormalized) weighted edge count of all of them, as the reference."""
    n_vars = dist.g.shape[-1]
    is_dag = _dag_filter(dist, n_vars)
    if int(is_dag.sum()) == 0:
        return _weighted_mean(dist.logp, dist.g.sum(dim=(-1, -2)))
    return _weighted_mean(_dag_log_weights(dist, is_dag),
                          dist.g[is_dag].sum(dim=(-1, -2)))


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


def neg_ave_log_marginal_likelihood(*, dist: ParticleDistribution,
                                    eltwise_log_marginal_likelihood, x):
    """``- E_{p(G|D)}[log p(D_test | G)]`` over acyclic particles, with
    ``eltwise_log_marginal_likelihood(gs [n, d, d], x) -> [n]`` (e.g.
    ``MarginalDiBS.eltwise_log_marginal_likelihood_observ``); the empty
    graph with weight 1 if no particle is a DAG."""
    n_vars = x.shape[-1]
    is_dag = _dag_filter(dist, n_vars)
    if int(is_dag.sum()) == 0:
        g = torch.zeros((1, n_vars, n_vars), dtype=dist.g.dtype,
                        device=dist.g.device)
        log_w = torch.zeros(1, dtype=dist.logp.dtype, device=dist.logp.device)
    else:
        g = dist.g[is_dag]
        log_w = _dag_log_weights(dist, is_dag)
    return -_weighted_mean(log_w, eltwise_log_marginal_likelihood(g, x))


def neg_ave_log_likelihood(*, dist: ParticleDistribution,
                           eltwise_log_likelihood, x):
    """``- E_{p(G,Theta|D)}[log p(D_test | G, Theta)]`` over acyclic
    particles, with ``eltwise_log_likelihood(gs [n, d, d], thetas, x) ->
    [n]`` and ``dist.theta`` a parameter tree (``utils.tree``) with leading
    particle dims (e.g. ``JointDiBS.eltwise_log_likelihood_observ``). If no
    particle is a DAG, every particle's graph and parameters are zeroed and
    weighted 1, as the reference."""
    if dist.theta is None:
        raise ValueError("neg_ave_log_likelihood needs dist.theta")
    n_vars = x.shape[-1]
    is_dag = _dag_filter(dist, n_vars)
    if int(is_dag.sum()) == 0:
        g = dist.g * 0
        theta = tree_mul(dist.theta, 0.0)
        log_w = dist.logp * 0.0
    else:
        g = dist.g[is_dag]
        theta = tree_select(dist.theta, is_dag)
        log_w = _dag_log_weights(dist, is_dag)
    return -_weighted_mean(log_w, eltwise_log_likelihood(g, theta, x))
