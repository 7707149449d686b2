"""DiBS gradient estimators for marginal inference (PyTorch twin of
``dibs_tpu/inference/estimators.py``: ``score``, ``score_rb`` and the
latent-prior score; the reparameterization, Theta and fused estimators wait
for the joint slice).

Every estimator works on the whole particle batch at once. Graph samples
come from the Gumbel sampler kernel (:mod:`dibs_tpu_torch.ops.soft_graphs`)
with noise from the counter-based stream (``seed``, ``stream``) or an
injected Logistic ``eps``. The likelihood estimators score all ``P * M``
hard samples in one call of the model's batched per-node hook (BGe: the
determinant-pair kernel).

Estimator maths (as the reference): the self-normalized ratio

    grad log E_{p(G|Z)}[p(D | G)] = E[p(D|G) grad log p(G|Z)] / E[p(D|G)]

with the same MC samples in numerator and denominator, in signed log space.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import torch

from dibs_tpu_torch.ops.acyclic import acyclic_constr
from dibs_tpu_torch.ops.edges import (
    edge_probs,
    edge_scores,
    grad_latent_log_prob_batch,
)
from dibs_tpu_torch.ops.soft_graphs import sample_hard_graphs, sample_soft_graphs
from dibs_tpu_torch.utils.func import expand_by, signed_logsumexp

__all__ = ["EstimatorConfig", "Estimators", "make_estimators",
           "stable_ratio_grad"]


@dataclasses.dataclass(frozen=True)
class EstimatorConfig:
    """Static hyperparameters of the DiBS gradient estimators (fields and
    defaults as in the reference)."""

    alpha_linear: float = 0.05
    beta_linear: float = 1.0
    tau: float = 1.0
    n_grad_mc_samples: int = 128
    n_acyclicity_mc_samples: int = 32
    grad_estimator_z: str = "score"  # 'score' | 'score_rb'
    score_function_baseline: float = 0.0
    latent_prior_std: Optional[float] = None
    acyclicity: str = "notears"
    acyclicity_constraint: str = "sampled"  # 'sampled' | 'mean'

    def alpha(self, t):
        """Linear inverse-temperature schedule of the edge-prob sigmoid."""
        return self.alpha_linear * t

    def beta(self, t):
        """Linear schedule of the acyclicity-penalty weight."""
        return self.beta_linear * t


class Estimators(NamedTuple):
    """Batched (over particles) estimator callables."""

    eltwise_grad_z_likelihood: Callable
    eltwise_grad_latent_prior: Callable


def stable_ratio_grad(log_num: torch.Tensor, log_den: torch.Tensor,
                      grads: torch.Tensor) -> torch.Tensor:
    """Self-normalized MC ratio ``E[w grad] / E[w]`` in signed log space.

    Args:
        log_num: ``[..., M]`` numerator log-weights
        log_den: ``[..., M]`` denominator log-weights
        grads: ``[..., M, *rest]``

    Returns:
        ``[..., *rest]``. A zero numerator gives 0, also where the
        denominator is empty (``-inf``).
    """
    dim = log_num.dim() - 1
    extra = grads.dim() - log_num.dim()
    log_z = torch.logsumexp(log_den, dim=-1)
    lse, sign = signed_logsumexp(expand_by(log_num, extra), grads, dim)
    ratio = sign * torch.exp(lse - expand_by(log_z, extra))
    return torch.where(sign == 0, torch.zeros_like(ratio), ratio)


def make_estimators(*, cfg: EstimatorConfig, log_graph_prior: Callable,
                    batched_node_log_joint_prob: Callable, x: torch.Tensor,
                    interv_mask: torch.Tensor) -> Estimators:
    """Builds the batched estimator callables for fixed data and models.

    Args:
        cfg: static estimator hyperparameters
        log_graph_prior: ``soft_g [..., d, d] -> [...]`` graph-prior
            log-density on edge probabilities (autograd-differentiable)
        batched_node_log_joint_prob: ``(gs [B, d, d], theta, x, interv_mask,
            rng) -> [B, d]`` per-node scores (row sums are the graphs'
            marginal log-likelihoods)
        x: ``[N, d]`` observations
        interv_mask: ``[N, d]`` intervention indicators
    """
    if cfg.grad_estimator_z not in ("score", "score_rb"):
        raise ValueError(
            f"Unknown gradient estimator `{cfg.grad_estimator_z}` (the port "
            "serves 'score' and 'score_rb')")
    if cfg.grad_estimator_z == "score_rb" and cfg.score_function_baseline > 0.0:
        raise ValueError(
            "score_function_baseline > 0 has no effect with "
            "grad_estimator_z='score_rb'. Set score_function_baseline=0.")
    if cfg.acyclicity != "notears":
        raise NotImplementedError(
            f"acyclicity={cfg.acyclicity!r} is not ported yet; use 'notears'")
    if cfg.acyclicity_constraint not in ("sampled", "mean"):
        raise ValueError(
            f"acyclicity_constraint must be 'sampled' or 'mean'; got "
            f"{cfg.acyclicity_constraint!r}")
    n_mc = cfg.n_grad_mc_samples

    def _hard_samples(zs, t, seed, stream, eps):
        return sample_hard_graphs(edge_scores(zs), seed, stream, cfg.alpha(t),
                                  n_mc, eps=eps)

    def _node_scores(g_all):
        p_n, m_n, d_n = g_all.shape[:3]
        return batched_node_log_joint_prob(
            g_all.reshape(p_n * m_n, d_n, d_n), None, x, interv_mask, None,
        ).reshape(p_n, m_n, d_n)

    # --- REINFORCE with the signed linear-space EMA control variate ---

    def eltwise_grad_z_score(zs, baselines, t, seed, stream, eps=None):
        alpha = cfg.alpha(t)
        g_all = _hard_samples(zs, t, seed, stream, eps)  # [P, M, d, d]
        # float64 sum: exact for d float32 terms, so the same on any device
        logprobs = _node_scores(g_all).double().sum(-1).float()  # [P, M]
        grad_z = grad_latent_log_prob_batch(g_all, zs, alpha)
        c = cfg.score_function_baseline
        if c > 0.0:
            # numerator weights w_m = p_m - exp(b), b the log-space EMA of
            # the mean log-likelihood (-inf = off); the reference's
            # deliberate divergence from the paper's log-space form
            b = baselines[:, None]
            m = torch.maximum(logprobs, b)
            log_w = m + torch.log(
                torch.abs(torch.exp(logprobs - m) - torch.exp(b - m)))
            sign_w = torch.sign(logprobs - b)
            grad_est = stable_ratio_grad(
                log_w, logprobs, expand_by(sign_w, 3) * grad_z)
            new_baselines = torch.logaddexp(
                math.log(c) + logprobs.mean(1),
                math.log(1 - c) + baselines)
            return grad_est, new_baselines
        return stable_ratio_grad(logprobs, logprobs, grad_z), baselines

    # --- per-node Rao-Blackwellized REINFORCE ---

    def eltwise_grad_z_score_rb(zs, baselines, t, seed, stream, eps=None):
        alpha = cfg.alpha(t)
        g_all = _hard_samples(zs, t, seed, stream, eps)
        node_scores = _node_scores(g_all)  # [P, M, d]
        p = edge_probs(zs, alpha)
        w = torch.exp(node_scores
                      - torch.logsumexp(node_scores, dim=1, keepdim=True))
        g_bar = torch.einsum("pmij,pmj->pij", g_all, w)
        resid = alpha * (g_bar - p)  # diagonals of g_bar and p are both 0
        u, v = zs[..., 0], zs[..., 1]
        du = resid @ v
        dv = resid.transpose(-1, -2) @ u
        return torch.stack([du, dv], dim=-1), baselines

    # --- latent prior score ---

    def eltwise_grad_latent_prior(zs, t, seed, stream, latent_prior_std,
                                  eps=None):
        """``-beta(t) E[grad h] - Z / sigma_z^2 + grad log f(Z)``, with the
        acyclicity term from ``n_acyclicity_mc_samples`` soft samples
        (``'sampled'``) or from the edge probabilities (``'mean'``)."""
        alpha = cfg.alpha(t)
        with torch.enable_grad():
            z_req = zs.detach().requires_grad_(True)
            prior = log_graph_prior(soft_g=edge_probs(z_req, alpha)).sum()
            (grad_prior_z,) = torch.autograd.grad(prior, z_req)

            z_req = zs.detach().requires_grad_(True)
            if cfg.acyclicity_constraint == "mean":
                h_vals = acyclic_constr(edge_probs(z_req, alpha))  # [P]
                cot = torch.ones_like(h_vals)
            else:
                k = cfg.n_acyclicity_mc_samples
                gs = sample_soft_graphs(edge_scores(z_req), seed, stream,
                                        alpha, cfg.tau, k, eps=eps)
                h_vals = acyclic_constr(gs)  # [P, K]
                cot = torch.full_like(h_vals, 1.0 / k)
            (grad_constraint,) = torch.autograd.grad(h_vals, z_req, cot)
        return (-cfg.beta(t) * grad_constraint
                - zs / (latent_prior_std ** 2.0)
                + grad_prior_z)

    grad_z = {"score": eltwise_grad_z_score,
              "score_rb": eltwise_grad_z_score_rb}[cfg.grad_estimator_z]
    return Estimators(eltwise_grad_z_likelihood=grad_z,
                      eltwise_grad_latent_prior=eltwise_grad_latent_prior)
