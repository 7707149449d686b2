"""DiBS gradient estimators (PyTorch twin of
``dibs_tpu/inference/estimators.py``): the REINFORCE ``score`` and
``score_rb`` estimators of marginal inference, the reparameterization and
Theta estimators of joint inference, the shared-noise and fused linear-
Gaussian joint estimators, and the latent-prior score.

Every estimator works on the whole particle batch at once. Graph samples
come from the Gumbel sampler kernel (:mod:`dibs_tpu_torch.ops.soft_graphs`)
with noise from the counter-based stream (``seed``, ``stream``) or an
injected Logistic ``eps``. The REINFORCE estimators score all ``P * M``
hard samples in one call of the model's batched per-node hook (BGe: the
determinant-pair kernel). The reparameterization and Theta estimators are
one autograd call each: with shared samples the self-normalized ratio is a
softmax-weighted sum of per-sample gradients, so the softmax weights are
the cotangents. ``Theta`` is a parameter tree (:mod:`dibs_tpu_torch.utils.
tree`): a ``[P, d, d]`` tensor for ``LinearGaussian``, ``[(W1, b1), (W2,
b2), ...]`` with leading particle dims for ``DenseNonlinearGaussian``. With
the reparameterization estimator, ``fused_grad_both`` computes both
likelihood gradients in the fused kernels of :mod:`dibs_tpu_torch.inference.
fused_linear` (``LinearGaussian``) or :mod:`dibs_tpu_torch.inference.
fused_nonlinear` (one-hidden-layer ``DenseNonlinearGaussian``).

Estimator maths (as the reference): the self-normalized ratio

    grad log E_{p(G|Z)}[p(D | G)] = E[p(D|G) grad log p(G|Z)] / E[p(D|G)]

with the same MC samples in numerator and denominator, in signed log space.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Callable, NamedTuple, Optional

import torch

from dibs_tpu_torch.inference.fused_linear import (
    fused_linear_available,
    fused_linear_estimators,
)
from dibs_tpu_torch.inference.fused_nonlinear import (
    fused_nonlinear_decline_reason,
    fused_nonlinear_estimators,
)
from dibs_tpu_torch.ops.acyclic import (
    acyclic_constr,
    acyclic_constr_spectral,
)
from dibs_tpu_torch.ops.edges import (
    edge_probs,
    edge_scores,
    grad_latent_log_prob_batch,
)
from dibs_tpu_torch.ops.soft_graphs import sample_hard_graphs, sample_soft_graphs
from dibs_tpu_torch.utils.func import expand_by, signed_logsumexp, zero_diagonal
from dibs_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

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
    grad_estimator_z: str = "score"  # 'score' | 'score_rb' | 'reparam'
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
    """Batched (over particles) estimator callables.

    ``fused_grad_both(zs, thetas, t, seed, streams, eps=None) -> (dz,
    dtheta)`` is set when one call computes both likelihood gradients of
    joint inference (``streams = (soft, hard)``, ``eps = (eps_soft,
    eps_hard)``); the engine then prefers it.
    """

    eltwise_grad_z_likelihood: Callable
    eltwise_grad_latent_prior: Callable
    eltwise_grad_theta_likelihood: Optional[Callable] = None
    fused_grad_both: Optional[Callable] = None


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


def _chain_scores(dscores, zs):
    """``d scores -> dZ``: ``dU = dS V``, ``dV = dS^T U``."""
    u, v = zs[..., 0], zs[..., 1]
    return torch.stack([dscores @ v, dscores.transpose(-1, -2) @ u], dim=-1)


def _warn_on_data_scale(x, obs_noise):
    """Advisory, for the MLP model only: estimates the per-sample
    ``|log-likelihood| ~ N sum_j E[x_j^2] / (2 sigma^2)`` and warns from 1e6
    up. The fused kernel is scale-safe (centred scoring); the warning is
    about the model: ``N(0, sig_param^2)`` weight priors recover structure
    on data this large only if the process really lives at that scale
    (rescaled, unstandardized data is the usual cause). Changes no path."""
    est = float(x.shape[0] * torch.square(x).mean(0).sum()
                / (2.0 * float(obs_noise)))
    if est > 1.0e6:
        warnings.warn(
            f"data scale puts |log-likelihood| ~ {est:.1e} per sample. If x "
            "was rescaled or arrives unstandardized (rather than naturally "
            "living at this scale), the nonlinear model's N(0, "
            "sig_param^2) weight priors make structure recovery unreliable "
            "regardless of estimator; standardizing x is the usual "
            "practice.", stacklevel=4)


def make_estimators(*, cfg: EstimatorConfig, log_graph_prior: Callable,
                    x: torch.Tensor, interv_mask: torch.Tensor,
                    batched_node_log_joint_prob: Optional[Callable] = None,
                    log_joint_prob: Optional[Callable] = None,
                    fused_linear_model=None,
                    fused_nonlinear_model=None,
                    fused_sample_sharing: Optional[str] = None,
                    fused_single_pass: bool = True) -> Estimators:
    """Builds the batched estimator callables for fixed data and models.

    Args:
        cfg: static estimator hyperparameters
        log_graph_prior: ``soft_g [..., d, d] -> [...]`` graph-prior
            log-density on edge probabilities (autograd-differentiable)
        x: ``[N, d]`` observations
        interv_mask: ``[N, d]`` intervention indicators
        batched_node_log_joint_prob: ``(gs [B, d, d], theta, x, interv_mask,
            rng) -> [B, d]`` per-node scores (row sums are the graphs'
            marginal log-likelihoods); the ``score`` / ``score_rb`` hook
        log_joint_prob: ``(gs [..., d, d], thetas, x, interv_mask, rng) ->
            [...]`` joint log-probability, broadcasting the graphs' leading
            dims against the parameter tree's and autograd-differentiable;
            the hook of the ``reparam`` and Theta estimators
        fused_linear_model: a :class:`~dibs_tpu_torch.models.LinearGaussian`
            enables the fused kernels (reparam estimator only) wherever
            :func:`fused_linear_available` serves ``(d, N)``
        fused_nonlinear_model: a :class:`~dibs_tpu_torch.models.
            DenseNonlinearGaussian` enables kernel #8 (reparam estimator
            only) wherever :func:`fused_nonlinear_available` serves it;
            elsewhere the engine warns with the reason and takes the
            generic estimators
        fused_sample_sharing: ``'hard'`` draws one noise batch for both joint
            likelihood gradients: the Theta estimator scores the Gumbel-max
            thresholds of the Z estimator's soft samples; ``None`` keeps
            separate streams
        fused_single_pass: the one-pass fused kernel (online softmax);
            ``False`` runs the two-pass kernels (log-likelihoods, softmax in
            PyTorch, weighted replay), as the reference's
            ``single_pass=False``
    """
    if cfg.grad_estimator_z not in ("score", "score_rb", "reparam"):
        raise ValueError(
            f"Unknown gradient estimator `{cfg.grad_estimator_z}` (the port "
            "serves 'score', 'score_rb' and 'reparam')")
    if cfg.grad_estimator_z == "score_rb" and cfg.score_function_baseline > 0.0:
        raise ValueError(
            "score_function_baseline > 0 has no effect with "
            "grad_estimator_z='score_rb'. Set score_function_baseline=0.")
    if cfg.acyclicity not in ("notears", "spectral"):
        raise ValueError(f"acyclicity must be 'notears' or 'spectral'; got "
                         f"{cfg.acyclicity!r}")
    if cfg.acyclicity_constraint not in ("sampled", "mean"):
        raise ValueError(
            f"acyclicity_constraint must be 'sampled' or 'mean'; got "
            f"{cfg.acyclicity_constraint!r}")
    if fused_sample_sharing not in (None, "hard"):
        raise ValueError(f"fused_sample_sharing must be None or 'hard'; got "
                         f"{fused_sample_sharing!r}")
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

    def eltwise_grad_z_score(zs, thetas, baselines, t, seed, stream,
                             eps=None):
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

    def eltwise_grad_z_score_rb(zs, thetas, baselines, t, seed, stream,
                                eps=None):
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

    # --- joint: softmax-weighted per-sample gradients, one autograd call ---

    def _weighted_grad(logp, wrt):
        """``sum_m softmax(logp)_m grad logp_m`` per particle; ``wrt`` is a
        tensor or a parameter tree."""
        weights = torch.softmax(logp.detach(), dim=1)
        grads = torch.autograd.grad(logp, tree_leaves(wrt), weights)
        return tree_unflatten(wrt, grads)

    def _log_joint(gs, thetas):
        # [P, M, d, d] graphs with the particle's parameters -> [P, M]
        return log_joint_prob(gs, tree_map(lambda leaf: leaf[:, None], thetas),
                              x, interv_mask, None)

    def _requires_grad(thetas):
        return tree_map(lambda leaf: leaf.detach().requires_grad_(True),
                        thetas)

    def eltwise_grad_z_reparam(zs, thetas, baselines, t, seed, stream,
                               eps=None):
        """Gumbel-softmax reparameterization estimator of the Z score."""
        with torch.enable_grad():
            z_req = zs.detach().requires_grad_(True)
            gs = sample_soft_graphs(edge_scores(z_req), seed, stream,
                                    cfg.alpha(t), cfg.tau, n_mc, eps=eps)
            return _weighted_grad(_log_joint(gs, thetas), z_req), baselines

    def eltwise_grad_theta_likelihood(zs, thetas, t, seed, stream, eps=None):
        """Theta score from ``M`` hard graph samples per particle."""
        gs = _hard_samples(zs, t, seed, stream, eps)
        with torch.enable_grad():
            th_req = _requires_grad(thetas)
            return _weighted_grad(_log_joint(gs, th_req), th_req)

    def fused_shared(zs, thetas, t, seed, streams, eps=None):
        """Both joint likelihood gradients from ONE soft noise batch
        (``streams[0]`` / ``eps[0]``): the Z gradient is the reparam
        estimator, the Theta gradient scores the thresholds of the same soft
        samples (``sigmoid(tau u) > 0.5 <=> u > 0``, exactly the Bernoulli
        samples)."""
        with torch.enable_grad():
            z_req = zs.detach().requires_grad_(True)
            gs = sample_soft_graphs(edge_scores(z_req), seed, streams[0],
                                    cfg.alpha(t), cfg.tau, n_mc,
                                    eps=None if eps is None else eps[0])
            dz = _weighted_grad(_log_joint(gs, thetas), z_req)
            hard = zero_diagonal((gs.detach() > 0.5).to(zs.dtype))
            th_req = _requires_grad(thetas)
            dtheta = _weighted_grad(_log_joint(hard, th_req), th_req)
        return dz, dtheta

    def fused_linear(zs, thetas, t, seed, streams, eps=None):
        """Both joint likelihood gradients of ``LinearGaussian`` through the
        fused kernels; ``d scores`` is chained to ``Z`` by ``dU = dS V``,
        ``dV = dS^T U``."""
        dscores, dtheta = fused_linear_estimators(
            zs=zs, thetas=thetas, x=x, interv_mask=interv_mask, seed=seed,
            streams=streams, alpha=cfg.alpha(t), tau=cfg.tau, n_samples=n_mc,
            model=fused_linear_model, eps=eps, single_pass=fused_single_pass)
        return _chain_scores(dscores, zs), dtheta

    def fused_nonlinear(zs, thetas, t, seed, streams, eps=None):
        """Both joint likelihood gradients of a one-hidden-layer
        ``DenseNonlinearGaussian`` through kernel #8."""
        dscores, dtheta = fused_nonlinear_estimators(
            zs=zs, thetas=thetas, x=x, interv_mask=interv_mask, seed=seed,
            streams=streams, alpha=cfg.alpha(t), tau=cfg.tau, n_samples=n_mc,
            model=fused_nonlinear_model, eps=eps)
        return _chain_scores(dscores, zs), dtheta

    # --- latent prior score ---

    h_fn = (acyclic_constr_spectral if cfg.acyclicity == "spectral"
            else acyclic_constr)

    def eltwise_grad_latent_prior(zs, t, seed, stream, latent_prior_std,
                                  eps=None):
        """``-beta(t) E[grad h] - Z / sigma_z^2 + grad log f(Z)``, with the
        acyclicity term from ``n_acyclicity_mc_samples`` soft samples
        (``'sampled'``) or from the edge probabilities (``'mean'``); ``h``
        is the NOTEARS trace penalty or, with ``acyclicity='spectral'``,
        the spectral radius by power iteration."""
        alpha = cfg.alpha(t)
        with torch.enable_grad():
            z_req = zs.detach().requires_grad_(True)
            prior = log_graph_prior(soft_g=edge_probs(z_req, alpha)).sum()
            (grad_prior_z,) = torch.autograd.grad(prior, z_req)

            z_req = zs.detach().requires_grad_(True)
            if cfg.acyclicity_constraint == "mean":
                h_vals = h_fn(edge_probs(z_req, alpha))  # [P]
                cot = torch.ones_like(h_vals)
            else:
                k = cfg.n_acyclicity_mc_samples
                gs = sample_soft_graphs(edge_scores(z_req), seed, stream,
                                        alpha, cfg.tau, k, eps=eps)
                h_vals = h_fn(gs)  # [P, K]
                cot = torch.full_like(h_vals, 1.0 / k)
            (grad_constraint,) = torch.autograd.grad(h_vals, z_req, cot)
        return (-cfg.beta(t) * grad_constraint
                - zs / (latent_prior_std ** 2.0)
                + grad_prior_z)

    grad_z = {"score": eltwise_grad_z_score,
              "score_rb": eltwise_grad_z_score_rb,
              "reparam": eltwise_grad_z_reparam}[cfg.grad_estimator_z]
    hook, hook_name = ((log_joint_prob, "log_joint_prob")
                       if cfg.grad_estimator_z == "reparam" else
                       (batched_node_log_joint_prob,
                        "batched_node_log_joint_prob"))
    if hook is None:
        raise ValueError(f"grad_estimator_z={cfg.grad_estimator_z!r} needs "
                         f"the likelihood model's {hook_name} hook")

    fused_grad_both = None
    if cfg.grad_estimator_z == "reparam":
        d, n_obs = x.shape[-1], x.shape[0]
        reason = (None if fused_nonlinear_model is None else
                  fused_nonlinear_decline_reason(fused_nonlinear_model,
                                                 n_obs))
        if fused_linear_model is not None and fused_linear_available(d, n_obs):
            fused_grad_both = fused_linear
        elif fused_nonlinear_model is not None and reason is None:
            _warn_on_data_scale(x, fused_nonlinear_model.obs_noise)
            fused_grad_both = fused_nonlinear
        else:
            if reason is not None:
                warnings.warn(
                    f"fused nonlinear kernel disabled: {reason}; falling "
                    "back to the generic estimators, expect lower "
                    "throughput.", stacklevel=3)
            if fused_linear_model is not None:
                warnings.warn(
                    f"fused linear-Gaussian kernels disabled for d={d}, "
                    f"N={n_obs}: their shared memory serves d <= 602 (any "
                    "N; see fused_linear_available); falling back to the "
                    "generic estimators, expect lower throughput.",
                    stacklevel=3)
            if fused_sample_sharing == "hard":
                fused_grad_both = fused_shared
    return Estimators(
        eltwise_grad_z_likelihood=grad_z,
        eltwise_grad_latent_prior=eltwise_grad_latent_prior,
        eltwise_grad_theta_likelihood=(
            eltwise_grad_theta_likelihood if log_joint_prob is not None
            else None),
        fused_grad_both=fused_grad_both)
