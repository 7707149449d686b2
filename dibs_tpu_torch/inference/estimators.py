"""DiBS gradient estimators (PyTorch twin of
``dibs_tpu/inference/estimators.py``): the REINFORCE ``score`` estimator
of marginal and joint inference, ``score_rb`` of marginal inference, the
reparameterization and Theta estimators of joint inference, the shared-
noise and fused linear-Gaussian joint estimators, and the latent-prior
score.

Every estimator works on the whole particle batch at once. Graph samples
come from the Gumbel sampler kernel (:mod:`dibs_tpu_torch.ops.soft_graphs`)
with noise from the counter-based stream (``seed``, ``stream``) or an
injected Logistic ``eps``. The REINFORCE estimators score all ``P * M``
hard samples in one call of the model's batched per-node hook (BGe: the
determinant-pair kernel); joint ``score`` scores them with
``log_joint_prob``, each particle's samples with its own parameters. The
reparameterization and Theta estimators are one autograd call each: with
shared samples the self-normalized ratio is a softmax-weighted sum of
per-sample gradients, so the softmax weights are the cotangents.
``Theta`` is a parameter tree (:mod:`dibs_tpu_torch.utils.tree`): a ``[P,
d, d]`` tensor for ``LinearGaussian``, ``[(W1, b1), (W2, b2), ...]`` with
leading particle dims for ``DenseNonlinearGaussian``. With
the reparameterization estimator, ``fused_grad_both`` computes both
likelihood gradients in the fused kernels of :mod:`dibs_tpu_torch.inference.
fused_linear` (``LinearGaussian``) or :mod:`dibs_tpu_torch.inference.
fused_nonlinear` (one-hidden-layer ``DenseNonlinearGaussian``).

A fleet (:mod:`dibs_tpu_torch.fleet`) builds the estimators on ``B_ds``
datasets at once: ``x`` and ``interv_mask`` carry a leading dataset axis,
the particle batch is the ``B_ds * P`` particles in dataset order, and
``seed`` is the ``[B_ds]`` int64 keys, so each dataset's samples are those
of a single run keyed by its key. Only the data-dependent parts see the
dataset axis: the marginal hook (each dataset's ``P * M`` hard samples
scored on its own data, every dataset in one call), ``log_joint_prob``
(the graphs ``[B_ds, P, M, d, d]`` with the parameter leaves ``[B_ds, P,
1, ...]`` and ``x`` / ``interv_mask`` ``[B_ds, 1, 1, N, d]``, so one call
scores every particle's samples on its dataset's data) and the fused joint
kernels (each particle's dataset and key, in one launch, both tiers); the
REINFORCE ratio, its baseline, the softmax weights, the latent prior and
the graph prior work per particle as they are.

Under a particle sharding (:mod:`dibs_tpu_torch.parallel`) the particle
batch is this rank's block of ``world`` equal blocks: every sampler and
fused kernel call takes its first particle's global index as
``particle_offset``, so each particle's samples, scores and gradients are
bitwise those of the unsharded call.

On the ``("p", "mc")`` mesh the samples are split too: where the ``"mc"``
axis divides ``M`` (or ``K``), each ``"mc"`` rank draws its block of the
samples at their global sample indices (``sample_offset``) and every sum
over samples becomes a local sum followed by a sum over the ``"mc"`` group
(:func:`~dibs_tpu_torch.parallel.shard_ops.mc_sum`). The ``[P, M]``
log-probabilities (``[P, M, d]`` node scores for ``score_rb``) are
all-gathered first, so every weight, every logsumexp and the baseline
update come from all ``M`` as in the unsharded step, and the baseline is
bitwise the same on every rank. Where the axis does not divide the
count, every ``"mc"`` rank draws all the samples (replicated). The fused
kernels #5-#8 are not split over ``"mc"``: every ``"mc"`` rank of a
``"p"`` block runs the same launch, as the reference's ``shard_map``
declares the particle axis only.

Estimator maths (as the reference): the self-normalized ratio

    grad log E_{p(G|Z)}[p(D | G)] = E[p(D|G) grad log p(G|Z)] / E[p(D|G)]

with the same MC samples in numerator and denominator, its weights in
signed log space. The REINFORCE ratio is linear in the per-sample
residuals, so it is summed over the graphs first (kernel #10) and chained
to ``Z`` once.
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
from dibs_tpu_torch.ops.edges import edge_probs, edge_scores
from dibs_tpu_torch.ops.gpu_kernels import score_ratio
from dibs_tpu_torch.ops.soft_graphs import sample_hard_graphs, sample_soft_graphs
from dibs_tpu_torch.parallel import constrain_mc
from dibs_tpu_torch.parallel.shard_ops import mc_block, mc_gather, mc_sum, \
    shard_offset
from dibs_tpu_torch.profiling import count, span
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
    grad_estimator_z: str = "reparam"  # 'score' | 'score_rb' | 'reparam'
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


def _ratio_log_weights(logprobs, baselines, c):
    """``(log_w, sign_w, centred)`` of the REINFORCE ratio of ``[P, M]``
    log-probabilities: the numerator's log-weights and signs, and the
    centred log-probabilities of its denominator. With a baseline (``c >
    0``) the numerator weights are ``p_m - exp(b)``, ``b`` the log-space
    EMA of the mean log-likelihood (-inf = off): the reference's deliberate
    divergence from the paper's log-space form."""
    # The ratio is unchanged when every log-weight of a particle moves by
    # one constant. Centred at the samples' largest log-probability, the
    # float32 log-space sums stay near 0: uncentred joint log-probabilities
    # of -1e3 to -1e4 nats carry their rounding (an ulp of 1e-4 to 1e-3
    # nats) into every weight.
    shift = logprobs.max(1, keepdim=True).values
    shift = torch.where(torch.isfinite(shift), shift, torch.zeros_like(shift))
    centred = logprobs - shift
    if c == 0.0:
        return centred, torch.ones_like(centred), centred
    b = baselines[:, None] - shift
    m = torch.maximum(centred, b)
    log_w = m + torch.log(torch.abs(torch.exp(centred - m)
                                    - torch.exp(b - m)))
    return log_w, torch.sign(centred - b), centred


def _ratio_weights(logprobs, baselines, c):
    """``[P, M]`` weights ``w_m`` of the REINFORCE ratio, signed numerator
    weight over the denominator's sum, so that the ratio is ``sum_m w_m
    grad_Z log p(G_m | Z)``. A zero sign or an empty numerator weighs 0
    (an empty denominator then gives 0, as the signed logsumexp of
    :func:`stable_ratio_grad` does); a baseline far above the samples
    overflows to a non-finite weight, as there."""
    log_w, sign_w, centred = _ratio_log_weights(logprobs, baselines, c)
    w = sign_w * torch.exp(log_w - torch.logsumexp(centred, dim=1,
                                                   keepdim=True))
    return torch.where((sign_w == 0) | (log_w == -math.inf),
                       torch.zeros_like(w), w)


def _scores_to_z(dscores, zs):
    """``d scores -> dZ``: ``dU = dS V``, ``dV = dS^T U``."""
    u, v = zs[..., 0], zs[..., 1]
    return torch.stack([dscores @ v, dscores.transpose(-1, -2) @ u], dim=-1)


def _chain_scores(dscores, zs):
    """:func:`_scores_to_z` in the span of the score-gradient chain."""
    with span("dibs.likelihood.grad"):
        return _scores_to_z(dscores, zs)


def _warn_on_data_scale(x, obs_noise):
    """Advisory, for the MLP model only: estimates the per-sample
    ``|log-likelihood| ~ N sum_j E[x_j^2] / (2 sigma^2)`` and warns from 1e6
    up. The fused kernel is scale-safe (centred scoring); the warning is
    about the model: ``N(0, sig_param^2)`` weight priors recover structure
    on data this large only if the process really lives at that scale
    (rescaled, unstandardized data is the usual cause). Changes no path."""
    est = float((x.shape[-2] * torch.square(x).mean(-2).sum(-1)).max()
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
                    fused_single_pass: bool = True,
                    sharding=None) -> Estimators:
    """Builds the batched estimator callables for fixed data and models.

    Args:
        cfg: static estimator hyperparameters
        log_graph_prior: ``soft_g [..., d, d] -> [...]`` graph-prior
            log-density on edge probabilities (autograd-differentiable)
        x: ``[N, d]`` observations (a fleet's ``[B_ds, N, d]``)
        interv_mask: ``[N, d]`` intervention indicators (a fleet's
            ``[B_ds, N, d]``)
        batched_node_log_joint_prob: ``(gs [B, d, d], theta, x, interv_mask,
            rng) -> [B, d]`` per-node scores (row sums are the graphs'
            marginal log-likelihoods); the hook of marginal ``score`` and
            of ``score_rb``
        log_joint_prob: ``(gs [..., d, d], thetas, x, interv_mask, rng) ->
            [...]`` joint log-probability, broadcasting the graphs' leading
            dims against the parameter tree's and autograd-differentiable;
            the hook of the ``reparam`` and Theta estimators and of joint
            ``score`` (each particle's hard samples with its parameters)
        fused_linear_model: a :class:`~dibs_tpu_torch.models.LinearGaussian`
            enables the fused kernels (reparam estimator only) wherever
            :func:`fused_linear_available` serves ``(d, N)``
        fused_nonlinear_model: a :class:`~dibs_tpu_torch.models.
            DenseNonlinearGaussian` enables kernel #8 (reparam estimator
            only) wherever :func:`fused_nonlinear_available` serves it on
            ``x``'s device;
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
        sharding: a :func:`~dibs_tpu_torch.parallel.particle_sharding`
            when the particles passed are this rank's block of a sharded
            run: the samplers and the fused kernels then draw at the
            block's global particle indices (bitwise the unsharded call);
            on the ``("p", "mc")`` mesh the samples are split over
            ``"mc"`` as the module docstring says
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
    if sharding is not None and x.dim() == 3:
        raise ValueError("a fleet shards its datasets, not its particles; "
                         "build its estimators without a sharding")
    n_mc = cfg.n_grad_mc_samples
    # this rank's blocks of the M and K samples on the "mc" axis
    m_first, m_local = mc_block(sharding, n_mc)
    k_first, k_local = mc_block(sharding, cfg.n_acyclicity_mc_samples)
    split_m = m_local != n_mc

    def _offset(zs):
        return shard_offset(sharding, zs.shape[0])

    def _block(eps):
        """This rank's samples of an injected ``[P, n, d, d]`` noise."""
        return None if eps is None else \
            constrain_mc(eps, sharding).contiguous()

    def _hard_samples(zs, t, seed, stream, eps):
        with span("dibs.likelihood.sampler"):
            return sample_hard_graphs(
                edge_scores(zs), seed, stream, cfg.alpha(t), m_local,
                eps=_block(eps), particle_offset=_offset(zs),
                sample_offset=m_first)

    def _all_samples(t):
        """``[P, M_local, ...]`` -> ``[P, M, ...]`` over the "mc" group."""
        return mc_gather(t, sharding) if split_m else t

    def _mine(t):
        """This rank's samples of a ``[P, M, ...]`` tensor."""
        return constrain_mc(t, sharding)

    def _sum_samples(tree):
        """A tree of this rank's sums over its samples -> the sums over all
        ``M`` (one collective for every leaf)."""
        if not split_m:
            return tree
        leaves = tree_leaves(tree)
        flat = mc_sum(torch.cat([leaf.reshape(-1) for leaf in leaves]),
                      sharding)
        parts = torch.split(flat, [leaf.numel() for leaf in leaves])
        return tree_unflatten(tree, [part.view_as(leaf) for part, leaf
                                     in zip(parts, leaves)])

    # a fleet's hook takes each dataset's graphs on its own axis
    graphs_lead = (x.shape[0],) if x.dim() == 3 else ()

    def _count_mlp(pairs):
        """The MLP likelihood's work while a profiler records: the
        (particle, sample) pairs whose log-joint a call scored, and the
        calls (the generic route scores the soft and the hard samples in
        two, #8 both in one)."""
        count("mlp_lik.pairs", pairs)
        count("mlp_lik.calls", 1)

    def _node_scores(g_all):
        p_n, m_n, d_n = g_all.shape[:3]
        return batched_node_log_joint_prob(
            g_all.reshape(*graphs_lead, -1, d_n, d_n), None, x, interv_mask,
            None,
        ).reshape(p_n, m_n, d_n)

    # --- REINFORCE with the signed linear-space EMA control variate ---

    def _score_from_logprobs(zs, baselines, g_all, logprobs, alpha):
        """The REINFORCE ratio of ``[P, M]`` log-probabilities (all the
        samples) of this rank's hard samples ``g_all [P, M_local, d, d]``,
        with the baseline update.

        The ratio ``sum_m w_m grad_Z log p(G_m | Z)`` (:func:`_ratio_
        weights`) is linear in the residuals ``alpha (G_m - p)``: it is
        ``R @ V`` and ``R^T @ U`` with ``R = alpha (sum_m w_m G_m - (sum_m
        w_m) p)``, which kernel #10 (:func:`~dibs_tpu_torch.ops.
        gpu_kernels.score_ratio`) forms in one pass over the graphs; the
        per-sample gradients are never made."""
        c = cfg.score_function_baseline
        new_baselines = baselines
        if c > 0.0:
            new_baselines = torch.logaddexp(
                math.log(c) + logprobs.mean(1),
                math.log(1 - c) + baselines)
        w = _ratio_weights(logprobs, baselines, c)
        count("score_ratio.calls", 1)
        resid = score_ratio(g_all, _mine(w).contiguous(),
                            edge_probs(zs, alpha), alpha)
        return _sum_samples(_scores_to_z(resid, zs)), new_baselines

    def eltwise_grad_z_score(zs, thetas, baselines, t, seed, stream,
                             eps=None):
        """Marginal (``thetas`` None): the batched per-node hook scores all
        ``P * M`` hard samples; joint: ``log_joint_prob`` scores each
        particle's samples with its own parameters."""
        g_all = _hard_samples(zs, t, seed, stream, eps)  # [P, M, d, d]
        with span("dibs.likelihood.score"):
            if thetas is None:
                # float64 sum: exact for d float32 terms, so the same on
                # any device
                logprobs = _node_scores(g_all).double().sum(-1).float()
            else:
                logprobs = _log_joint(g_all, thetas)
            logprobs = _all_samples(logprobs)
        with span("dibs.likelihood.grad"):
            return _score_from_logprobs(zs, baselines, g_all, logprobs,
                                        cfg.alpha(t))

    # --- per-node Rao-Blackwellized REINFORCE ---

    def eltwise_grad_z_score_rb(zs, thetas, baselines, t, seed, stream,
                                eps=None):
        alpha = cfg.alpha(t)
        g_all = _hard_samples(zs, t, seed, stream, eps)
        with span("dibs.likelihood.score"):
            node_scores = _all_samples(_node_scores(g_all))  # [P, M, d]
        with span("dibs.likelihood.grad"):
            p = edge_probs(zs, alpha)
            w = torch.exp(node_scores - torch.logsumexp(node_scores, dim=1,
                                                        keepdim=True))
            g_bar = _sum_samples(torch.einsum("pmij,pmj->pij", g_all,
                                              _mine(w)))
            resid = alpha * (g_bar - p)  # diagonals of g_bar, p both 0
            return _scores_to_z(resid, zs), baselines

    # --- joint: softmax-weighted per-sample gradients, one autograd call ---

    def _weighted_grad(logp, wrt):
        """``sum_m softmax(logp)_m grad logp_m`` per particle; ``wrt`` is a
        tensor or a parameter tree. The softmax is over all ``M`` samples;
        autograd runs with this rank's slice of the weights."""
        with span("dibs.likelihood.grad"):
            weights = _mine(torch.softmax(_all_samples(logp.detach()),
                                          dim=1))
            grads = torch.autograd.grad(logp, tree_leaves(wrt), weights)
            return _sum_samples(tree_unflatten(wrt, grads))

    def _log_joint(gs, thetas):
        # [P, M, d, d] graphs with the particle's parameters -> [P, M]
        if fused_nonlinear_model is not None:
            _count_mlp(gs.shape[:2].numel())
        if not graphs_lead:
            return log_joint_prob(gs, tree_map(lambda leaf: leaf[:, None],
                                               thetas),
                                  x, interv_mask, None)
        # a fleet: particle p's samples on dataset p // (P / B_ds)'s data
        lead = (*graphs_lead, -1)
        return log_joint_prob(
            gs.reshape(*lead, *gs.shape[1:]),
            tree_map(lambda leaf: leaf.reshape(*lead, 1, *leaf.shape[1:]),
                     thetas),
            x[:, None, None], interv_mask[:, None, None], None,
        ).reshape(gs.shape[:2])

    def _requires_grad(thetas):
        return tree_map(lambda leaf: leaf.detach().requires_grad_(True),
                        thetas)

    def eltwise_grad_z_reparam(zs, thetas, baselines, t, seed, stream,
                               eps=None):
        """Gumbel-softmax reparameterization estimator of the Z score."""
        with torch.enable_grad():
            z_req = zs.detach().requires_grad_(True)
            with span("dibs.likelihood.sampler"):
                gs = sample_soft_graphs(edge_scores(z_req), seed, stream,
                                        cfg.alpha(t), cfg.tau, m_local,
                                        eps=_block(eps),
                                        particle_offset=_offset(zs),
                                        sample_offset=m_first)
            with span("dibs.likelihood.score"):
                logp = _log_joint(gs, thetas)
            return _weighted_grad(logp, z_req), baselines

    def eltwise_grad_theta_likelihood(zs, thetas, t, seed, stream, eps=None):
        """Theta score from ``M`` hard graph samples per particle."""
        gs = _hard_samples(zs, t, seed, stream, eps)
        with torch.enable_grad():
            th_req = _requires_grad(thetas)
            with span("dibs.likelihood.score"):
                logp = _log_joint(gs, th_req)
            return _weighted_grad(logp, th_req)

    def fused_shared(zs, thetas, t, seed, streams, eps=None):
        """Both joint likelihood gradients from ONE soft noise batch
        (``streams[0]`` / ``eps[0]``): the Z gradient is the reparam
        estimator, the Theta gradient scores the thresholds of the same soft
        samples (``sigmoid(tau u) > 0.5 <=> u > 0``, exactly the Bernoulli
        samples)."""
        with torch.enable_grad():
            z_req = zs.detach().requires_grad_(True)
            with span("dibs.likelihood.sampler"):
                gs = sample_soft_graphs(edge_scores(z_req), seed, streams[0],
                                        cfg.alpha(t), cfg.tau, m_local,
                                        eps=None if eps is None else _block(
                                            eps[0]),
                                        particle_offset=_offset(zs),
                                        sample_offset=m_first)
            with span("dibs.likelihood.score"):
                logp = _log_joint(gs, thetas)
            dz = _weighted_grad(logp, z_req)
            with span("dibs.likelihood.sampler"):
                hard = zero_diagonal((gs.detach() > 0.5).to(zs.dtype))
            th_req = _requires_grad(thetas)
            with span("dibs.likelihood.score"):
                logp = _log_joint(hard, th_req)
            dtheta = _weighted_grad(logp, th_req)
        return dz, dtheta

    def fused_linear(zs, thetas, t, seed, streams, eps=None):
        """Both joint likelihood gradients of ``LinearGaussian`` through the
        fused kernels; ``d scores`` is chained to ``Z`` by ``dU = dS V``,
        ``dV = dS^T U``. Not split over ``"mc"``: every ``"mc"`` rank runs
        its ``"p"`` block's whole launch."""
        with span("dibs.likelihood.score"):
            dscores, dtheta = fused_linear_estimators(
                zs=zs, thetas=thetas, x=x, interv_mask=interv_mask,
                seed=seed, streams=streams, alpha=cfg.alpha(t), tau=cfg.tau,
                n_samples=n_mc, model=fused_linear_model, eps=eps,
                single_pass=fused_single_pass, particle_offset=_offset(zs))
        return _chain_scores(dscores, zs), dtheta

    def fused_nonlinear(zs, thetas, t, seed, streams, eps=None):
        """Both joint likelihood gradients of a one-hidden-layer
        ``DenseNonlinearGaussian`` through kernel #8 (not split over
        ``"mc"``, as :func:`fused_linear`)."""
        _count_mlp(2 * zs.shape[0] * n_mc)
        with span("dibs.likelihood.score"):
            dscores, dtheta = fused_nonlinear_estimators(
                zs=zs, thetas=thetas, x=x, interv_mask=interv_mask,
                seed=seed, streams=streams, alpha=cfg.alpha(t), tau=cfg.tau,
                n_samples=n_mc, model=fused_nonlinear_model, eps=eps,
                particle_offset=_offset(zs))
        return _chain_scores(dscores, zs), dtheta

    # --- latent prior score ---

    h_fn = (acyclic_constr_spectral if cfg.acyclicity == "spectral"
            else acyclic_constr)

    def eltwise_grad_latent_prior(zs, t, seed, stream, latent_prior_std,
                                  eps=None):
        """``-beta(t) E[grad h] - Z / sigma_z^2 + grad log f(Z)``, with the
        acyclicity term from ``n_acyclicity_mc_samples`` soft samples
        (``'sampled'``; split over ``"mc"`` like the likelihood's) or from
        the edge probabilities (``'mean'``); ``h`` is the NOTEARS trace
        penalty or, with ``acyclicity='spectral'``, the spectral radius by
        power iteration."""
        alpha = cfg.alpha(t)
        with span("dibs.prior"):
            with torch.enable_grad():
                z_req = zs.detach().requires_grad_(True)
                prior = log_graph_prior(
                    soft_g=edge_probs(z_req, alpha)).sum()
                with span("dibs.prior.grad"):
                    (grad_prior_z,) = torch.autograd.grad(prior, z_req)

                z_req = zs.detach().requires_grad_(True)
                if cfg.acyclicity_constraint == "mean":
                    h_vals = h_fn(edge_probs(z_req, alpha))  # [P]
                    cot = torch.ones_like(h_vals)
                else:
                    k = cfg.n_acyclicity_mc_samples
                    with span("dibs.prior.sampler"):
                        gs = sample_soft_graphs(
                            edge_scores(z_req), seed, stream, alpha,
                            cfg.tau, k_local, eps=_block(eps),
                            particle_offset=_offset(zs),
                            sample_offset=k_first)
                    h_vals = h_fn(gs)  # [P, K_local]
                    cot = torch.full_like(h_vals, 1.0 / k)
                with span("dibs.prior.grad"):
                    (grad_constraint,) = torch.autograd.grad(h_vals, z_req,
                                                             cot)
                if cfg.acyclicity_constraint != "mean" and k_local != k:
                    grad_constraint = mc_sum(grad_constraint, sharding)
            return (-cfg.beta(t) * grad_constraint
                    - zs / (latent_prior_std ** 2.0)
                    + grad_prior_z)

    grad_z = {"score": eltwise_grad_z_score,
              "score_rb": eltwise_grad_z_score_rb,
              "reparam": eltwise_grad_z_reparam}[cfg.grad_estimator_z]
    if (cfg.grad_estimator_z == "score_rb"
            and batched_node_log_joint_prob is None):
        # the reference's error, raised where it builds the estimator
        raise ValueError(
            "grad_estimator_z='score_rb' needs a per-node likelihood "
            "decomposition (e.g. BGe.interventional_node_log_marginal_"
            "probs); this model does not provide one.")
    hook, hook_name = ((log_joint_prob, "log_joint_prob")
                       if cfg.grad_estimator_z == "reparam" else
                       (batched_node_log_joint_prob or log_joint_prob,
                        "batched_node_log_joint_prob"))
    if hook is None:
        raise ValueError(f"grad_estimator_z={cfg.grad_estimator_z!r} needs "
                         f"the likelihood model's {hook_name} hook")

    fused_grad_both = None
    if cfg.grad_estimator_z == "reparam":
        d, n_obs = x.shape[-1], x.shape[-2]
        reason = (None if fused_nonlinear_model is None else
                  fused_nonlinear_decline_reason(fused_nonlinear_model,
                                                 n_obs, x.device))
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
