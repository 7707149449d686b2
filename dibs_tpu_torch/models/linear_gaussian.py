"""Linear-Gaussian models: the closed-form BGe score and the linear SEM with
its joint likelihood (PyTorch twin of ``dibs_tpu/models/linear_gaussian.py``).

``BGe`` scores a whole ``[B, d, d]`` hard-graph batch per call; for
``2 <= d <= 128`` its determinant pairs go through :func:`dibs_tpu_torch.
ops.bge_kernel.bge_logdet_pairs` (the CUDA kernel for CUDA tensors, the
plain twin on the CPU), elsewhere through :func:`dibs_tpu_torch.ops.logdet.
masked_logdet_pd_pair` over the nodes, in graph chunks past d = 64, as the
reference does where its kernel does not serve. Scoring is forward only:
the marginal estimators treat graph samples as constants.

``LinearGaussian`` scores ``log p(Theta, D | G)`` for graph and parameter
batches that broadcast over leading dimensions, differentiable through
autograd (the generic joint estimators); the fused sample-and-score path of
:mod:`dibs_tpu_torch.inference.fused_linear` computes the same gradients
without materializing the samples.
"""
from __future__ import annotations

import math

import torch
from torch.special import gammaln

from dibs_tpu_torch.config import (
    DEFAULT_DEVICE,
    likelihood_matmul_precision,
    matmul_precision,
    resolve_device,
)
from dibs_tpu_torch.ops.ancestral import interv_to_vectors, sample_sem_obs
from dibs_tpu_torch.ops.bge_kernel import BGE_MAX_D, bge_logdet_pairs
from dibs_tpu_torch.ops.logdet import masked_logdet_pd_pair

__all__ = ["BGe", "LinearGaussian"]

# Floats of masked [d, d] matrices one graph chunk of the determinant path
# past the kernel's range may form (dibs_tpu's _BGE_CHUNK_ELEMS): ~0.5 GB.
_BGE_CHUNK_ELEMS = 2 ** 27


def _isclose0(n):
    return torch.isclose(n, torch.zeros_like(n))


class BGe:
    """Bayesian Gaussian equivalent (BGe) marginal likelihood ``log p(D | G)``.

    Per-node score for node ``j`` with parent set ``Pa`` (Geiger & Heckerman
    2002, with the Kuipers et al. 2014 correction):

        log Gamma-ratio + (d-dependent constants)
        + 0.5 (N + alpha_lambd - d + |Pa|)     * logdet(R[Pa, Pa])
        - 0.5 (N + alpha_lambd - d + |Pa| + 1) * logdet(R[Pa u j, Pa u j])

    Rows where node ``j`` was intervened are dropped from node ``j``'s
    statistics; a node with no remaining rows scores 0. Defaults:
    ``mean_obs = 0``, ``alpha_mu = 1``, ``alpha_lambd = d + 2``.
    """

    def __init__(self, *, n_vars, mean_obs=None, alpha_mu=None,
                 alpha_lambd=None, device=DEFAULT_DEVICE):
        self.n_vars = n_vars
        self.device = resolve_device(device)
        self.mean_obs = (torch.zeros(n_vars, device=self.device)
                         if mean_obs is None else
                         torch.as_tensor(mean_obs, dtype=torch.float32,
                                         device=self.device))
        self.alpha_mu = alpha_mu if alpha_mu is not None else 1.0
        self.alpha_lambd = alpha_lambd if alpha_lambd is not None else n_vars + 2
        if not self.alpha_lambd > n_vars + 1:
            raise ValueError(
                f"alpha_lambd must exceed n_vars + 1 = {n_vars + 1}, "
                f"got {self.alpha_lambd}")

    # --- not available for the marginal model, as in the reference ---

    def get_theta_shape(self, *, n_vars):
        """Not available for the BGe score: use :class:`LinearGaussian`."""
        raise NotImplementedError(
            "Not available for the BGe score; use the `LinearGaussian` model.")

    def sample_parameters(self, *, generator, n_vars, n_particles=0,
                          batch_size=0):
        """Not available for the BGe score: use :class:`LinearGaussian`."""
        raise NotImplementedError(
            "Not available for the BGe score; use the `LinearGaussian` model.")

    def sample_obs(self, *, generator, n_samples, g, theta, toporder=None,
                   interv=None):
        """Not available for the BGe score: use :class:`LinearGaussian`."""
        raise NotImplementedError(
            "Not available for the BGe score; use the `LinearGaussian` model.")

    def _small_t(self):
        d = self.n_vars
        return (self.alpha_mu * (self.alpha_lambd - d - 1)) / (self.alpha_mu + 1)

    def _posterior_r_mats(self, x, interv_targets):
        """Per-node posterior matrices ``R_j [d, d, d]`` and row counts ``[d]``
        (a fleet's ``[B_ds, N, d]`` data: ``[B_ds, d, d, d]`` and ``[B_ds,
        d]``, one set a dataset).

        ``R_j = T + S_N + (N alpha_mu / (N + alpha_mu)) (xbar - mu)(xbar - mu)^T``
        over the rows where node ``j`` was not intervened. Accumulated in
        float64 and rounded once to float32, so the card and the CPU hand
        the determinant kernel and its twin the same bits.
        """
        d = self.n_vars
        x = x.to(torch.float64)
        t_mat = self._small_t() * torch.eye(d, dtype=x.dtype, device=x.device)
        keep = 1.0 - interv_targets.to(x.dtype)  # [..., N, d]
        n_obs = keep.sum(-2)
        zero = _isclose0(n_obs)
        sums = torch.einsum("...nj,...nd->...jd", keep, x)
        safe_n = torch.where(zero, torch.ones_like(n_obs), n_obs)
        x_bar = torch.where(zero[..., None], torch.zeros_like(sums),
                            sums / safe_n[..., None])
        x_center = ((x[..., None, :, :] - x_bar[..., :, None, :])
                    * keep.transpose(-1, -2)[..., :, :, None])
        s_n = torch.einsum("...jnd,...jne->...jde", x_center, x_center)
        mean_diff = x_bar - self.mean_obs.to(x.dtype)
        scale = (n_obs * self.alpha_mu) / (n_obs + self.alpha_mu)
        outer = torch.einsum("...jd,...je->...jde", mean_diff, mean_diff)
        r_mats = t_mat + s_n + scale[..., None, None] * outer
        return r_mats.float(), n_obs.float()

    def _score(self, n_obs, n_parents, logdet_pa, logdet_paj):
        """Node scores from the determinant pairs (broadcasting), evaluated
        in float64: the score subtracts two ~N/2 * logdet products, and
        float64 keeps its float32 result independent of the device."""
        d, a_mu, a_l = self.n_vars, self.alpha_mu, self.alpha_lambd
        n = n_obs.double()
        n_parents = n_parents.double()
        logdet_pa, logdet_paj = logdet_pa.double(), logdet_paj.double()
        log_gamma_term = (
            0.5 * (math.log(a_mu) - torch.log(n + a_mu))
            + gammaln(0.5 * (n + a_l - d + n_parents + 1))
            - gammaln(0.5 * (a_l - d + n_parents + 1))
            - 0.5 * n * math.log(math.pi)
            + 0.5 * (a_l - d + 2 * n_parents + 1) * math.log(self._small_t())
        )
        log_term_r = (
            0.5 * (n + a_l - d + n_parents) * logdet_pa
            - 0.5 * (n + a_l - d + n_parents + 1) * logdet_paj
        )
        out = log_gamma_term + log_term_r
        # neutral element where node j has no un-intervened observations
        return torch.where(_isclose0(n).expand_as(out), torch.zeros_like(out),
                           out).float()

    def _node_score(self, j, n_parents, g, r_mats, n_obs):
        """BGe score of node ``j`` of one graph ``g [d, d]``, with its
        determinant pair from the reference's elimination
        (:func:`dibs_tpu_torch.ops.logdet.masked_logdet_pd_pair`)."""
        e_j = torch.eye(self.n_vars, dtype=r_mats.dtype,
                        device=r_mats.device)[:, j]
        logdet_pa, logdet_paj = masked_logdet_pd_pair(r_mats[j], g[:, j], e_j)
        return self._score(n_obs[j], n_parents, logdet_pa, logdet_paj)

    def node_log_marginal_likelihoods(self, *, g, x, interv_targets):
        """Per-node BGe scores ``[d]`` of one graph (the per-graph path; the
        estimators use :meth:`batched_node_log_marginal_likelihoods`)."""
        r_mats, n_obs = self._posterior_r_mats(x, interv_targets)
        g = g.to(r_mats.dtype)
        n_parents = g.sum(0)
        return torch.stack([
            self._node_score(j, n_parents[j], g, r_mats, n_obs)
            for j in range(self.n_vars)])

    def batched_node_log_marginal_likelihoods(self, *, gs, x, interv_targets):
        """Per-node BGe scores ``[B, d]`` of a hard-graph batch ``[B, d, d]``
        (row sums are the marginal likelihoods). For ``2 <= d <= 128`` the
        determinant pairs of the whole batch come from one
        :func:`bge_logdet_pairs` call; elsewhere from
        :func:`masked_logdet_pd_pair` over every (graph, node), past d = 64
        in graph chunks of at most ``_BGE_CHUNK_ELEMS`` masked floats.

        A fleet passes ``x`` and ``interv_targets`` with a leading dataset
        axis, ``[B_ds, N, d]``, and ``gs`` as ``[B_ds, G, d, d]``; it gets
        ``[B_ds, G, d]``, each dataset's graphs scored on its own data, the
        kernel's pairs of every dataset from one launch."""
        r_mats, n_obs = self._posterior_r_mats(x, interv_targets)
        d = self.n_vars
        fleet = x.dim() == 3
        gs = gs.to(torch.float32).contiguous()
        if fleet and (gs.dim() != 4 or gs.shape[0] != x.shape[0]):
            raise ValueError(f"a fleet's graphs must be [{x.shape[0]}, G, "
                             f"{d}, {d}], got {tuple(gs.shape)}")
        if 2 <= d <= BGE_MAX_D:
            logdet_pa, logdet_paj = bge_logdet_pairs(r_mats.contiguous(),
                                                     gs.reshape(-1, d, d))
            logdet_pa = logdet_pa.reshape(gs.shape[:-1])
            logdet_paj = logdet_paj.reshape(gs.shape[:-1])
        else:
            # node j's parents are column j: row j of the transposed graphs
            eye = torch.eye(d, dtype=r_mats.dtype, device=r_mats.device)
            sets = r_mats[:, None] if fleet else r_mats
            n_sets = x.shape[0] if fleet else 1
            axis = gs.dim() - 3  # the graphs' axis
            per_chunk = (max(1, _BGE_CHUNK_ELEMS // (n_sets * d ** 3))
                         if d > 64 else max(1, gs.shape[axis]))
            pairs = [masked_logdet_pd_pair(sets, chunk.transpose(-1, -2),
                                           eye)
                     for chunk in gs.split(per_chunk, dim=axis)]
            logdet_pa = torch.cat([pa for pa, _ in pairs], dim=axis)
            logdet_paj = torch.cat([paj for _, paj in pairs], dim=axis)
        return self._score(n_obs[..., None, :], gs.sum(-2), logdet_pa,
                           logdet_paj)

    def log_marginal_likelihood(self, *, g, x, interv_targets):
        """Closed-form BGe marginal likelihood ``log p(D | G)``."""
        return self.node_log_marginal_likelihoods(
            g=g, x=x, interv_targets=interv_targets).sum(0)

    def batched_interventional_node_log_marginal_probs(self, gs, _, x,
                                                       interv_targets, rng):
        """Inference-contract wrapper over the batched per-node scores (the
        hook the ``score`` / ``score_rb`` estimators call)."""
        return self.batched_node_log_marginal_likelihoods(
            gs=gs, x=x, interv_targets=interv_targets)

    def interventional_log_marginal_prob(self, g, _, x, interv_targets, rng):
        """Inference-contract wrapper; ``theta``/``rng`` are unused."""
        return self.log_marginal_likelihood(g=g, x=x,
                                            interv_targets=interv_targets)

    def interventional_node_log_marginal_probs(self, g, _, x, interv_targets,
                                               rng):
        """Per-node analog of :meth:`interventional_log_marginal_prob`."""
        return self.node_log_marginal_likelihoods(
            g=g, x=x, interv_targets=interv_targets)


def _normal_logpdf(x, loc, scale):
    return (-0.5 * torch.square((x - loc) / scale) - math.log(scale)
            - 0.5 * math.log(2.0 * math.pi))


class LinearGaussian:
    """Linear SEM with additive Gaussian noise, generative and joint-likelihood
    model: ``x_j = x @ (g * theta)[:, j] + eps_j``, ``eps ~ N(0, obs_noise)``;
    edge weights ``N(mean_edge, sig_edge^2)`` on present edges (shifted away
    from 0 by ``min_edge`` when sampled)."""

    def __init__(self, *, n_vars, obs_noise=0.1, mean_edge=0.0, sig_edge=1.0,
                 min_edge=0.5):
        self.n_vars = n_vars
        self.obs_noise = obs_noise
        self.mean_edge = mean_edge
        self.sig_edge = sig_edge
        self.min_edge = min_edge

    def get_theta_shape(self, *, n_vars):
        """Parameter shape: a single ``[d, d]`` edge-weight matrix."""
        return (n_vars, n_vars)

    def sample_parameters(self, *, generator, n_vars, n_particles=0,
                          batch_size=0, device=DEFAULT_DEVICE):
        """``theta`` from the edge prior; leading dims equal to 0 are dropped."""
        device = resolve_device(device)
        shape = tuple(s for s in (batch_size, n_particles, n_vars, n_vars)
                      if s != 0)
        theta = self.mean_edge + self.sig_edge * torch.randn(
            shape, generator=generator)
        return (theta + torch.sign(theta) * self.min_edge).to(device)

    def sample_obs(self, *, generator, n_samples, g, theta, toporder=None,
                   interv=None):
        """Ancestral sampling of ``[n_samples, d]`` observations; ``g`` is a
        ``[d, d]`` adjacency matrix. ``toporder`` is accepted, as in the
        reference, and ignored: the fixed-point sampler needs no order."""
        w = g.to(theta.dtype) * theta
        mask, values = interv_to_vectors(interv, self.n_vars, theta.device)
        return sample_sem_obs(
            generator=generator, n_samples=n_samples, n_vars=self.n_vars,
            mean_fn=lambda x: x @ w, obs_noise=self.obs_noise,
            interv_mask=mask, interv_values=values)

    # --- scoring: g, theta [..., d, d] (broadcasting) -> [...] ---

    def log_prob_parameters(self, *, theta, g):
        """Edge-masked Gaussian parameter prior ``log p(Theta | G)``."""
        lp = _normal_logpdf(theta, self.mean_edge, self.sig_edge)
        return (g * lp).sum(dim=(-2, -1))

    def log_likelihood(self, *, x, theta, g, interv_targets):
        """``log p(D | G, Theta)`` with intervened entries masked out; one
        ``[N, d] @ [..., d, d]`` matmul, at :func:`~dibs_tpu_torch.config.
        likelihood_matmul_precision`, gives every node's means."""
        if tuple(x.shape) != tuple(interv_targets.shape):
            raise ValueError(f"x {tuple(x.shape)} and interv_targets "
                             f"{tuple(interv_targets.shape)} must match")
        with matmul_precision(likelihood_matmul_precision()):
            means = x @ (g * theta)
        logpdf = _normal_logpdf(x, means, math.sqrt(self.obs_noise))
        logpdf = torch.where(interv_targets.bool(), torch.zeros_like(logpdf),
                             logpdf)
        return logpdf.sum(dim=(-2, -1))

    def interventional_log_joint_prob(self, g, theta, x, interv_targets, rng):
        """Joint ``log p(Theta, D | G) = log p(Theta | G) + log p(D | G, Theta)``
        for one graph or batches ``[..., d, d]`` that broadcast (``[B, d, d]``
        graphs with ``[B, d, d]`` parameters give ``[B]``; the estimators pass
        ``[P, M, d, d]`` samples with ``[P, 1, d, d]``); ``rng`` is unused."""
        return (self.log_prob_parameters(g=g, theta=theta)
                + self.log_likelihood(g=g, theta=theta, x=x,
                                      interv_targets=interv_targets))
