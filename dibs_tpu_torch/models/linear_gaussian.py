"""Linear-Gaussian models: the closed-form BGe score and the generative half
of the linear SEM (PyTorch twin of ``dibs_tpu/models/linear_gaussian.py``).

``BGe`` scores a whole ``[B, d, d]`` hard-graph batch per call; its
determinant pairs go through :func:`dibs_tpu_torch.ops.bge_kernel.
bge_logdet_pairs` (the CUDA kernel for CUDA tensors, the plain twin on the
CPU). Scoring is forward only: the marginal estimators treat graph samples
as constants.
"""
from __future__ import annotations

import math

import torch
from torch.special import gammaln

from dibs_tpu_torch.ops.ancestral import interv_to_vectors, sample_sem_obs
from dibs_tpu_torch.ops.bge_kernel import bge_logdet_pairs
from dibs_tpu_torch.ops.logdet import masked_logdet_pd_pair

__all__ = ["BGe", "LinearGaussian"]


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
                 alpha_lambd=None, device="cpu"):
        self.n_vars = n_vars
        self.device = torch.device(device)
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

    def _small_t(self):
        d = self.n_vars
        return (self.alpha_mu * (self.alpha_lambd - d - 1)) / (self.alpha_mu + 1)

    def _posterior_r_mats(self, x, interv_targets):
        """Per-node posterior matrices ``R_j [d, d, d]`` and row counts ``[d]``.

        ``R_j = T + S_N + (N alpha_mu / (N + alpha_mu)) (xbar - mu)(xbar - mu)^T``
        over the rows where node ``j`` was not intervened. Accumulated in
        float64 and rounded once to float32, so the card and the CPU hand
        the determinant kernel and its twin the same bits.
        """
        d = self.n_vars
        x = x.to(torch.float64)
        t_mat = self._small_t() * torch.eye(d, dtype=x.dtype, device=x.device)
        keep = 1.0 - interv_targets.to(x.dtype)  # [N, d]
        n_obs = keep.sum(0)
        zero = _isclose0(n_obs)
        sums = torch.einsum("nj,nd->jd", keep, x)
        safe_n = torch.where(zero, torch.ones_like(n_obs), n_obs)
        x_bar = torch.where(zero[:, None], torch.zeros_like(sums),
                            sums / safe_n[:, None])
        x_center = (x[None, :, :] - x_bar[:, None, :]) * keep.T[:, :, None]
        s_n = torch.einsum("jnd,jne->jde", x_center, x_center)
        mean_diff = x_bar - self.mean_obs.to(x.dtype)[None, :]
        scale = (n_obs * self.alpha_mu) / (n_obs + self.alpha_mu)
        outer = torch.einsum("jd,je->jde", mean_diff, mean_diff)
        r_mats = t_mat[None] + s_n + scale[:, None, None] * outer
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
        (row sums are the marginal likelihoods); the determinant pairs of the
        whole batch come from one :func:`bge_logdet_pairs` call."""
        r_mats, n_obs = self._posterior_r_mats(x, interv_targets)
        gs = gs.to(torch.float32).contiguous()
        logdet_pa, logdet_paj = bge_logdet_pairs(r_mats.contiguous(), gs)
        return self._score(n_obs[None, :], gs.sum(-2), logdet_pa, logdet_paj)

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


class LinearGaussian:
    """Linear SEM with additive Gaussian noise: the generative half
    (``x_j = x @ (g * theta)[:, j] + eps_j``, ``eps ~ N(0, obs_noise)``;
    edge weights ``N(mean_edge, sig_edge^2)`` shifted away from 0 by
    ``min_edge``). Scoring waits for the joint slice."""

    def __init__(self, *, n_vars, obs_noise=0.1, mean_edge=0.0, sig_edge=1.0,
                 min_edge=0.5):
        self.n_vars = n_vars
        self.obs_noise = obs_noise
        self.mean_edge = mean_edge
        self.sig_edge = sig_edge
        self.min_edge = min_edge

    def sample_parameters(self, *, generator, n_vars, n_particles=0,
                          batch_size=0, device="cpu"):
        """``theta`` from the edge prior; leading dims equal to 0 are dropped."""
        shape = tuple(s for s in (batch_size, n_particles, n_vars, n_vars)
                      if s != 0)
        theta = self.mean_edge + self.sig_edge * torch.randn(
            shape, generator=generator)
        return (theta + torch.sign(theta) * self.min_edge).to(device)

    def sample_obs(self, *, generator, n_samples, g, theta, interv=None):
        """Ancestral sampling of ``[n_samples, d]`` observations; ``g`` is a
        ``[d, d]`` adjacency matrix."""
        w = g.to(theta.dtype) * theta
        mask, values = interv_to_vectors(interv, self.n_vars, theta.device)
        return sample_sem_obs(
            generator=generator, n_samples=n_samples, n_vars=self.n_vars,
            mean_fn=lambda x: x @ w, obs_noise=self.obs_noise,
            interv_mask=mask, interv_values=values)
