"""Plain PyTorch reference of marginal DiBS with the BGe score: SVGD over
``Z`` with the REINFORCE (``score``) estimator of the marginal-likelihood
gradient over ``M`` hard Gumbel-max graphs a particle, the scale-free or
Erdos-Renyi soft graph prior, the sampled NOTEARS acyclicity penalty, the
Gaussian latent prior, the SE kernel and rmsprop (Lorch et al. 2021).

Step ``t`` (``alpha = alpha_linear t``, ``beta = beta_linear t``) draws
its hard graphs from noise stream ``2 t`` and its acyclicity samples from
``2 t + 1``. The ``Z`` score of the likelihood is the self-normalised
ratio ``sum_m softmax(log p(D | G_m))_m grad_Z log p(G_m | Z) = chain(alpha
(sum_m w_m G_m - sigmoid(alpha s)))``.

The BGe node score (Geiger and Heckerman 2002, with the correction of
Kuipers et al. 2014) of node ``j`` with parents ``Pa``:

    0.5 (log a_mu - log(N + a_mu)) + lgamma((N + a_l - d + |Pa| + 1) / 2)
    - lgamma((a_l - d + |Pa| + 1) / 2) - (N / 2) log pi
    + ((a_l - d + 2 |Pa| + 1) / 2) log t
    + ((N + a_l - d + |Pa|) / 2) logdet R[Pa, Pa]
    - ((N + a_l - d + |Pa| + 1) / 2) logdet R[Pa + j, Pa + j]

with ``t = a_mu (a_l - d - 1) / (a_mu + 1)`` and ``R = t I + S_N + (N a_mu /
(N + a_mu)) (xbar - mu)(xbar - mu)^T``. ``R`` is accumulated in float64 and
held at float32, the precision the configuration states for its data and
statistics; the determinants come from a Cholesky factor of each
``R[Pa + j, Pa + j]`` with ``j`` last, in the reference's precision,
(graph, node) pairs grouped by their parent count. Imports nothing of the
program.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from portbench.reference import common
from portbench.reference.philox import logistic

__all__ = ["State", "Reference"]


class State(NamedTuple):
    t: int
    z: torch.Tensor  # [P, d, k, 2]
    nu_z: torch.Tensor

    def leaves(self) -> dict:
        return {"z": self.z, "nu_z": self.nu_z}


class Reference:
    """The reference on the configuration ``cfg`` and data ``x [N, d]``,
    at precision ``prec``, on ``device``; ``chunk`` particles at a time
    through the hard graphs and the acyclicity penalty, ``pair_chunk``
    (graph, node) pairs a Cholesky call."""

    def __init__(self, cfg: dict, x, prec: common.Precision, device,
                 chunk: int = 25, pair_chunk: int = 1 << 15):
        self.cfg, self.prec, self.device = cfg, prec, device
        self.chunk, self.pair_chunk = chunk, pair_chunk
        x = torch.as_tensor(x).to(device=device, dtype=torch.float64)
        n_obs, d = x.shape
        a_mu, a_l = cfg["bge_alpha_mu"], cfg["bge_alpha_lambd"]
        self.small_t = a_mu * (a_l - d - 1) / (a_mu + 1)
        xbar = x.mean(0)
        xc = x - xbar
        r = (self.small_t * torch.eye(d, dtype=x.dtype, device=device)
             + xc.T @ xc
             + (n_obs * a_mu / (n_obs + a_mu)) * torch.outer(xbar, xbar))
        self.r = r.to(torch.float32).to(prec.dtype)
        self.n_obs = n_obs

    def init_state(self, seed: int) -> State:
        z, _ = common.init_particles(self.cfg, seed, self.prec, self.device,
                                     with_theta=False)
        return State(0, z, torch.zeros_like(z))

    def _gamma_terms(self, n_parents: torch.Tensor) -> torch.Tensor:
        cfg, n = self.cfg, float(self.n_obs)
        d = cfg["n_vars"]
        a_mu, a_l = cfg["bge_alpha_mu"], cfg["bge_alpha_lambd"]
        k = n_parents.to(torch.float64)
        return (0.5 * (math.log(a_mu) - math.log(n + a_mu))
                + torch.lgamma(0.5 * (n + a_l - d + k + 1))
                - torch.lgamma(0.5 * (a_l - d + k + 1))
                - 0.5 * n * math.log(math.pi)
                + 0.5 * (a_l - d + 2 * k + 1) * math.log(self.small_t))

    def log_marginal(self, graphs: torch.Tensor) -> torch.Tensor:
        """``log p(D | G)`` of hard graphs ``[B, d, d]`` -> ``[B]``
        (float64)."""
        cfg = self.cfg
        b, d, _ = graphs.shape
        n, a_l = float(self.n_obs), cfg["bge_alpha_lambd"]
        parents = graphs.transpose(-1, -2).reshape(b * d, d) > 0  # [pair, i]
        counts = parents.sum(-1)
        node = torch.arange(d, device=graphs.device).repeat(b)
        scores = self._gamma_terms(counts)
        for k in torch.unique(counts).tolist():
            idx_k = torch.nonzero(counts == k).flatten()
            for c0 in range(0, idx_k.numel(), self.pair_chunk):
                idx = idx_k[c0:c0 + self.pair_chunk]
                # the parents in order, then the node: [pairs, k + 1]
                order = node[idx, None]
                if k:
                    order = torch.cat([torch.nonzero(parents[idx])[:, 1]
                                       .view(-1, k), order], dim=1)
                sub = self.r[order[:, :, None], order[:, None, :]]
                chol = torch.linalg.cholesky_ex(sub).L
                log_diag = 2.0 * torch.log(torch.diagonal(chol, dim1=-2,
                                                          dim2=-1))
                logdet_pa = log_diag[:, :k].sum(-1).to(torch.float64)
                logdet_paj = logdet_pa + log_diag[:, k].to(torch.float64)
                scores[idx] += (0.5 * (n + a_l - d + k) * logdet_pa
                                - 0.5 * (n + a_l - d + k + 1) * logdet_paj)
        return scores.view(b, d).sum(-1)

    def _likelihood(self, s, alpha: float, seed: int, t: int):
        """``d s`` of the likelihood's REINFORCE ratio, ``[P, d, d]``."""
        prec = self.prec
        n_p, d, _ = s.shape
        m = self.cfg["n_grad_mc_samples"]
        mask = common.offdiag(d, prec, s.device)
        hard = torch.empty((n_p, m, d, d), dtype=torch.bool, device=s.device)
        for p0 in range(0, n_p, self.chunk):
            a_s = alpha * s[p0:p0 + self.chunk]
            eps = logistic(a_s.shape[0], m, d, seed, 2 * t, s.device,
                           prec.dtype, first_particle=p0)
            hard[p0:p0 + self.chunk] = ((eps + a_s[:, None]) > 0) & (mask > 0)
            del eps
        logp = self.log_marginal(hard.view(-1, d, d)).view(n_p, m)
        w = torch.softmax(logp, dim=1).to(prec.dtype)
        g_bar = torch.einsum("pm,pmij->pij", w, hard.to(prec.dtype))
        return alpha * (g_bar - torch.sigmoid(alpha * s) * mask)

    def likelihood(self, z, theta, t: int, seed: int) -> dict:
        """The likelihood's ``Z`` score at step ``t`` of the state ``z``
        (``theta`` is ``None``): ``dz``."""
        z = z.to(device=self.device, dtype=self.prec.dtype)
        d_s = self._likelihood(common.scores(z, self.prec),
                               self.cfg["alpha_linear"] * t, seed, t)
        return {"dz": common.chain(d_s, z, self.prec)}

    def step(self, st: State, seed: int) -> State:
        cfg, prec = self.cfg, self.prec
        t = st.t
        alpha, beta = cfg["alpha_linear"] * t, cfg["beta_linear"] * t
        n_p, d, k, _ = st.z.shape
        s = common.scores(st.z, prec)
        d_s = self._likelihood(s, alpha, seed, t)
        d_s = d_s + common.graph_prior_grad(s, alpha, cfg["graph_prior"],
                                            cfg["edges_per_node"])
        d_s = d_s - beta * common.acyclicity_grad(
            s, alpha, cfg["tau"], cfg["n_acyclicity_mc_samples"], seed,
            2 * t + 1, prec, self.chunk)
        d_z = common.chain(d_s, st.z, prec) - st.z * float(k)
        (phi_z,) = common.transport([st.z.reshape(n_p, -1)],
                                    [d_z.reshape(n_p, -1)],
                                    [cfg["h_latent"]], prec)
        z, nu_z = common.rmsprop(st.z, st.nu_z, phi_z.reshape(st.z.shape),
                                 cfg["stepsize"])
        return State(t + 1, z, nu_z)
