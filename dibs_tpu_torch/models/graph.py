"""Random-DAG prior distributions (PyTorch twin of ``dibs_tpu/models/graph.py``):
Erdos-Renyi, scale-free and the uniform rejection sampler.

The inference engine needs one method, ``unnormalized_log_prob_soft(soft_g)``,
differentiable through autograd. It, ``unnormalized_log_prob(g)`` and
``unnormalized_log_prob_single(g, j)`` reduce over the trailing ``[d, d]``
block, so they also take a batch ``[P, d, d]`` and return ``[P]``.
``sample_G`` draws from the caller's CPU ``torch.Generator`` and moves the
``[d, d]`` int32 adjacency matrix to ``device``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from dibs_tpu_torch.config import DEFAULT_DEVICE, resolve_device
from dibs_tpu_torch.ops.acyclic import acyclic_constr
from dibs_tpu_torch.utils.func import zero_diagonal

__all__ = [
    "ErdosReniDAGDistribution",
    "ScaleFreeDAGDistribution",
    "UniformDAGDistributionRejection",
    "barabasi_albert",
    "permute_vertices",
]


def _permutation_matrix(perm: torch.Tensor) -> torch.Tensor:
    return torch.eye(perm.shape[0], dtype=torch.int32)[perm]


class ErdosReniDAGDistribution:
    """Erdos-Renyi random DAG with i.i.d. edge probability ``p`` chosen to
    give ``n_edges_per_node`` edges per node in expectation."""

    def __init__(self, n_vars, n_edges_per_node=2):
        self.n_vars = n_vars
        self.n_edges = n_edges_per_node * n_vars
        self.p = self.n_edges / ((self.n_vars * (self.n_vars - 1)) / 2)

    def sample_G(self, generator: torch.Generator, return_mat=True,
                 device=DEFAULT_DEVICE) -> torch.Tensor:
        """One DAG as a ``[d, d]`` int32 adjacency matrix: a Bernoulli matrix,
        strictly lower-triangular, conjugated by a random permutation.
        ``return_mat`` is accepted, as in the reference, which always
        returns matrices."""
        device = resolve_device(device)
        d = self.n_vars
        probs = torch.full((d, d), self.p)
        mat = torch.bernoulli(probs, generator=generator).to(torch.int32)
        dag = torch.tril(mat, diagonal=-1)
        p_mat = _permutation_matrix(torch.randperm(d, generator=generator))
        return (p_mat.T @ dag @ p_mat).to(device)

    def unnormalized_log_prob_single(self, *, g, j):
        """Unnormalized ``log p(G_j)`` of node ``j``'s family."""
        n_parents = g[..., :, j].sum(-1)
        return n_parents * math.log(self.p) + (
            self.n_vars - n_parents - 1) * math.log(1 - self.p)

    def unnormalized_log_prob(self, *, g):
        """Unnormalized ``log p(G)`` of hard adjacencies ``[..., d, d]``."""
        return self.unnormalized_log_prob_soft(soft_g=g)

    def unnormalized_log_prob_soft(self, *, soft_g):
        """Relaxed ``log p(G)`` on an edge-probability matrix ``[..., d, d]``."""
        n_pairs = self.n_vars * (self.n_vars - 1) / 2.0
        e_soft = soft_g.sum(dim=(-2, -1))
        return e_soft * math.log(self.p) + (n_pairs - e_soft) * math.log(
            1 - self.p)


def barabasi_albert(n: int, m: int, rng: np.random.Generator) -> np.ndarray:
    """Directed Barabasi-Albert DAG (numpy): vertex ``v``, added in index
    order, draws ``min(m, v)`` distinct targets among ``0..v-1`` with
    probability proportional to ``in_degree + 1`` and adds ``v -> target``.
    Edges run from later to earlier vertices, so the result is a DAG."""
    adj = np.zeros((n, n), dtype=np.int32)
    indeg = np.zeros(n, dtype=np.float64)
    for v in range(1, n):
        k = min(m, v)
        w = indeg[:v] + 1.0
        targets = rng.choice(v, size=k, replace=False, p=w / w.sum())
        adj[v, targets] = 1
        indeg[targets] += 1.0
    return adj


def permute_vertices(mat: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """Relabels vertex ``i`` as ``perm[i]``: ``out[perm[i], perm[j]] = mat[i, j]``."""
    out = np.zeros_like(mat)
    out[np.ix_(perm, perm)] = mat
    return out


class ScaleFreeDAGDistribution:
    """Scale-free random DAG with the power-law in-degree prior
    ``p(G) ∝ prod_j (1 + deg_in(j))^(-3)``. Sampling: Barabasi-Albert
    preferential attachment, then a random vertex permutation."""

    def __init__(self, n_vars, verbose=False, n_edges_per_node=2):
        self.n_vars = n_vars
        self.n_edges_per_node = n_edges_per_node
        self.verbose = verbose

    def sample_G(self, generator: torch.Generator, return_mat=True,
                 device=DEFAULT_DEVICE) -> torch.Tensor:
        """One DAG as a ``[d, d]`` int32 adjacency matrix; the numpy sampler
        is seeded from ``generator``. ``return_mat`` as in
        :meth:`ErdosReniDAGDistribution.sample_G`."""
        device = resolve_device(device)
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
        mat = barabasi_albert(self.n_vars, self.n_edges_per_node,
                              np.random.default_rng(seed))
        perm = torch.randperm(self.n_vars, generator=generator).numpy()
        return torch.from_numpy(permute_vertices(mat, perm)).to(device)

    def unnormalized_log_prob_single(self, *, g, j):
        """Unnormalized ``log p(G_j)`` of node ``j``'s family."""
        return -3.0 * torch.log(1 + g[..., :, j].sum(-1))

    def unnormalized_log_prob(self, *, g):
        """Unnormalized ``log p(G)`` of hard adjacencies ``[..., d, d]``."""
        return self.unnormalized_log_prob_soft(soft_g=g)

    def unnormalized_log_prob_soft(self, *, soft_g):
        """Relaxed in-degree power-law prior on ``[..., d, d]`` edge
        probabilities."""
        soft_indegree = soft_g.sum(dim=-2)
        return (-3.0 * torch.log(1 + soft_indegree)).sum(dim=-1)


class UniformDAGDistributionRejection:
    """Uniform distribution over DAGs by rejection sampling (feasible for
    ``d <= 5``)."""

    def __init__(self, n_vars):
        self.n_vars = n_vars

    def sample_G(self, generator: torch.Generator, return_mat=True,
                 device=DEFAULT_DEVICE) -> torch.Tensor:
        """One DAG as a ``[d, d]`` int32 adjacency matrix by rejection;
        ``return_mat`` as in :meth:`ErdosReniDAGDistribution.sample_G`."""
        device = resolve_device(device)
        d = self.n_vars
        while True:
            mat = zero_diagonal(torch.bernoulli(
                torch.full((d, d), 0.5), generator=generator))
            # h(G) is exactly 0 for a 0/1 DAG and positive otherwise
            if float(acyclic_constr(mat, d)) == 0.0:
                return mat.to(torch.int32).to(device)

    def unnormalized_log_prob_single(self, *, g, j):
        return torch.zeros(g.shape[:-2], dtype=torch.float32, device=g.device)

    def unnormalized_log_prob(self, *, g):
        return torch.zeros(g.shape[:-2], dtype=torch.float32, device=g.device)

    def unnormalized_log_prob_soft(self, *, soft_g):
        return torch.zeros(soft_g.shape[:-2], dtype=soft_g.dtype,
                           device=soft_g.device)
