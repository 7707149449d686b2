"""Random-DAG prior distributions (PyTorch twin of ``dibs_tpu/models/graph.py``). Only the Erdos-Renyi prior is ported so far.

The inference engine needs one method, ``unnormalized_log_prob_soft(soft_g)``,
differentiable through autograd. Here it reduces over the trailing ``[d, d]``
block, so it also takes a particle batch ``[P, d, d]`` and returns ``[P]``.
"""
from __future__ import annotations

import math

import torch

__all__ = ["ErdosReniDAGDistribution"]


class ErdosReniDAGDistribution:
    """Erdos-Renyi random DAG with i.i.d. edge probability ``p`` chosen to
    give ``n_edges_per_node`` edges per node in expectation."""

    def __init__(self, n_vars, n_edges_per_node=2):
        self.n_vars = n_vars
        self.n_edges = n_edges_per_node * n_vars
        self.p = self.n_edges / ((self.n_vars * (self.n_vars - 1)) / 2)

    def sample_G(self, generator: torch.Generator, device="cpu") -> torch.Tensor:
        """One DAG as a ``[d, d]`` int32 adjacency matrix: a Bernoulli matrix,
        strictly lower-triangular, conjugated by a random permutation."""
        d = self.n_vars
        probs = torch.full((d, d), self.p)
        mat = torch.bernoulli(probs, generator=generator).to(torch.int32)
        dag = torch.tril(mat, diagonal=-1)
        perm = torch.randperm(d, generator=generator)
        p_mat = torch.eye(d, dtype=torch.int32)[perm]
        return (p_mat.T @ dag @ p_mat).to(device)

    def unnormalized_log_prob_soft(self, *, soft_g):
        """Relaxed ``log p(G)`` on an edge-probability matrix ``[..., d, d]``."""
        n_pairs = self.n_vars * (self.n_vars - 1) / 2.0
        e_soft = soft_g.sum(dim=(-2, -1))
        return e_soft * math.log(self.p) + (n_pairs - e_soft) * math.log(
            1 - self.p)
