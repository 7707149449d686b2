"""Synthetic ground truth and data of a configuration, from the run's seed.

A frozen copy of the synthetic Bayes-net generator of DiBS (Lorch et al.
2021): a random DAG from the configuration's graph prior (scale-free:
directed Barabasi-Albert preferential attachment with ``edges_per_node``
edges a new vertex, then a random relabelling; Erdos-Renyi: a strictly
lower-triangular Bernoulli matrix, relabelled), edge weights
``N(mean_edge, sig_edge^2)`` pushed ``min_edge`` away from 0, and
``n_observations`` rows of the linear SEM ``x = x (G * W) + e``, ``e ~ N(0,
obs_noise)``, by ``d`` fixed-point sweeps from 0 (exact on a DAG). All of it
from one numpy generator seeded with the configuration's ``fixed_seed``: a
configuration names one dataset, as the benchmark it was taken from does,
and the port and the reference are given the same.

The run's seed orders the initial particles (:func:`particle_order`) and
keys the engine's noise. The set of initial particles is the
configuration's too (drawn from ``fixed_seed``): how many parents the
sampled graphs of a particle have, and so the work of a step, depends on
the particle, and a set drawn anew from every seed would change the work
from seed to seed (by 1.8% of config 6's steps a second), where another
order of the same set does not.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["Data", "make_data", "particle_order"]


class Data(NamedTuple):
    g: np.ndarray  # [d, d] int32 ground-truth DAG, g[i, j] = 1 for i -> j
    theta: np.ndarray  # [d, d] float64 edge weights (all entries drawn)
    x: np.ndarray  # [N, d] float32 observations


def _scale_free(d: int, m: int, rng: np.random.Generator) -> np.ndarray:
    adj = np.zeros((d, d), dtype=np.int32)
    indeg = np.zeros(d, dtype=np.float64)
    for v in range(1, d):
        w = indeg[:v] + 1.0
        targets = rng.choice(v, size=min(m, v), replace=False, p=w / w.sum())
        adj[v, targets] = 1
        indeg[targets] += 1.0
    return adj


def _erdos_renyi(d: int, m: int, rng: np.random.Generator) -> np.ndarray:
    p = m * d / (d * (d - 1) / 2.0)
    return np.tril(rng.random((d, d)) < p, k=-1).astype(np.int32)


_GRAPHS = {"sf": _scale_free, "er": _erdos_renyi}


def particle_order(cfg: dict, seed: int) -> np.ndarray:
    """The order of the configuration's initial particles in the run keyed
    by ``seed``: a permutation of ``n_particles``."""
    return np.random.default_rng(seed).permutation(cfg["n_particles"])


def make_data(cfg: dict) -> Data:
    """The ground truth and the observations of configuration ``cfg`` (its
    ``fixed_seed``, ``graph_prior``, ``n_vars``, ``edges_per_node``,
    ``n_observations``, ``obs_noise``, ``mean_edge``, ``sig_edge``,
    ``min_edge``)."""
    rng = np.random.default_rng(cfg["fixed_seed"])
    d = cfg["n_vars"]
    adj = _GRAPHS[cfg["graph_prior"]](d, cfg["edges_per_node"], rng)
    perm = rng.permutation(d)
    g = np.zeros_like(adj)
    g[np.ix_(perm, perm)] = adj
    theta = cfg["mean_edge"] + cfg["sig_edge"] * rng.standard_normal((d, d))
    theta = theta + np.sign(theta) * cfg["min_edge"]
    noise = np.sqrt(cfg["obs_noise"]) * rng.standard_normal(
        (cfg["n_observations"], d))
    w = g * theta
    x = np.zeros_like(noise)
    for _ in range(d):
        x = x @ w + noise
    return Data(g=g, theta=theta, x=x.astype(np.float32))
