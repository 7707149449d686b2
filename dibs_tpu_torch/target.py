"""Synthetic ground-truth targets and model factories (PyTorch twin of
``dibs_tpu/target.py``): the Erdos-Renyi, scale-free and uniform graph
priors, the BGe factory for ``MarginalDiBS`` and the linear-Gaussian factory
for ``JointDiBS``.

All randomness comes from an explicit CPU ``torch.Generator``; the results
are moved to ``device``.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from dibs_tpu_torch.config import DEFAULT_DEVICE, resolve_device
from dibs_tpu_torch.models.graph import (
    ErdosReniDAGDistribution,
    ScaleFreeDAGDistribution,
    UniformDAGDistributionRejection,
)
from dibs_tpu_torch.models.linear_gaussian import BGe, LinearGaussian

__all__ = [
    "Data",
    "make_synthetic_bayes_net",
    "make_graph_model",
    "make_linear_gaussian_equivalent_model",
    "make_linear_gaussian_model",
]


class Data(NamedTuple):
    """Simulated data plus its ground-truth model (fields as in the
    reference; ``passed_key`` holds the generator's initial seed)."""

    passed_key: Any
    n_vars: int
    n_observations: int
    n_ho_observations: int
    g: Any
    theta: Any
    x: Any
    x_ho: Any
    x_interv: Any


def make_synthetic_bayes_net(*, generator: torch.Generator, n_vars,
                             graph_model, generative_model,
                             n_observations=100, n_ho_observations=100,
                             n_intervention_sets=10, perc_intervened=0.1,
                             device=DEFAULT_DEVICE):
    """Samples a ground-truth BN plus observational and interventional data:
    ``n_intervention_sets`` clamp-to-zero interventions, each on
    ``ceil(perc_intervened * d)`` distinct nodes."""
    device = resolve_device(device)
    passed_key = generator.initial_seed()
    g_gt = graph_model.sample_G(generator, device=device)
    theta = generative_model.sample_parameters(generator=generator,
                                               n_vars=n_vars, device=device)
    x = generative_model.sample_obs(generator=generator,
                                    n_samples=n_observations, g=g_gt,
                                    theta=theta)
    x_ho = generative_model.sample_obs(generator=generator,
                                       n_samples=n_ho_observations, g=g_gt,
                                       theta=theta)
    x_interv = []
    n_interv = math.ceil(n_vars * perc_intervened)
    for _ in range(n_intervention_sets):
        targets = torch.randperm(n_vars, generator=generator)[:n_interv]
        interv = {int(k): 0.0 for k in targets}
        x_interv_ = generative_model.sample_obs(
            generator=generator, n_samples=n_observations, g=g_gt,
            theta=theta, interv=interv)
        x_interv.append((interv, x_interv_))
    return Data(passed_key=passed_key, n_vars=n_vars,
                n_observations=n_observations,
                n_ho_observations=n_ho_observations, g=g_gt, theta=theta,
                x=x, x_ho=x_ho, x_interv=x_interv)


def make_graph_model(*, n_vars, graph_prior_str, edges_per_node=2):
    """``'er'`` / ``'sf'`` dispatch; anything else falls back to the uniform
    rejection sampler (feasible only for ``d <= 5``)."""
    if graph_prior_str == "er":
        return ErdosReniDAGDistribution(n_vars=n_vars,
                                        n_edges_per_node=edges_per_node)
    if graph_prior_str == "sf":
        return ScaleFreeDAGDistribution(n_vars=n_vars,
                                        n_edges_per_node=edges_per_node)
    if n_vars > 5:
        raise ValueError("naive uniform DAG sampling is only possible up to "
                         f"5 nodes, got n_vars={n_vars}")
    return UniformDAGDistributionRejection(n_vars=n_vars)


def make_linear_gaussian_equivalent_model(
        *, generator: torch.Generator, n_vars=20, graph_prior_str="sf",
        bge_mean_obs=None, bge_alpha_mu=None, bge_alpha_lambd=None,
        obs_noise=0.1, mean_edge=0.0, sig_edge=1.0, min_edge=0.5,
        n_observations=100, n_ho_observations=100, device=DEFAULT_DEVICE):
    """Linear-Gaussian ground truth scored with BGe (for MarginalDiBS).

    Returns ``(data, graph_model, likelihood_model)``.
    """
    graph_model = make_graph_model(n_vars=n_vars,
                                   graph_prior_str=graph_prior_str)
    generative_model = LinearGaussian(n_vars=n_vars, obs_noise=obs_noise,
                                      mean_edge=mean_edge, sig_edge=sig_edge,
                                      min_edge=min_edge)
    likelihood_model = BGe(n_vars=n_vars, mean_obs=bge_mean_obs,
                           alpha_mu=bge_alpha_mu, alpha_lambd=bge_alpha_lambd,
                           device=device)
    data = make_synthetic_bayes_net(
        generator=generator, n_vars=n_vars, graph_model=graph_model,
        generative_model=generative_model, n_observations=n_observations,
        n_ho_observations=n_ho_observations, device=device)
    return data, graph_model, likelihood_model


def make_linear_gaussian_model(
        *, generator: torch.Generator, n_vars=20, graph_prior_str="sf",
        obs_noise=0.1, mean_edge=0.0, sig_edge=1.0, min_edge=0.5,
        n_observations=100, n_ho_observations=100, device=DEFAULT_DEVICE):
    """Linear-Gaussian ground truth with the same model family as the
    likelihood (for JointDiBS).

    Returns ``(data, graph_model, likelihood_model)``.
    """
    graph_model = make_graph_model(n_vars=n_vars,
                                   graph_prior_str=graph_prior_str)
    kw = dict(n_vars=n_vars, obs_noise=obs_noise, mean_edge=mean_edge,
              sig_edge=sig_edge, min_edge=min_edge)
    data = make_synthetic_bayes_net(
        generator=generator, n_vars=n_vars, graph_model=graph_model,
        generative_model=LinearGaussian(**kw), n_observations=n_observations,
        n_ho_observations=n_ho_observations, device=device)
    return data, graph_model, LinearGaussian(**kw)
