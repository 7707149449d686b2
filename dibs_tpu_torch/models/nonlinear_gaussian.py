"""Nonlinear Gaussian SEM with per-node MLP conditionals (PyTorch twin of
``dibs_tpu/models/nonlinear_gaussian.py``).

Node ``j``'s mean is a dense MLP of the parent-masked observations
``x * g[:, j]``; the noise is additive Gaussian with variance ``obs_noise``;
every weight and bias has a ``N(0, sig_param^2)`` prior, the first-layer
rows of node ``j`` counted only where ``g[i, j]``.

Parameter tree (``bias=True``; with ``bias=False`` each entry is ``(W_i,)``)::

    [(W_1 [..., d, d, h1], b_1 [..., d, h1]),
     (W_2 [..., d, h1, h2], b_2 [..., d, h2]),
     ...,
     (W_L [..., d, h_{L-1}, 1], b_L [..., d, 1])]

with optional leading batch dims ``...`` (particles, samples) and the node
axis ``d`` first after them. The scoring functions broadcast graphs
``[..., d, d]`` against parameter leaves with broadcastable leading dims:
the generic estimators pass ``[P, M, d, d]`` graphs with ``[P, 1, ...]``
leaves, the mixture ``[P, d, d]`` with ``[P, ...]``. The forward runs in
full float32 matmuls, layout ``[..., node, N, width]``.
"""
from __future__ import annotations

import math

import torch

from dibs_tpu_torch.config import DEFAULT_DEVICE, resolve_device
from dibs_tpu_torch.models.linear_gaussian import _normal_logpdf
from dibs_tpu_torch.ops.ancestral import interv_to_vectors, sample_sem_obs

__all__ = ["ACTIVATIONS", "DenseNonlinearGaussian"]

ACTIVATIONS = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "leakyrelu": lambda v: torch.nn.functional.leaky_relu(v, 0.01),
}


class DenseNonlinearGaussian:
    """Nonlinear Gaussian BN with per-node dense-MLP conditional means.

    Args:
        n_vars: number of variables ``d``
        hidden_layers: hidden-layer widths, e.g. ``(5,)``
        obs_noise: additive observation-noise variance
        sig_param: std dev of the Gaussian prior over weights and biases
        activation: ``sigmoid``, ``tanh``, ``relu`` or ``leakyrelu``
        bias: whether the layers carry biases
    """

    def __init__(self, *, n_vars, hidden_layers, obs_noise=0.1, sig_param=1.0,
                 activation="relu", bias=True):
        if activation not in ACTIVATIONS:
            raise KeyError(f"Invalid activation function `{activation}`")
        self.n_vars = n_vars
        self.obs_noise = obs_noise
        self.sig_param = sig_param
        self.hidden_layers = tuple(hidden_layers)
        self.activation = activation
        self.bias = bias
        self._act = ACTIVATIONS[activation]
        self._dims = (n_vars, *self.hidden_layers, 1)

    def get_theta_shape(self, *, n_vars):
        """The parameter tree of one particle, with each leaf's shape."""
        del n_vars
        d = self.n_vars
        return [((d, a, b), (d, b)) if self.bias else ((d, a, b),)
                for a, b in zip(self._dims[:-1], self._dims[1:])]

    def sample_parameters(self, *, generator, n_vars, n_particles=0,
                          batch_size=0, device=DEFAULT_DEVICE):
        """Parameters from the prior with leading dims ``(batch_size,
        n_particles, d)`` (dims equal to 0 are dropped), drawn on the CPU
        from ``generator`` layer by layer (weights, then biases) and moved
        to ``device``."""
        del n_vars
        device = resolve_device(device)
        lead = tuple(s for s in (batch_size, n_particles) if s != 0) + (
            self.n_vars,)
        params = []
        for a, b in zip(self._dims[:-1], self._dims[1:]):
            w = self.sig_param * torch.randn(lead + (a, b), generator=generator)
            if self.bias:
                bias = self.sig_param * torch.randn(lead + (b,),
                                                    generator=generator)
                params.append((w.to(device), bias.to(device)))
            else:
                params.append((w.to(device),))
        return params

    # --- forward pass ---

    def all_node_means(self, theta, x, g):
        """Conditional means of all nodes, ``[..., N, d]``.

        The parent mask is applied to the first-layer weights,
        ``(x * g[:, j]) @ W1_j == x @ (g[:, j, None] * W1_j)``, so the first
        layer is one ``[N, d] @ [..., d, d, h1]`` matmul for every node.
        """
        w1 = theta[0][0]  # [..., j, i, h1]
        h = x @ (g.transpose(-1, -2)[..., None] * w1)  # [..., j, N, h1]
        if self.bias:
            h = h + theta[0][1][..., None, :]
        for layer in theta[1:]:
            h = self._act(h) @ layer[0]
            if self.bias:
                h = h + layer[1][..., None, :]
        return h[..., 0].transpose(-1, -2)

    # --- generative sampling ---

    def sample_obs(self, *, generator, n_samples, g, theta, interv=None):
        """Ancestral sampling of ``[n_samples, d]`` observations for one
        particle's ``theta`` and a ``[d, d]`` adjacency ``g``. Parentless
        nodes are pure noise ``N(0, obs_noise)`` (their MLP, bias included,
        is bypassed, as in the reference); intervened nodes are clamped."""
        g = g.to(torch.float32)
        has_parents = (g.sum(0) > 0).to(torch.float32)
        mask, values = interv_to_vectors(interv, self.n_vars, g.device)
        return sample_sem_obs(
            generator=generator, n_samples=n_samples, n_vars=self.n_vars,
            mean_fn=lambda x: self.all_node_means(theta, x, g) * has_parents,
            obs_noise=self.obs_noise, interv_mask=mask, interv_values=values)

    # --- scoring ---

    def log_prob_parameters(self, *, theta, g):
        """``log p(Theta | G)``: Gaussian over every leaf, the first-layer
        weight row of input ``i`` of node ``j`` weighted by ``g[i, j]``
        (soft graphs too)."""
        sp = self.sig_param
        first_w = _normal_logpdf(theta[0][0], 0.0, sp) \
            * g.transpose(-1, -2)[..., None]
        total = first_w.sum((-3, -2, -1))
        for i, layer in enumerate(theta):
            for k, leaf in enumerate(layer):
                if i == 0 and k == 0:
                    continue
                dims = (-3, -2, -1) if k == 0 else (-2, -1)
                total = total + _normal_logpdf(leaf, 0.0, sp).sum(dims)
        return total

    def log_likelihood(self, *, x, theta, g, interv_targets):
        """``log p(D | G, Theta)`` with the intervened entries masked out."""
        if tuple(x.shape) != tuple(interv_targets.shape):
            raise ValueError(f"x {tuple(x.shape)} and interv_targets "
                             f"{tuple(interv_targets.shape)} must match")
        means = self.all_node_means(theta, x, g)
        logpdf = _normal_logpdf(x, means, math.sqrt(self.obs_noise))
        logpdf = torch.where(interv_targets.bool(), torch.zeros_like(logpdf),
                             logpdf)
        return logpdf.sum((-2, -1))

    def interventional_log_joint_prob(self, g, theta, x, interv_targets, rng):
        """Joint ``log p(Theta, D | G)`` over broadcasting leading dims;
        ``rng`` is unused."""
        return (self.log_prob_parameters(theta=theta, g=g)
                + self.log_likelihood(x=x, theta=theta, g=g,
                                      interv_targets=interv_targets))
