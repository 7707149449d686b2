"""Plain PyTorch reference of joint DiBS with the nonlinear Gaussian model:
SVGD over ``(Z, Theta)`` where node ``j``'s mean is a dense MLP of its
parent-masked inputs (Lorch et al. 2021, section 5 and appendix B: widths
``d -> h_1 -> ... -> 1``, relu between layers, biases, additive Gaussian
noise of variance ``obs_noise``), every weight and bias with a ``N(0,
sig_param^2)`` prior, the first-layer rows of node ``j`` counted where
``g[i, j] = 1``.

For one graph ``G`` and one parameter tree ``Theta = [(W1 [d, d, h1], b1
[d, h1]), ..., (WL [d, h, 1], bL [d, 1])]`` (node axis first):

    mean = relu(x @ (G^T[..., None] * W1) + b1) ... @ WL + bL   [d, N] -> [N, d]
    log p(Theta, x | G) = sum G^T[..., None] log N(W1) + sum log N(other leaves)
                          + sum_{n, j} log N(x_nj; mean_nj, obs_noise)

The ``Z`` score is the Gumbel-softmax reparameterization estimator over
``M`` soft graphs ``sigmoid(tau (eps + alpha s))`` and the ``Theta``
score the hard-sample estimator over their thresholds ``eps + alpha s >
0`` (eqs. 9 and B.2), each the gradient of its samples' log-joints under
their softmax, by float64 autograd; then the scale-free or Erdos-Renyi
soft graph prior, the sampled NOTEARS acyclicity penalty, the Gaussian
latent prior, the additive SE kernel over ``[Z rows, Theta rows]`` and
rmsprop, as :mod:`portbench.reference.joint_linear`. Step ``t`` (``alpha =
alpha_linear t``, ``beta = beta_linear t``) draws its likelihood noise
from stream ``3 t`` and its acyclicity noise from stream ``3 t + 2``.

``Theta`` is kept as ``[P, n]`` rows: the leaves flattened and
concatenated in tree order (W1, b1, W2, b2, ...), the order the system
module gives the port's.

Departures from the paper, all the configuration's: one noise batch for
both scores (the hard samples are the thresholds of the soft samples'
noise, not a second draw); ``M`` and ``K`` the configuration's (32 and 8
at d = 50, not 128 and 32); the data the benchmark's linear-SEM rows, not
rows of an MLP SEM. Imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from portbench.datagen import particle_order
from portbench.reference import common
from portbench.reference.philox import logistic

__all__ = ["State", "Reference"]


class State(NamedTuple):
    t: int
    z: torch.Tensor  # [P, d, k, 2]
    theta: torch.Tensor  # [P, n] rows of the parameter tree
    nu_z: torch.Tensor
    nu_theta: torch.Tensor

    def leaves(self) -> dict:
        return {"z": self.z, "theta": self.theta, "nu_z": self.nu_z,
                "nu_theta": self.nu_theta}


class _TF32MatMul(torch.autograd.Function):
    """``a @ b`` (broadcasting) with the operands of the product and of
    both gradient products rounded to TF32: the control's matrix
    products, differentiable."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return common._round_tf32(a) @ common._round_tf32(b)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        grad = common._round_tf32(grad)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = (grad @ common._round_tf32(b).transpose(-1, -2)) \
                .sum_to_size(a.shape)
        if ctx.needs_input_grad[1]:
            gb = (common._round_tf32(a).transpose(-1, -2) @ grad) \
                .sum_to_size(b.shape)
        return ga, gb


class Reference:
    """The reference on the configuration ``cfg`` and data ``x [N, d]``,
    at precision ``prec``, on ``device``; ``chunk`` particles at a time
    through the likelihood and the acyclicity penalty. Follows the MLPs
    with relu and biases only."""

    def __init__(self, cfg: dict, x, prec: common.Precision, device,
                 chunk: int = 25):
        if cfg["activation"] != "relu" or not cfg["bias"]:
            raise ValueError("the reference follows relu MLPs with biases")
        self.cfg, self.prec, self.device, self.chunk = cfg, prec, device, chunk
        self.x = torch.as_tensor(x).to(device=device, dtype=prec.dtype)
        d = cfg["n_vars"]
        dims = (d, *cfg["hidden_layers"], 1)
        # each leaf's shape in tree order: (W, b) a layer
        self.shapes = [s for a, b in zip(dims[:-1], dims[1:])
                       for s in ((d, a, b), (d, b))]

    def _mm(self, a, b):
        return _TF32MatMul.apply(a, b) if self.prec.tf32 else a @ b

    def _tree(self, rows):
        """``[c, n]`` rows -> the leaves ``[c, *shape]`` (views)."""
        sizes = [math.prod(s) for s in self.shapes]
        return [part.reshape(rows.shape[0], *s) for part, s in
                zip(torch.split(rows, sizes, dim=1), self.shapes)]

    def init_state(self, seed: int) -> State:
        """The configuration's set of initial particles in the order
        :func:`portbench.datagen.particle_order` gives ``seed``: from one
        CPU ``torch.Generator`` seeded with its ``fixed_seed``, ``z ~ N(0,
        1/k)`` ``[P, d, k, 2]``, then the tree layer by layer (weights,
        then biases) ``~ N(0, sig_param^2)``, in float32."""
        cfg = self.cfg
        gen = torch.Generator().manual_seed(cfg["fixed_seed"])
        n_p, d, k = cfg["n_particles"], cfg["n_vars"], cfg["latent_dim"]
        z = torch.randn((n_p, d, k, 2), generator=gen) * (1.0 / math.sqrt(k))
        theta = torch.cat([
            (cfg["sig_param"] * torch.randn((n_p, *s), generator=gen))
            .reshape(n_p, -1) for s in self.shapes], dim=1)
        order = torch.as_tensor(particle_order(cfg, seed))
        z, theta = (v[order].to(device=self.device, dtype=self.prec.dtype)
                    for v in (z, theta))
        return State(0, z, theta, torch.zeros_like(z), torch.zeros_like(theta))

    def _log_joint(self, g, leaves):
        """``log p(Theta, x | G)`` ``[c, M]`` of graphs ``g [c, M, d, d]``
        with each particle's leaves ``[c, ...]``."""
        cfg, x = self.cfg, self.x
        sp, var = cfg["sig_param"], cfg["obs_noise"]

        def logpdf(v):
            return -0.5 * (v / sp) ** 2 - math.log(sp) - 0.5 * math.log(
                2 * math.pi)

        gt = g.transpose(-1, -2)[..., None]  # [c, M, j, i, 1]
        w1 = leaves[0][:, None]  # [c, 1, j, i, h1]
        prior = (gt * logpdf(w1)).sum((-3, -2, -1))
        for leaf in leaves[1:]:
            prior = prior + logpdf(leaf).reshape(leaf.shape[0], 1, -1).sum(-1)
        h = self._mm(x, gt * w1) + leaves[1][:, None, :, None, :]
        for w, b in zip(leaves[2::2], leaves[3::2]):  # [c, M, j, N, width]
            h = self._mm(torch.relu(h), w[:, None]) + b[:, None, :, None, :]
        mean = h[..., 0].transpose(-1, -2)  # [c, M, N, j]
        loglik = (-0.5 * (x - mean) ** 2 / var
                  - 0.5 * math.log(2 * math.pi * var)).sum((-2, -1))
        return prior + loglik

    def _weighted_grad(self, g, leaves, wrt):
        """``sum_m softmax(l)_m grad l_m`` of the log-joints ``l`` of
        ``g`` with respect to ``wrt``."""
        logp = self._log_joint(g, leaves)
        weights = torch.softmax(logp.detach(), dim=1)
        return torch.autograd.grad(logp, wrt, weights)[0]

    def _likelihood(self, s, theta, alpha, seed, stream):
        """``(d s [P, d, d], d Theta [P, n])`` of the likelihood."""
        cfg, prec = self.cfg, self.prec
        n_p, d, _ = s.shape
        m, tau = cfg["n_grad_mc_samples"], cfg["tau"]
        mask = common.offdiag(d, prec, s.device)
        d_s, d_theta = torch.empty_like(s), torch.empty_like(theta)
        with torch.enable_grad():
            for p0 in range(0, n_p, self.chunk):
                s_c = s[p0:p0 + self.chunk].detach()
                th_c = theta[p0:p0 + self.chunk].detach()
                n_c = s_c.shape[0]
                eps = logistic(n_c, m, d, seed, stream, s.device, prec.dtype,
                               first_particle=p0)
                s_req = s_c.clone().requires_grad_(True)
                soft = torch.sigmoid(tau * (eps + alpha * s_req[:, None])) \
                    * mask
                d_s[p0:p0 + n_c] = self._weighted_grad(
                    soft, self._tree(th_c), s_req)
                del soft
                hard = ((eps + alpha * s_c[:, None]) > 0).to(prec.dtype) * mask
                del eps
                th_req = th_c.clone().requires_grad_(True)
                d_theta[p0:p0 + n_c] = self._weighted_grad(
                    hard, self._tree(th_req), th_req)
        return d_s, d_theta

    def likelihood(self, z, theta, t: int, seed: int) -> dict:
        """The likelihood's scores at step ``t`` of the state ``(z,
        theta)`` (``theta`` as rows): ``dz`` (``d s`` chained to ``Z``) and
        ``dtheta`` (rows)."""
        z = z.to(device=self.device, dtype=self.prec.dtype)
        theta = theta.to(device=self.device, dtype=self.prec.dtype)
        d_s, d_theta = self._likelihood(common.scores(z, self.prec), theta,
                                        self.cfg["alpha_linear"] * t, seed,
                                        3 * t)
        return {"dz": common.chain(d_s, z, self.prec), "dtheta": d_theta}

    def step(self, st: State, seed: int) -> State:
        cfg, prec = self.cfg, self.prec
        t = st.t
        alpha, beta = cfg["alpha_linear"] * t, cfg["beta_linear"] * t
        n_p, d, k, _ = st.z.shape
        s = common.scores(st.z, prec)
        d_s, d_theta = self._likelihood(s, st.theta, alpha, seed, 3 * t)
        d_s = d_s + common.graph_prior_grad(s, alpha, cfg["graph_prior"],
                                            cfg["edges_per_node"])
        d_s = d_s - beta * common.acyclicity_grad(
            s, alpha, cfg["tau"], cfg["n_acyclicity_mc_samples"], seed,
            3 * t + 2, prec, self.chunk)
        d_z = common.chain(d_s, st.z, prec) - st.z * float(k)
        phi_z, phi_t = common.transport(
            [st.z.reshape(n_p, -1), st.theta], [d_z.reshape(n_p, -1), d_theta],
            [cfg["h_latent"], cfg["h_theta"]], prec)
        z, nu_z = common.rmsprop(st.z, st.nu_z, phi_z.reshape(st.z.shape),
                                 cfg["stepsize"])
        theta, nu_t = common.rmsprop(st.theta, st.nu_theta, phi_t,
                                     cfg["stepsize"])
        return State(t + 1, z, theta, nu_z, nu_t)
