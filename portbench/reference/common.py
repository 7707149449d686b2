"""Plain PyTorch pieces shared by the DiBS references: the arithmetic
precision, the latent-to-score map and its chain rule, the graph priors'
score gradients, the NOTEARS acyclicity gradient over sampled soft graphs,
the SVGD transport with the additive SE kernel, and rmsprop.

Every function computes in the precision it is given (:class:`Precision`):
the reference runs in float64; the control of the correctness check runs
the same code in float32 with every matrix product's operands rounded to
TF32 (10 mantissa bits), the precision a float32 program reaches by
turning TF32 on.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from portbench.datagen import particle_order
from portbench.reference.philox import logistic

__all__ = ["Precision", "REFERENCE", "CONTROL", "chain", "graph_prior_grad",
           "acyclicity_grad", "transport", "rmsprop", "init_particles"]


class Precision(NamedTuple):
    dtype: torch.dtype
    tf32: bool  # matrix products on TF32-rounded operands

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            a, b = _round_tf32(a), _round_tf32(b)
        return a @ b


REFERENCE = Precision(torch.float64, False)
CONTROL = Precision(torch.float32, True)


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to the nearest TF32 value (ties to even)."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def offdiag(d: int, prec: Precision, device) -> torch.Tensor:
    return 1.0 - torch.eye(d, dtype=prec.dtype, device=device)


def scores(z: torch.Tensor, prec: Precision) -> torch.Tensor:
    """``s_ij = u_i . v_j`` of ``z [P, d, k, 2]``."""
    return prec.mm(z[..., 0], z[..., 1].transpose(-1, -2))


def chain(dscores: torch.Tensor, z: torch.Tensor,
          prec: Precision) -> torch.Tensor:
    """``d s -> d z``: ``d u = d s v``, ``d v = d s^T u``."""
    return torch.stack([prec.mm(dscores, z[..., 1]),
                        prec.mm(dscores.transpose(-1, -2), z[..., 0])], -1)


def graph_prior_grad(s: torch.Tensor, alpha: float, prior: str,
                     n_edges_per_node: int) -> torch.Tensor:
    """``d log p(G = sigmoid(alpha s)) / d s`` of the soft graph prior: the
    scale-free in-degree power law ``-3 sum_j log(1 + sum_i p_ij)``, or the
    Erdos-Renyi ``sum p log q + (n_pairs - sum p) log (1 - q)``."""
    d = s.shape[-1]
    p = torch.sigmoid(alpha * s) * offdiag(d, Precision(s.dtype, False),
                                           s.device)
    if prior == "sf":
        dp = (-3.0 / (1.0 + p.sum(-2, keepdim=True))).expand_as(p)
    else:
        q = n_edges_per_node * d / (d * (d - 1) / 2.0)
        dp = torch.full_like(p, math.log(q) - math.log(1.0 - q))
    return dp * alpha * p * (1.0 - p) * offdiag(d, Precision(s.dtype, False),
                                                 s.device)


def _matrix_power(m: torch.Tensor, n: int, prec: Precision) -> torch.Tensor:
    result = None
    while n > 0:
        if n & 1:
            result = m if result is None else prec.mm(result, m)
        n >>= 1
        if n:
            m = prec.mm(m, m)
    return result


def acyclicity_grad(s: torch.Tensor, alpha: float, tau: float, n_samples: int,
                    seed: int, stream: int, prec: Precision,
                    chunk: int) -> torch.Tensor:
    """``d E_g[h(g)] / d s`` over ``n_samples`` soft graphs ``g =
    sigmoid(tau (eps + alpha s))`` (zero diagonal) of the noise stream,
    ``h(g) = tr[(I + g/d)^d] - d``: ``(1/K) sum_k ((I + g/d)^(d-1))^T tau
    alpha g (1 - g)``, ``chunk`` particles at a time."""
    n_p, d, _ = s.shape
    mask = offdiag(d, prec, s.device)
    eye = torch.eye(d, dtype=prec.dtype, device=s.device)
    out = torch.empty_like(s)
    for p0 in range(0, n_p, chunk):
        sl = s[p0:p0 + chunk]
        eps = logistic(sl.shape[0], n_samples, d, seed, stream, s.device,
                       prec.dtype, first_particle=p0)
        g = torch.sigmoid(tau * (eps + alpha * sl[:, None])) * mask
        power = _matrix_power(eye + g / d, d - 1, prec)
        grad = power.transpose(-1, -2) * (tau * alpha * g * (1.0 - g))
        out[p0:p0 + chunk] = grad.mean(1)
    return out


def _se_matrix(rows: torch.Tensor, h: float, prec: Precision):
    sq = (rows * rows).sum(-1)
    dist = sq[:, None] + sq[None, :] - 2.0 * prec.mm(rows, rows.T)
    dist = torch.clamp(dist, min=0.0)
    dist.fill_diagonal_(0.0)
    return torch.exp(-dist / h)


def transport(values: list, grads: list, bandwidths: list,
              prec: Precision) -> list:
    """SVGD transports of particle families ``values [P, n_f]`` with score
    gradients ``grads`` under the additive SE kernel ``sum_f exp(-||v_f -
    v_f'||^2 / h_f)``: ``phi_i = -(1/P) sum_m [k(m, i) g_m + grad_{v_m}
    k(m, i)]``, the repulsion of family ``f`` from its own term alone."""
    n_p = values[0].shape[0]
    mats = [_se_matrix(v, h, prec) for v, h in zip(values, bandwidths)]
    k_sum = sum(mats)
    out = []
    for v, g, k_own, h in zip(values, grads, mats, bandwidths):
        vc = v - v.mean(0, keepdim=True)
        rep = (-2.0 / h) * (prec.mm(k_own.T, vc) - k_own.sum(0)[:, None] * vc)
        out.append(-(prec.mm(k_sum.T, g) + rep) / n_p)
    return out


def rmsprop(x, nu, phi, stepsize: float, gamma: float = 0.9,
            eps: float = 1e-8):
    """rmsprop with ``eps`` inside the root: ``(x - lr phi / sqrt(nu' +
    eps), nu')``, ``nu' = gamma nu + (1 - gamma) phi^2``."""
    nu = gamma * nu + (1.0 - gamma) * phi * phi
    return x - stepsize * phi / torch.sqrt(nu + eps), nu


def init_particles(cfg: dict, seed: int, prec: Precision, device,
                   with_theta: bool):
    """The initial particles of the run keyed by ``seed``: the
    configuration's set, ``z ~ N(0, 1/k)`` ``[P, d, k, 2]`` and, for a
    joint model, ``theta ~ N(mean_edge, sig_edge^2)`` pushed ``min_edge``
    from 0, in that order from one CPU ``torch.Generator`` seeded with its
    ``fixed_seed``, in float32, taken in the order
    :func:`portbench.datagen.particle_order` gives ``seed``."""
    gen = torch.Generator().manual_seed(cfg["fixed_seed"])
    n_p, d, k = cfg["n_particles"], cfg["n_vars"], cfg["latent_dim"]
    order = torch.as_tensor(particle_order(cfg, seed))
    z = torch.randn((n_p, d, k, 2), generator=gen) * (1.0 / math.sqrt(k))
    z = z[order]
    theta = None
    if with_theta:
        theta = cfg["mean_edge"] + cfg["sig_edge"] * torch.randn(
            (n_p, d, d), generator=gen)
        theta = theta + torch.sign(theta) * cfg["min_edge"]
        theta = theta[order].to(device=device, dtype=prec.dtype)
    return z.to(device=device, dtype=prec.dtype), theta
