"""Plain PyTorch reference of joint DiBS with the linear-Gaussian model:
SVGD over ``(Z, Theta)`` with the Gumbel-softmax reparameterization
estimator of the ``Z`` score and the hard-sample estimator of the
``Theta`` score from one shared noise batch (Lorch et al. 2021, eqs. 9 and
B.2; the shared-noise form: the hard samples are the thresholds of the
soft samples' noise), the scale-free or Erdos-Renyi soft graph prior, the
sampled NOTEARS acyclicity penalty, the Gaussian latent prior, the
additive SE kernel and rmsprop.

Step ``t`` (``alpha = alpha_linear t``, ``beta = beta_linear t``) draws
its likelihood noise from stream ``3 t`` and its acyclicity noise from
stream ``3 t + 2``. Each (particle, sample) is scored relative to the
particle's expected graph ``E[G] = sigmoid(alpha s)``: with ``delta = x
((G - E[G]) * Theta)`` and ``r = x - x (E[G] * Theta)``,

    l(G) - l(E[G]) = -(1 / 2 sigma^2) sum (delta^2 - 2 r delta)
                     + sum (G - E[G]) log N(Theta)

and the softmax over the samples is taken of these. Imports nothing of the
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
    theta: torch.Tensor  # [P, d, d]
    nu_z: torch.Tensor
    nu_theta: torch.Tensor

    def leaves(self) -> dict:
        return {"z": self.z, "theta": self.theta, "nu_z": self.nu_z,
                "nu_theta": self.nu_theta}


class Reference:
    """The reference on the configuration ``cfg`` and data ``x [N, d]``,
    at precision ``prec``, on ``device``; ``chunk`` particles at a time
    through the likelihood and the acyclicity penalty."""

    def __init__(self, cfg: dict, x, prec: common.Precision, device,
                 chunk: int = 25):
        self.cfg, self.prec, self.device, self.chunk = cfg, prec, device, chunk
        self.x = torch.as_tensor(x).to(device=device, dtype=prec.dtype)

    def init_state(self, seed: int) -> State:
        z, theta = common.init_particles(self.cfg, seed, self.prec,
                                         self.device, with_theta=True)
        return State(0, z, theta, torch.zeros_like(z), torch.zeros_like(theta))

    def _likelihood(self, s, theta, alpha, seed, stream):
        """``(d s, d Theta)`` of the likelihood, ``[P, d, d]`` each."""
        cfg, prec, x = self.cfg, self.prec, self.x
        n_p, d, _ = s.shape
        m, tau = cfg["n_grad_mc_samples"], cfg["tau"]
        inv_var = 1.0 / cfg["obs_noise"]
        mask = common.offdiag(d, prec, s.device)
        d_s, d_theta = torch.empty_like(s), torch.empty_like(theta)
        for p0 in range(0, n_p, self.chunk):
            a_s = alpha * s[p0:p0 + self.chunk]
            th = theta[p0:p0 + self.chunk]
            n_c = a_s.shape[0]
            expected = torch.sigmoid(a_s) * mask
            logpdf = (-0.5 * ((th - cfg["mean_edge"]) / cfg["sig_edge"]) ** 2
                      - math.log(cfg["sig_edge"]) - 0.5 * math.log(2 * math.pi))
            resid_ref = x - prec.mm(x, expected * th)  # [c, N, d]
            eps = logistic(n_c, m, d, seed, stream, s.device, prec.dtype,
                           first_particle=p0)
            soft = torch.sigmoid(tau * (eps + a_s[:, None])) * mask
            hard = ((eps + a_s[:, None]) > 0).to(prec.dtype) * mask
            del eps
            grads = []
            for g in (soft, hard):
                dg = g - expected[:, None]
                delta = prec.mm(x, dg * th[:, None])  # [c, M, N, d]
                dll = (-0.5 * inv_var
                       * (delta * (delta - 2.0 * resid_ref[:, None])).sum((-2, -1))
                       + (dg * logpdf[:, None]).sum((-2, -1)))
                weights = torch.softmax(dll, dim=1)
                resid = resid_ref[:, None] - delta
                del delta
                dw = prec.mm(x.T, resid) * inv_var  # [c, M, d, d]
                del resid
                grads.append((weights, dw))
            (w_s, dw_s), (w_h, dw_h) = grads
            c_soft = (tau * soft * (1.0 - soft)
                      * (th[:, None] * dw_s + logpdf[:, None]))
            d_s[p0:p0 + n_c] = alpha * (w_s[..., None, None] * c_soft).sum(1)
            dprior = (cfg["mean_edge"] - th) / cfg["sig_edge"] ** 2
            c_hard = hard * (dw_h + dprior[:, None])
            d_theta[p0:p0 + n_c] = (w_h[..., None, None] * c_hard).sum(1)
        return d_s, d_theta

    def likelihood(self, z, theta, t: int, seed: int) -> dict:
        """The likelihood's scores at step ``t`` of the state ``(z,
        theta)``: ``dz`` (``d s`` chained to ``Z``) and ``dtheta``."""
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
            [st.z.reshape(n_p, -1), st.theta.reshape(n_p, -1)],
            [d_z.reshape(n_p, -1), d_theta.reshape(n_p, -1)],
            [cfg["h_latent"], cfg["h_theta"]], prec)
        z, nu_z = common.rmsprop(st.z, st.nu_z, phi_z.reshape(st.z.shape),
                                 cfg["stepsize"])
        theta, nu_t = common.rmsprop(st.theta, st.nu_theta,
                                     phi_t.reshape(st.theta.shape),
                                     cfg["stepsize"])
        return State(t + 1, z, theta, nu_z, nu_t)
