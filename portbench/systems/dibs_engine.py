"""The system under test for the DiBS configurations: the port's
``JointDiBS`` or ``MarginalDiBS`` built from a configuration file and the
benchmark's data, driven through its public ``init_state`` and ``resume``;
the likelihood's part of one step through the estimators the engine
exposes as ``est``.

The port is imported inside :func:`build`, never when this module is
imported: the harness loads this file by name before it has checked the
card.
"""
from __future__ import annotations

import os
import time

__all__ = ["build"]


class Engine:
    """One engine of the port on the configuration ``cfg``."""

    def __init__(self, cfg: dict, x, device):
        import torch

        from dibs_tpu_torch.inference import JointDiBS, MarginalDiBS
        from dibs_tpu_torch.models import (
            BGe,
            ErdosReniDAGDistribution,
            LinearGaussian,
            ScaleFreeDAGDistribution,
        )

        d = cfg["n_vars"]
        prior = {"sf": ScaleFreeDAGDistribution,
                 "er": ErdosReniDAGDistribution}[cfg["graph_prior"]](
            n_vars=d, n_edges_per_node=cfg["edges_per_node"])
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        common = dict(x=x, graph_model=prior,
                      optimizer_param={"stepsize": cfg["stepsize"]},
                      alpha_linear=cfg["alpha_linear"],
                      beta_linear=cfg["beta_linear"], tau=cfg["tau"],
                      n_grad_mc_samples=cfg["n_grad_mc_samples"],
                      n_acyclicity_mc_samples=cfg["n_acyclicity_mc_samples"],
                      grad_estimator_z=cfg["grad_estimator_z"],
                      device=device)
        if cfg["engine"] == "JointDiBS":
            lik = LinearGaussian(n_vars=d, obs_noise=cfg["obs_noise"],
                                 mean_edge=cfg["mean_edge"],
                                 sig_edge=cfg["sig_edge"],
                                 min_edge=cfg["min_edge"])
            self.dibs = JointDiBS(likelihood_model=lik, kernel_param={
                "h_latent": cfg["h_latent"], "h_theta": cfg["h_theta"]},
                fused_sample_sharing=cfg["fused_sample_sharing"], **common)
        elif cfg["engine"] == "MarginalDiBS":
            lik = BGe(n_vars=d, alpha_mu=cfg["bge_alpha_mu"],
                      alpha_lambd=cfg["bge_alpha_lambd"], device=device)
            self.dibs = MarginalDiBS(likelihood_model=lik, kernel_param={
                "h": cfg["h_latent"]}, **common)
        else:
            raise ValueError(f"unknown engine {cfg['engine']!r}")
        self.cfg = cfg

    def prepare(self) -> float:
        """Loads the kernel library on a CUDA device, building it where
        the checkout has none for these sources; the seconds the build took
        (0 where it was there, or on the CPU)."""
        if self.dibs.device.type != "cuda":
            return 0.0
        from dibs_tpu_torch.ops import gpu_kernels

        t0 = time.time()
        lib = gpu_kernels.build()
        built = os.path.getmtime(lib._name) >= t0 - 1.0
        return time.time() - t0 if built else 0.0

    def init_state(self, seed: int):
        """The configuration's initial particles (drawn by the engine's
        ``init_state`` from its ``fixed_seed``) in the order
        :func:`portbench.datagen.particle_order` gives ``seed``, and the
        noise keyed by ``seed``."""
        import torch

        from portbench.datagen import particle_order

        st = self.dibs.init_state(seed=self.cfg["fixed_seed"],
                                  n_particles=self.cfg["n_particles"],
                                  n_dim_particles=self.cfg["latent_dim"])
        order = torch.as_tensor(particle_order(self.cfg, seed),
                                device=st.z.device)
        theta = None if st.theta is None else st.theta[order]
        # the optimizer's state starts at zero, the same in every order
        return st._replace(seed=seed, z=st.z[order], theta=theta)

    def run(self, state, steps: int, on_step=None):
        """``steps`` steps from ``state`` through ``resume``; ``on_step()``
        after each step. Returns the state after them."""
        callback = None if on_step is None else (lambda **_: on_step())
        out = self.dibs.resume(state, steps=steps, callback=callback,
                               callback_every=1, return_state=True)
        return out[-1]

    def likelihood(self, state) -> dict:
        """The likelihood's part of the step from ``state``, through the
        estimators the engine steps with (its public ``est``: the fused
        joint estimator, or the marginal ``Z`` score estimator) on that
        step's inputs and noise streams: ``z``, ``theta``, ``t`` and
        ``out`` (``dz``, and ``dtheta`` for the joint model)."""
        est, t = self.dibs.est, int(state.t)
        if self.cfg["engine"] == "MarginalDiBS":
            dz, _ = est.eltwise_grad_z_likelihood(
                state.z, None, state.sf_baseline, state.t, state.seed, 2 * t)
            out = {"dz": dz}
        else:
            shared = (self.cfg.get("fused_sample_sharing") == "hard"
                      and est.fused_grad_both is not None)
            soft, hard = 3 * t, 3 * t if shared else 3 * t + 1
            if est.fused_grad_both is not None:
                dz, dtheta = est.fused_grad_both(
                    state.z, state.theta, state.t, state.seed, (soft, hard))
            else:
                dtheta = est.eltwise_grad_theta_likelihood(
                    state.z, state.theta, state.t, state.seed, hard)
                dz, _ = est.eltwise_grad_z_likelihood(
                    state.z, state.theta, state.sf_baseline, state.t,
                    state.seed, soft)
            out = {"dz": dz, "dtheta": dtheta}
        return {"z": state.z, "theta": state.theta, "t": t, "out": out}

    @staticmethod
    def leaves(state) -> dict:
        """The state's tensors by the reference's names."""
        out = {"z": state.z, "nu_z": state.opt_state_z[0].nu}
        if state.theta is not None:
            out.update(theta=state.theta, nu_theta=state.opt_state_theta[0].nu)
        return out


def build(cfg: dict, x, device) -> Engine:
    return Engine(cfg, x, device)
