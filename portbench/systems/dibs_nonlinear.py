"""The system under test for the nonlinear joint configurations: the port's
``JointDiBS`` with ``DenseNonlinearGaussian`` (a per-node MLP) built from a
configuration file and the benchmark's data, on the route the engine
picks for it (kernel #8 where its gate serves the shape, the generic
estimators elsewhere).

:class:`~portbench.systems.dibs_engine.Engine` builds, warms, steps and
calls the likelihood; this module changes what is tree-shaped. ``Theta``
is the MLP's parameter tree ``[(W1, b1), (W2, b2), ...]``: the initial
order takes every leaf's particles in the seed's order, and the compared
``theta`` and ``nu_theta`` and the likelihood stage's ``theta`` and
``dtheta`` are ``[P, n]`` rows, the leaves flattened and concatenated in
``tree_leaves`` order (W1, b1, W2, b2), as the reference keeps them.

The port is imported inside :func:`build`, never when this module is
imported.
"""
from __future__ import annotations

from portbench.systems.dibs_engine import Engine

__all__ = ["build"]


class NonlinearEngine(Engine):
    """``JointDiBS`` + ``DenseNonlinearGaussian`` on the configuration
    ``cfg``."""

    def __init__(self, cfg: dict, x, device):
        import torch

        from dibs_tpu_torch.inference import JointDiBS
        from dibs_tpu_torch.models import (
            DenseNonlinearGaussian,
            ErdosReniDAGDistribution,
            ScaleFreeDAGDistribution,
        )

        d = cfg["n_vars"]
        prior = {"sf": ScaleFreeDAGDistribution,
                 "er": ErdosReniDAGDistribution}[cfg["graph_prior"]](
            n_vars=d, n_edges_per_node=cfg["edges_per_node"])
        lik = DenseNonlinearGaussian(
            n_vars=d, hidden_layers=tuple(cfg["hidden_layers"]),
            obs_noise=cfg["obs_noise"], sig_param=cfg["sig_param"],
            activation=cfg["activation"], bias=cfg["bias"])
        self.dibs = JointDiBS(
            x=torch.as_tensor(x, dtype=torch.float32, device=device),
            graph_model=prior, likelihood_model=lik,
            kernel_param={"h_latent": cfg["h_latent"],
                          "h_theta": cfg["h_theta"]},
            optimizer_param={"stepsize": cfg["stepsize"]},
            alpha_linear=cfg["alpha_linear"], beta_linear=cfg["beta_linear"],
            tau=cfg["tau"], n_grad_mc_samples=cfg["n_grad_mc_samples"],
            n_acyclicity_mc_samples=cfg["n_acyclicity_mc_samples"],
            grad_estimator_z=cfg["grad_estimator_z"],
            fused_sample_sharing=cfg["fused_sample_sharing"], device=device)
        self.cfg = cfg

    def init_state(self, seed: int):
        """As :meth:`Engine.init_state`, which takes ``Theta`` as one
        tensor: here every leaf of the tree is taken in the seed's
        order."""
        import torch

        from dibs_tpu_torch.utils.tree import tree_map
        from portbench.datagen import particle_order

        st = self.dibs.init_state(seed=self.cfg["fixed_seed"],
                                  n_particles=self.cfg["n_particles"],
                                  n_dim_particles=self.cfg["latent_dim"])
        order = torch.as_tensor(particle_order(self.cfg, seed),
                                device=st.z.device)
        return st._replace(seed=seed, z=st.z[order],
                           theta=tree_map(lambda leaf: leaf[order], st.theta))

    def likelihood(self, state) -> dict:
        """:meth:`Engine.likelihood` (the engine's ``fused_grad_both`` on
        the shared stream ``(3 t, 3 t)``), ``theta`` and ``dtheta`` as
        rows."""
        from dibs_tpu_torch.utils.tree import tree_rows

        out = super().likelihood(state)
        out["theta"] = tree_rows(out["theta"])
        out["out"]["dtheta"] = tree_rows(out["out"]["dtheta"])
        return out

    @staticmethod
    def leaves(state) -> dict:
        """The state's tensors by the reference's names, ``theta`` and
        ``nu_theta`` as rows."""
        from dibs_tpu_torch.utils.tree import tree_rows

        return {"z": state.z, "nu_z": state.opt_state_z[0].nu,
                "theta": tree_rows(state.theta),
                "nu_theta": tree_rows(state.opt_state_theta[0].nu)}


def build(cfg: dict, x, device) -> NonlinearEngine:
    return NonlinearEngine(cfg, x, device)
