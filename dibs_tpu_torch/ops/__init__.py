"""Tensor ops of the port: the acyclicity constraint and the latent ->
graph maps exported here (the names the JAX package's ``ops`` exports);
the submodules hold the hand-written CUDA kernels with their plain twins
(:mod:`~dibs_tpu_torch.ops.gpu_kernels`, ``bge_kernel``,
``transport_kernel``, ``acyclic_kernel``, ``soft_graphs``) and the
log-determinant, CPDAG, ancestral-sampling and ROC helpers."""
from dibs_tpu_torch.ops.acyclic import acyclic_constr, elwise_acyclic_constr
from dibs_tpu_torch.ops.edges import (
    edge_log_probs,
    edge_probs,
    edge_scores,
    latent_log_prob,
    particle_to_g_lim,
    particle_to_hard_graph,
    particle_to_soft_graph,
    sample_g,
)

__all__ = [
    "acyclic_constr",
    "elwise_acyclic_constr",
    "edge_scores",
    "edge_probs",
    "edge_log_probs",
    "latent_log_prob",
    "particle_to_g_lim",
    "particle_to_hard_graph",
    "particle_to_soft_graph",
    "sample_g",
]
