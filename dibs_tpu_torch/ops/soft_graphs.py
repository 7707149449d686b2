"""Batched Gumbel graph sampling (PyTorch twin of ``dibs_tpu/ops/soft_graphs.py``).

``sample_soft_graphs`` draws relaxed samples
``G = sigmoid(tau (eps + alpha s))`` through the sampler kernel and carries
a closed-form backward that needs only the output:

    dG / d scores = tau * alpha * G (1 - G),

so the noise is never stored. ``sample_hard_graphs`` draws the Gumbel-max
samples ``1[eps + alpha s > 0]`` (exactly Bernoulli(sigmoid(alpha s))),
which the REINFORCE estimators treat as constants.

Noise: Logistic(0, 1) drawn inside the kernel from the counter-based
stream (``seed``, ``stream``), or the injected ``eps`` of shape
``[B, n_samples, d, d]`` (used by the tests to feed the reference's draw).
``particle_offset`` is the global index of the batch's first particle: a
particle shard draws what its particles draw in the whole batch;
``sample_offset`` is the global index of the first sample, likewise for a
sample shard of the ``("p", "mc")`` mesh.
"""
from __future__ import annotations

import torch

from dibs_tpu_torch.ops.gpu_kernels import gumbel_graphs

__all__ = ["sample_soft_graphs", "sample_hard_graphs"]


class _SoftGraphs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, scores, seed, stream, alpha, tau, n_samples, eps,
                particle_offset, sample_offset):
        out = gumbel_graphs(scores.detach().contiguous(), seed, stream, alpha,
                            tau, n_samples, hard=False, eps=eps,
                            particle_offset=particle_offset,
                            sample_offset=sample_offset)
        ctx.save_for_backward(out)
        ctx.alpha, ctx.tau = alpha, tau
        return out

    @staticmethod
    def backward(ctx, g_out):
        (out,) = ctx.saved_tensors
        # dG/ds = tau * alpha * G (1 - G); the diagonal of G is already 0
        sensit = ctx.tau * out * (1.0 - out) * g_out  # [B, M, d, d]
        return (ctx.alpha * sensit.sum(dim=1), None, None, None, None, None,
                None, None, None)


def sample_soft_graphs(scores: torch.Tensor, seed: int, stream: int,
                       alpha: float, tau: float, n_samples: int,
                       eps: torch.Tensor | None = None,
                       particle_offset: int = 0,
                       sample_offset: int = 0) -> torch.Tensor:
    """``[B, d, d]`` scores -> ``[B, n_samples, d, d]`` relaxed graph samples,
    differentiable w.r.t. ``scores``."""
    return _SoftGraphs.apply(scores, seed, stream, float(alpha), float(tau),
                             n_samples, eps, particle_offset, sample_offset)


def sample_hard_graphs(scores: torch.Tensor, seed: int, stream: int,
                       alpha: float, n_samples: int,
                       eps: torch.Tensor | None = None,
                       particle_offset: int = 0,
                       sample_offset: int = 0) -> torch.Tensor:
    """``[B, d, d]`` scores -> ``[B, n_samples, d, d]`` hard Bernoulli
    adjacency samples (not differentiated)."""
    return gumbel_graphs(scores.detach().contiguous(), seed, stream,
                         float(alpha), 1.0, n_samples, hard=True, eps=eps,
                         particle_offset=particle_offset,
                         sample_offset=sample_offset)
