"""SVGD kernels (PyTorch twin of ``dibs_tpu/kernel.py``).

``k(Z, Z') = scale * exp(-||Z - Z'||_F^2 / h)`` and its closed-form gradient
``grad_Z k(Z, Z') = -(2 / h) k(Z, Z') (Z - Z')``. The ``[P, P]`` matrix for a
fixed float bandwidth goes through :func:`dibs_tpu_torch.ops.gpu_kernels.
se_matrix`: the CUDA kernel for CUDA tensors at every shape (the TPU-era
size crossover is not carried over), the plain twin on the CPU.
``h="median"`` takes the plain path, as in the reference. The joint kernel
adds an SE term over ``Theta``; both of its component matrices go through the
same kernel; ``Theta`` may be a parameter tree, whose leaves are flattened
into one row per particle (W1 || b1 || W2 || b2 for the MLP model). The
engine passes the same particles on both sides; they are flattened once and
the kernel then computes one triangle of the symmetric matrix.
"""
from __future__ import annotations

import math

import torch

from dibs_tpu_torch.ops.gpu_kernels import se_matrix
from dibs_tpu_torch.utils.func import (
    batched_sq_norm_matrix,
    squared_norm_pytree,
)
from dibs_tpu_torch.utils.tree import tree_rows

__all__ = ["AdditiveFrobeniusSEKernel", "JointAdditiveFrobeniusSEKernel"]


def _median_bandwidth(sq: torch.Tensor) -> torch.Tensor:
    """Median heuristic ``med(sq) / log(P + 1)`` over the last two axes of
    ``sq [..., P, P']``, clamped away from 0: a scalar for one matrix,
    ``[..., 1, 1]`` for a batch of them (it divides ``sq``)."""
    p = sq.shape[-2]
    med = torch.quantile(sq.flatten(-2), 0.5, dim=-1)
    h = torch.clamp(med / math.log(p + 1.0), min=1e-5)
    return h[..., None, None] if h.dim() else h


def median_se(xs, ys, scale, batch_dims: int = 0):
    """``(K, c)`` of an SE term under the median heuristic, with
    ``grad_x k(x, y) = c k(x, y) (x - y)``; with ``batch_dims`` leading
    axes before the particles (a fleet's datasets), one matrix and one
    bandwidth per index of those axes."""
    sq = batched_sq_norm_matrix(xs, ys, batch_dims)
    h_eff = _median_bandwidth(sq)
    return scale * torch.exp(-sq / h_eff), -2.0 / h_eff


def _flatten_rows(x) -> torch.Tensor:
    return tree_rows(x).contiguous()


def _se_rows(xs, ys, h, scale) -> torch.Tensor:
    """:func:`se_matrix` over the flattened particles. The same particles
    on both sides are flattened once, so the kernel sees ``x is y`` and
    computes one triangle of the symmetric matrix."""
    x = _flatten_rows(xs)
    y = x if ys is xs else _flatten_rows(ys)
    return se_matrix(x, y, float(h), float(scale))


class AdditiveFrobeniusSEKernel:
    """Squared-exponential kernel over latent particles ``Z`` (class default
    ``h=20``; :class:`~dibs_tpu_torch.inference.MarginalDiBS` uses 5)."""

    def __init__(self, *, h=20.0, scale=1.0):
        self.h = h
        self.scale = scale
        self.sharding = None  # set by an engine whose particles are sharded

    def eval(self, *, x, y):
        """Single-pair kernel value (reference-compatible signature)."""
        if isinstance(self.h, str):
            raise TypeError("h='median' needs the particle batch; use "
                            "matrix(), not single-pair eval().")
        return self.scale * torch.exp(-torch.sum((x - y) ** 2.0) / self.h)

    def matrix(self, xs, ys):
        """Pairwise kernel matrix ``[A, B]``."""
        if self.h == "median":
            return median_se(xs, ys, self.scale)[0]
        return _se_rows(xs, ys, self.h, self.scale)

    def matrix_and_grad_factor(self, xs, ys):
        """``(K, c)`` with ``grad_x k(x, y) = c * k(x, y) * (x - y)``."""
        if self.h == "median":
            return median_se(xs, ys, self.scale)
        return self.matrix(xs, ys), -2.0 / self.h

    def grad_factor_z(self):
        """Scalar ``c`` such that ``grad_x k(x, y) = c * k(x, y) * (x - y)``."""
        return -2.0 / self.h


def _component(xs, ys, h, scale):
    """``(K, c)`` of one SE term: the kernel matrix for a float bandwidth,
    the plain median heuristic for ``h="median"``."""
    if h == "median":
        return median_se(xs, ys, scale)
    return _se_rows(xs, ys, h, scale), -2.0 / h


class JointAdditiveFrobeniusSEKernel:
    """Additive SE kernel over ``(Z, Theta)`` particle pairs:

        k = scale_z exp(-||Z - Z'||^2 / h_z) + scale_t exp(-||Theta - Theta'||^2 / h_t)

    The two terms have disjoint dependencies, so the Z-repulsion involves
    only the latent term and the Theta-repulsion only the Theta term; the
    engine asks for the component matrices separately."""

    def __init__(self, *, h_latent=5.0, h_theta=500.0, scale_latent=1.0,
                 scale_theta=1.0):
        self.h_latent = h_latent
        self.h_theta = h_theta
        self.scale_latent = scale_latent
        self.scale_theta = scale_theta
        self.sharding = None  # set by an engine whose particles are sharded

    def eval(self, *, x_latent, x_theta, y_latent, y_theta):
        """Single-pair kernel value (reference-compatible signature)."""
        if isinstance(self.h_latent, str) or isinstance(self.h_theta, str):
            raise TypeError("h='median' needs the particle batch; use "
                            "component_matrices_and_factors().")
        latent_sq = torch.sum((x_latent - y_latent) ** 2.0)
        theta_sq = squared_norm_pytree(x_theta, y_theta)
        return (self.scale_latent * torch.exp(-latent_sq / self.h_latent)
                + self.scale_theta * torch.exp(-theta_sq / self.h_theta))

    def component_matrices_and_factors(self, x_latents, x_thetas, y_latents,
                                       y_thetas):
        """``(K_z, K_theta, c_z, c_theta)``: the ``[A, B]`` component
        matrices and the repulsion factors at the effective bandwidths."""
        k_z, c_z = _component(x_latents, y_latents, self.h_latent,
                              self.scale_latent)
        k_t, c_t = _component(x_thetas, y_thetas, self.h_theta,
                              self.scale_theta)
        return k_z, k_t, c_z, c_t

    def component_matrices(self, x_latents, x_thetas, y_latents, y_thetas):
        """``(K_z, K_theta)``: the ``[A, B]`` component matrices."""
        k_z, k_t, _, _ = self.component_matrices_and_factors(
            x_latents, x_thetas, y_latents, y_thetas)
        return k_z, k_t

    def matrix(self, x_latents, x_thetas, y_latents, y_thetas):
        """Full pairwise kernel matrix ``K_z + K_theta``."""
        k_z, k_t = self.component_matrices(x_latents, x_thetas, y_latents,
                                           y_thetas)
        return k_z + k_t

    def grad_factor_z(self):
        """``c`` with ``grad_Z k = c K_z (Z - Z')`` (latent term only)."""
        return -2.0 / self.h_latent

    def grad_factor_theta(self):
        """``c`` with ``grad_Theta k = c K_theta (Theta - Theta')`` (Theta
        term only)."""
        return -2.0 / self.h_theta
