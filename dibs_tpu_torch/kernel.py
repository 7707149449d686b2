"""SVGD kernels (PyTorch twin of ``dibs_tpu/kernel.py``).

``k(Z, Z') = scale * exp(-||Z - Z'||_F^2 / h)`` and its closed-form gradient
``grad_Z k(Z, Z') = -(2 / h) k(Z, Z') (Z - Z')``. The ``[P, P]`` matrix for a
fixed float bandwidth goes through :func:`dibs_tpu_torch.ops.gpu_kernels.
se_matrix`: the CUDA kernel for CUDA tensors at every shape (the TPU-era
size crossover is not carried over), the plain twin on the CPU.
``h="median"`` takes the plain path, as in the reference.
"""
from __future__ import annotations

import math

import torch

from dibs_tpu_torch.ops.gpu_kernels import se_matrix
from dibs_tpu_torch.utils.func import pytree_sq_norm_matrix

__all__ = ["AdditiveFrobeniusSEKernel"]


def _median_bandwidth(sq: torch.Tensor) -> torch.Tensor:
    """Median heuristic ``med(sq) / log(P + 1)``, clamped away from 0."""
    p = sq.shape[0]
    med = torch.quantile(sq.reshape(-1), 0.5)
    return torch.clamp(med / math.log(p + 1.0), min=1e-5)


def _flatten_rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).contiguous()


class AdditiveFrobeniusSEKernel:
    """Squared-exponential kernel over latent particles ``Z`` (class default
    ``h=20``; :class:`~dibs_tpu_torch.inference.MarginalDiBS` uses 5)."""

    def __init__(self, *, h=20.0, scale=1.0):
        self.h = h
        self.scale = scale

    def eval(self, *, x, y):
        """Single-pair kernel value (reference-compatible signature)."""
        if isinstance(self.h, str):
            raise TypeError("h='median' needs the particle batch; use "
                            "matrix(), not single-pair eval().")
        return self.scale * torch.exp(-torch.sum((x - y) ** 2.0) / self.h)

    def matrix(self, xs, ys):
        """Pairwise kernel matrix ``[A, B]``."""
        if self.h == "median":
            sq = pytree_sq_norm_matrix(xs, ys)
            return self.scale * torch.exp(-sq / _median_bandwidth(sq))
        return se_matrix(_flatten_rows(xs), _flatten_rows(ys), float(self.h),
                         float(self.scale))

    def matrix_and_grad_factor(self, xs, ys):
        """``(K, c)`` with ``grad_x k(x, y) = c * k(x, y) * (x - y)``."""
        if self.h == "median":
            sq = pytree_sq_norm_matrix(xs, ys)
            h_eff = _median_bandwidth(sq)
            return self.scale * torch.exp(-sq / h_eff), -2.0 / h_eff
        return self.matrix(xs, ys), -2.0 / self.h

    def grad_factor_z(self):
        """Scalar ``c`` such that ``grad_x k(x, y) = c * k(x, y) * (x - y)``."""
        return -2.0 / self.h
