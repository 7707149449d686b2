"""SVGD transport (PyTorch twin of ``dibs_tpu/inference/transport.py``).

    phi_i = (1/P) sum_m [ k(z_m, z_i) grad log p(z_m) + grad_{z_m} k(z_m, z_i) ]

For kernels with the closed-form SE gradient this is two ``[P, P] @ [P, n]``
matmuls: the kernel-weighted scores ``K^T G`` and the repulsion
``c (K^T V - colsum(K) * V)`` with ``V`` centred by its particle mean (the
repulsion is exactly invariant under the shift, and centring keeps matmul
rounding relative to the particle differences). Kernels with only the
reference ``eval`` signature go through the autodiff path. For joint
inference the kernel-weighted scores use ``K_z + K_theta`` and each
component's repulsion its own SE term; a ``Theta`` parameter tree is
transported leaf by leaf (driver and centred repulsion per leaf). The
transport is negated, so a minimizing optimizer ascends the target.
"""
from __future__ import annotations

import torch
from torch.func import grad, vmap

from dibs_tpu_torch.utils.tree import tree_map

__all__ = ["marginal_transport", "joint_transport"]


def _flat(a: torch.Tensor) -> torch.Tensor:
    return a.reshape(a.shape[0], -1)


def _weighted_scores(k_mat, grads):
    """``sum_m K[m, i] grads[m]`` for all ``i``."""
    return (k_mat.T @ _flat(grads)).reshape(grads.shape)


def _se_repulsion(k_mat, factor, values):
    """``sum_m grad_{v_m} k(v_m, v_i) = factor (K^T V - colsum(K) V)``."""
    vf = _flat(values)
    vf = vf - vf.mean(dim=0, keepdim=True)
    colsum = k_mat.sum(dim=0)
    rep = factor * (k_mat.T @ vf - colsum[:, None] * vf)
    return rep.reshape(values.shape)


def marginal_transport(kernel, z: torch.Tensor, dz: torch.Tensor):
    """Transport ``phi_z [P, d, k, 2]`` for Z-only SVGD."""
    n_particles = z.shape[0]
    if hasattr(kernel, "matrix_and_grad_factor"):
        k_mat, factor = kernel.matrix_and_grad_factor(z, z)
        phi = _weighted_scores(k_mat, dz) + _se_repulsion(k_mat, factor, z)
        return -phi / n_particles
    return _marginal_transport_autodiff(kernel, z, dz)


def _marginal_transport_autodiff(kernel, z, dz):
    def f_kernel(a, b):
        return kernel.eval(x=a, y=b)

    k_mat = vmap(vmap(f_kernel, (None, 0)), (0, None))(z, z)

    def phi_single(single_z, kxx_col):
        weighted = kxx_col[:, None, None, None] * dz
        repulsion = vmap(grad(f_kernel, argnums=0), (0, None))(z, single_z)
        return -(weighted + repulsion).mean(dim=0)

    return vmap(phi_single, (0, 1))(z, k_mat)


def joint_transport(kernel, z: torch.Tensor, theta: torch.Tensor,
                    dz: torch.Tensor, dtheta: torch.Tensor):
    """Transports ``(phi_z, phi_theta)`` for joint ``(Z, Theta)`` SVGD."""
    n_particles = z.shape[0]
    if hasattr(kernel, "component_matrices_and_factors"):
        k_z, k_t, c_z, c_t = kernel.component_matrices_and_factors(
            z, theta, z, theta)
        k_mat = k_z + k_t
        phi_z = _weighted_scores(k_mat, dz) + _se_repulsion(k_z, c_z, z)
        phi_t = tree_map(
            lambda g, v: -(_weighted_scores(k_mat, g)
                           + _se_repulsion(k_t, c_t, v)) / n_particles,
            dtheta, theta)
        return -phi_z / n_particles, phi_t
    return _joint_transport_autodiff(kernel, z, theta, dz, dtheta)


def _joint_transport_autodiff(kernel, z, theta, dz, dtheta):
    def f_kernel(az, at, bz, bt):
        return kernel.eval(x_latent=az, x_theta=at, y_latent=bz, y_theta=bt)

    k_mat = vmap(vmap(f_kernel, (None, None, 0, 0)), (0, 0, None, None))(
        z, theta, z, theta)

    def phi_single(single_z, single_theta, kxx_col):
        rep_z, rep_t = vmap(grad(f_kernel, argnums=(0, 1)),
                            (0, 0, None, None))(z, theta, single_z,
                                                single_theta)
        phi_t = tree_map(
            lambda g, r: -(kxx_col.reshape((-1,) + (1,) * (g.dim() - 1)) * g
                           + r).mean(dim=0), dtheta, rep_t)
        return (-(kxx_col[:, None, None, None] * dz + rep_z).mean(dim=0),
                phi_t)

    return vmap(phi_single, (0, 0, 1))(z, theta, k_mat)
