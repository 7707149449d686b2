"""SVGD transport (PyTorch twin of ``dibs_tpu/inference/transport.py``).

    phi_i = (1/P) sum_m [ k(z_m, z_i) grad log p(z_m) + grad_{z_m} k(z_m, z_i) ]

For kernels with the closed-form SE gradient and a float repulsion factor,
a whole transport family goes through the fused kernel
(:func:`dibs_tpu_torch.ops.transport_kernel.transport_phi`, kernel #4):
``phi = -(1/P) (K_own^T (g + c v') + K_other^T g) + (c/P) colsum(K_own) v'``
with ``v'`` centred by its particle mean (the repulsion is exactly invariant
under the shift, and centring keeps rounding relative to the particle
differences). The marginal engine sends one family (``K_other`` absent); the
joint engine two, ``Z`` with ``(K_z, K_theta, c_z)`` and ``Theta`` with
``(K_theta, K_z, c_theta)``; a ``Theta`` parameter tree is flattened into one
``[P, n]`` block and split back into its leaves. A non-float factor
(``h="median"``) takes the two-matmul route ``K^T G + c (K^T V - colsum(K)
V)``; kernels with only the reference ``eval`` signature go through the
autodiff path. The transport is negated, so a minimizing optimizer ascends
the target. The two-matmul route and the plain version of #4 run their
matmuls at :func:`~dibs_tpu_torch.config.transport_matmul_precision`;
kernel #4 computes in float32 whatever it is set to.
"""
from __future__ import annotations

import torch
from torch.func import grad, vmap

from dibs_tpu_torch.config import matmul_precision, transport_matmul_precision
from dibs_tpu_torch.ops.transport_kernel import (
    transport_phi,
    transport_phi_available,
)
from dibs_tpu_torch.utils.tree import (
    tree_leaves,
    tree_map,
    tree_rows,
    tree_unflatten,
)

__all__ = ["marginal_transport", "joint_transport"]


def _flat(a: torch.Tensor) -> torch.Tensor:
    return a.reshape(a.shape[0], -1)


def _precision():
    """The transport family's matmul precision around its own cuBLAS calls
    (:func:`~dibs_tpu_torch.config.set_transport_matmul_precision`)."""
    return matmul_precision(transport_matmul_precision())


def _weighted_scores(k_mat, grads):
    """``sum_m K[m, i] grads[m]`` for all ``i``."""
    with _precision():
        return (k_mat.T @ _flat(grads)).reshape(grads.shape)


def _se_repulsion(k_mat, factor, values):
    """``sum_m grad_{v_m} k(v_m, v_i) = factor (K^T V - colsum(K) V)``."""
    vf = _flat(values)
    vf = vf - vf.mean(dim=0, keepdim=True)
    colsum = k_mat.sum(dim=0)
    with _precision():
        rep = factor * (k_mat.T @ vf - colsum[:, None] * vf)
    return rep.reshape(values.shape)


def _fused_phi_or_none(k_own, k_other, c, values, grads):
    """One whole transport family through kernel #4, or ``None`` where the
    factor is not a float (the median bandwidth). ``values`` / ``grads`` are
    tensors or matching parameter trees, flattened into one ``[P, n]``
    block and split back into the leaves of ``values``."""
    if not isinstance(c, float):
        return None
    leaves = tree_leaves(values)
    p = leaves[0].shape[0]
    vf = tree_rows(values).contiguous()
    if not transport_phi_available(p, vf.shape[1]):
        return None
    gf = tree_rows(grads).contiguous()
    mu = vf.mean(dim=0, keepdim=True)
    with _precision():  # reaches the plain version's matmuls only
        phi_flat = transport_phi(k_own, k_other, gf, vf, c=c, mu=mu)
    out, offset = [], 0
    for leaf in leaves:
        size = leaf[0].numel()
        out.append(phi_flat[:, offset:offset + size].reshape(leaf.shape))
        offset += size
    return tree_unflatten(values, out)


def marginal_transport(kernel, z: torch.Tensor, dz: torch.Tensor):
    """Transport ``phi_z [P, d, k, 2]`` for Z-only SVGD."""
    n_particles = z.shape[0]
    if hasattr(kernel, "matrix_and_grad_factor"):
        k_mat, factor = kernel.matrix_and_grad_factor(z, z)
        fused = _fused_phi_or_none(k_mat, None, factor, z, dz)
        if fused is not None:
            return fused
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
        phi_z = _fused_phi_or_none(k_z, k_t, c_z, z, dz)
        phi_t = _fused_phi_or_none(k_t, k_z, c_t, theta, dtheta)
        if phi_z is None or phi_t is None:
            k_mat = k_z + k_t
        if phi_z is None:
            phi_z = -(_weighted_scores(k_mat, dz)
                      + _se_repulsion(k_z, c_z, z)) / n_particles
        if phi_t is None:
            phi_t = tree_map(
                lambda g, v: -(_weighted_scores(k_mat, g)
                               + _se_repulsion(k_t, c_t, v)) / n_particles,
                dtheta, theta)
        return phi_z, phi_t
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
