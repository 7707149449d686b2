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

:func:`fleet_marginal_transport` is the marginal transport of a fleet
(:mod:`dibs_tpu_torch.fleet`): ``B_ds`` independent families with a leading
dataset axis, each dataset's SE matrix (#3) and family (#4) from one launch
each, or, for ``h="median"``, the two-matmul route batched over the
datasets with each dataset's own bandwidth. :func:`fleet_joint_transport`
is the joint one: both component matrices and both families, one launch
each for all the datasets, each family on the route :func:`joint_transport`
gives it (#4 for a float factor, the batched two-matmul route for a median
bandwidth). Kernels with only ``eval`` take the autodiff transport under
``torch.func.vmap`` over the datasets.

Under a particle sharding (:mod:`dibs_tpu_torch.parallel`) the engines run
the ring (:mod:`dibs_tpu_torch.parallel.ring`) where the kernel allows it,
else :func:`gathered_marginal_transport` / :func:`gathered_joint_transport`:
the particles and gradients are all-gathered, and this rank's rows of the
kernel matrix are #3's ``[P_local, P]`` row block against them (a median
bandwidth from the whole gathered batch). Kernel #4 is off for a kernel
whose ``sharding`` is set (a run whose particle count the world does not
divide, replicated on every rank, then takes the two-matmul route), as in
the reference.
"""
from __future__ import annotations

import torch
from torch.func import grad, vmap

from dibs_tpu_torch.config import matmul_precision, transport_matmul_precision
from dibs_tpu_torch.kernel import median_se
from dibs_tpu_torch.ops.gpu_kernels import se_matrix
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

__all__ = ["marginal_transport", "joint_transport",
           "fleet_marginal_transport", "fleet_joint_transport",
           "gathered_marginal_transport", "gathered_joint_transport"]


def _flat(a: torch.Tensor, lead: int) -> torch.Tensor:
    return a.reshape(*a.shape[:lead], -1)


def _precision():
    """The transport family's matmul precision around its own cuBLAS calls
    (:func:`~dibs_tpu_torch.config.set_transport_matmul_precision`)."""
    return matmul_precision(transport_matmul_precision())


def _weighted_scores(k_mat, grads, lead: int = 1):
    """``sum_m K[m, i] grads[m]`` for all ``i``; ``lead`` leading axes of
    ``grads`` are the particles' and a fleet's datasets' (``k_mat [..., P,
    P]``)."""
    with _precision():
        return (k_mat.transpose(-1, -2) @ _flat(grads, lead)).reshape(
            grads.shape)


def _se_repulsion(k_mat, factor, values, lead: int = 1):
    """``sum_m grad_{v_m} k(v_m, v_i) = factor (K^T V - colsum(K) V)``,
    ``lead`` as :func:`_weighted_scores`."""
    vf = _flat(values, lead)
    vf = vf - vf.mean(dim=-2, keepdim=True)
    colsum = k_mat.sum(dim=-2)
    with _precision():
        rep = factor * (k_mat.transpose(-1, -2) @ vf - colsum[..., None] * vf)
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


def _sharded(kernel) -> bool:
    """Kernel #4 is off for a kernel whose particles are sharded."""
    return getattr(kernel, "sharding", None) is not None


def marginal_transport(kernel, z: torch.Tensor, dz: torch.Tensor):
    """Transport ``phi_z [P, d, k, 2]`` for Z-only SVGD."""
    n_particles = z.shape[0]
    if hasattr(kernel, "matrix_and_grad_factor"):
        k_mat, factor = kernel.matrix_and_grad_factor(z, z)
        fused = None if _sharded(kernel) else _fused_phi_or_none(
            k_mat, None, factor, z, dz)
        if fused is not None:
            return fused
        phi = _weighted_scores(k_mat, dz) + _se_repulsion(k_mat, factor, z)
        return -phi / n_particles
    return _marginal_transport_autodiff(kernel, z, dz)


def fleet_marginal_transport(kernel, z: torch.Tensor, dz: torch.Tensor):
    """Transports ``phi_z [B_ds, P, d, k, 2]`` of ``B_ds`` independent
    datasets: each dataset's is :func:`marginal_transport` of its own
    particles. :class:`~dibs_tpu_torch.kernel.AdditiveFrobeniusSEKernel`
    with a float bandwidth goes through kernels #3 and #4, with
    ``"median"`` through batched matmuls (each dataset its own bandwidth);
    a kernel with only ``eval`` through the autodiff transport, vmapped
    over the datasets."""
    if not hasattr(kernel, "matrix_and_grad_factor"):
        return vmap(lambda a, g: _marginal_transport_autodiff(kernel, a, g))(
            z, dz)
    n_ds, p = z.shape[:2]
    if kernel.h == "median":  # each dataset its own bandwidth
        k_mat, factor = median_se(z, z, kernel.scale, batch_dims=1)
        return -(_weighted_scores(k_mat, dz, 2)
                 + _se_repulsion(k_mat, factor, z, 2)) / p
    h = float(kernel.h)
    vf = z.reshape(n_ds, p, -1).contiguous()
    gf = dz.reshape(n_ds, p, -1).contiguous()
    k_mat = se_matrix(vf, vf, h, float(kernel.scale))
    with _precision():  # reaches the plain version's matmuls only
        return transport_phi(k_mat, None, gf, vf, c=-2.0 / h,
                             mu=vf.mean(dim=1, keepdim=True)).reshape(z.shape)


def _fleet_rows(tree, n_ds, p):
    """``[B_ds, P, n]``: each leaf flattened per particle, concatenated over
    the leaves in order (``tree_rows`` with the dataset axis)."""
    rows = [leaf.reshape(n_ds, p, -1) for leaf in tree_leaves(tree)]
    return (rows[0] if len(rows) == 1 else torch.cat(rows, dim=-1)) \
        .contiguous()


def _fleet_component(values, rows, h, scale):
    """``(K [B_ds, P, P], c)`` of one SE term of a fleet: #3 over the
    flattened rows with a float ``c`` for a float bandwidth; the median
    heuristic per dataset (``c`` a ``[B_ds, 1, 1]`` tensor) for
    ``"median"``."""
    if h == "median":
        return median_se(values, values, scale, batch_dims=1)
    return se_matrix(rows, rows, float(h), float(scale)), -2.0 / float(h)


def fleet_joint_transport(kernel, z: torch.Tensor, theta, dz: torch.Tensor,
                          dtheta):
    """Transports ``(phi_z, phi_theta)`` of ``B_ds`` independent datasets:
    each dataset's is :func:`joint_transport` of its own particles
    (``z [B_ds, P, d, k, 2]``, parameter leaves ``[B_ds, P, ...]``). For
    :class:`~dibs_tpu_torch.kernel.JointAdditiveFrobeniusSEKernel`, ``K_z``
    and ``K_Theta`` come from one #3 launch each (``"median"``: batched
    matmuls, each dataset its own bandwidth), a family whose factor is a
    float from one #4 launch, a family with a median factor from the
    batched two-matmul route on ``K_z + K_Theta``; a kernel with only
    ``eval`` takes the autodiff transport, vmapped over the datasets."""
    if not hasattr(kernel, "component_matrices_and_factors"):
        return vmap(lambda *a: _joint_transport_autodiff(kernel, *a))(
            z, theta, dz, dtheta)
    n_ds, p = z.shape[:2]
    vz, gz = _fleet_rows(z, n_ds, p), _fleet_rows(dz, n_ds, p)
    vt, gt = _fleet_rows(theta, n_ds, p), _fleet_rows(dtheta, n_ds, p)
    k_z, c_z = _fleet_component(z, vz, kernel.h_latent, kernel.scale_latent)
    k_t, c_t = _fleet_component(theta, vt, kernel.h_theta,
                                kernel.scale_theta)
    phi_z = phi_t = None
    with _precision():  # reaches the plain version's matmuls only
        if isinstance(c_z, float):
            phi_z = transport_phi(k_z, k_t, gz, vz, c=c_z,
                                  mu=vz.mean(dim=1, keepdim=True)) \
                .reshape(z.shape)
        if isinstance(c_t, float):
            phi_t = transport_phi(k_t, k_z, gt, vt, c=c_t,
                                  mu=vt.mean(dim=1, keepdim=True))
    if phi_z is None or phi_t is None:
        k_mat = k_z + k_t
    if phi_z is None:
        phi_z = -(_weighted_scores(k_mat, dz, 2)
                  + _se_repulsion(k_z, c_z, z, 2)) / p
    if phi_t is None:
        return phi_z, tree_map(
            lambda g, v: -(_weighted_scores(k_mat, g, 2)
                           + _se_repulsion(k_t, c_t, v, 2)) / p,
            dtheta, theta)
    leaves, offset = [], 0
    for leaf in tree_leaves(theta):
        size = leaf[0, 0].numel()
        leaves.append(phi_t[..., offset:offset + size].reshape(leaf.shape))
        offset += size
    return phi_z, tree_unflatten(theta, leaves)


def _rows_and_factor(x_loc, x_all, h, scale, offset):
    """This rank's ``[P_local, P]`` rows of one SE term and its factor:
    #3's row block for a float bandwidth, the rows of the whole gathered
    matrix for ``h="median"`` (its bandwidth needs every distance)."""
    from dibs_tpu_torch.parallel.shard_ops import se_row_block

    if h == "median":
        k_all, c = median_se(x_all, x_all, scale)
        return k_all[offset:offset + x_loc.shape[0]], c
    return se_row_block(x_loc, x_all, h, scale), -2.0 / h


def _rows_phi(k_rows, k_own, c, values_loc, values_all, grads_all):
    """``-(1/P) (K[:, i]^T grads + c (K_own[:, i]^T v - colsum_i v_i))``
    for this rank's particles ``i``, from the symmetric matrices' rows (``v``
    centred by the global mean)."""
    mu = values_all.mean(dim=0, keepdim=True)
    with _precision():
        drv = k_rows @ grads_all
        rep = c * (k_own @ (values_all - mu)
                   - k_own.sum(dim=1)[:, None] * (values_loc - mu))
    return -(drv + rep) / values_all.shape[0]


def gathered_marginal_transport(kernel, z: torch.Tensor, dz: torch.Tensor,
                                sharding) -> torch.Tensor:
    """This rank's rows of :func:`marginal_transport` under a particle
    sharding, by the all-gather route (kernels the ring does not serve):
    ``z, dz [P_local, d, k, 2]`` are gathered, the kernel matrix's rows come
    from #3 against the gathered particles (or the median heuristic over
    them); ``eval``-only kernels take the autodiff transport of the whole
    batch and keep their rows."""
    from dibs_tpu_torch.parallel.shard_ops import gather_rows, shard_offset

    p_loc = z.shape[0]
    offset = shard_offset(sharding, p_loc)
    z_all, dz_all = gather_rows(z, sharding), gather_rows(dz, sharding)
    if not hasattr(kernel, "matrix_and_grad_factor"):
        return _marginal_transport_autodiff(kernel, z_all, dz_all)[
            offset:offset + p_loc]
    zf, zf_all = z.reshape(p_loc, -1), z_all.reshape(z_all.shape[0], -1)
    k_rows, c = _rows_and_factor(zf, zf_all, kernel.h, kernel.scale, offset)
    return _rows_phi(k_rows, k_rows, c, zf, zf_all,
                     dz_all.reshape(zf_all.shape)).reshape(z.shape)


def gathered_joint_transport(kernel, z: torch.Tensor, theta, dz: torch.Tensor,
                             dtheta, sharding):
    """This rank's rows of :func:`joint_transport` under a particle
    sharding, by the all-gather route: each SE component's rows from #3
    (float bandwidth) or the median heuristic over the gathered batch; the
    parameter tree gathered as flattened rows and split back into its
    leaves."""
    from dibs_tpu_torch.parallel.shard_ops import gather_rows, shard_offset

    p_loc = z.shape[0]
    offset = shard_offset(sharding, p_loc)
    z_all, dz_all = gather_rows(z, sharding), gather_rows(dz, sharding)
    if not hasattr(kernel, "component_matrices_and_factors"):
        gather = lambda t: gather_rows(t, sharding)  # noqa: E731
        phi_z, phi_t = _joint_transport_autodiff(
            kernel, z_all, tree_map(gather, theta), dz_all,
            tree_map(gather, dtheta))
        rows = slice(offset, offset + p_loc)
        return phi_z[rows], tree_map(lambda leaf: leaf[rows], phi_t)
    zf, zf_all = z.reshape(p_loc, -1), z_all.reshape(z_all.shape[0], -1)
    tf = tree_rows(theta)
    tf_all = gather_rows(tf, sharding)
    k_z, c_z = _rows_and_factor(zf, zf_all, kernel.h_latent,
                                kernel.scale_latent, offset)
    k_t, c_t = _rows_and_factor(tf, tf_all, kernel.h_theta,
                                kernel.scale_theta, offset)
    k_rows = k_z + k_t
    phi_z = _rows_phi(k_rows, k_z, c_z, zf, zf_all,
                      dz_all.reshape(zf_all.shape))
    phi_t = _rows_phi(k_rows, k_t, c_t, tf, tf_all,
                      gather_rows(tree_rows(dtheta), sharding))
    leaves, col = [], 0
    for leaf in tree_leaves(theta):
        size = leaf[0].numel()
        leaves.append(phi_t[:, col:col + size].reshape(leaf.shape))
        col += size
    return phi_z.reshape(z.shape), tree_unflatten(theta, leaves)


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
        phi_z = phi_t = None
        if not _sharded(kernel):
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
