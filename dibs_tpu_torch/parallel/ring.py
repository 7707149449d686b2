"""Ring-blockwise SVGD transport over a sharded particle axis (counterpart
of ``dibs_tpu/parallel/ring.py``).

The ``[P, P]`` kernel matrix and the transport are the only coupling
between particles. Each rank keeps its own block; at ring step ``r`` it
computes one ``[P_blk, P_local]`` kernel tile against the block it holds
and forwards that block to the next rank (``batch_isend_irecv``, started
before the tile so the transfer overlaps it). No rank holds the whole
particle batch. Everything the transport needs accumulates over the tiles:

    driver_i    = sum_m K[m, i] grad_m
    repulsion_i = c (sum_m K[m, i] v_m - (sum_m K[m, i]) v_i)

The particles are centred by the global mean first (one all-reduce): the
repulsion and the distances are shift-invariant, and centring keeps the
rounding relative to the particle differences. The tile is the Gram form
at IEEE float32; the driver and repulsion products follow
:func:`~dibs_tpu_torch.config.set_transport_matmul_precision`. The result
equals the unsharded transport up to summation order. The rotating blocks
travel as :func:`~dibs_tpu_torch.config.ring_payload_dtype` (float32, or
bfloat16 on request): they are cast before the first send only and
forwarded as received, and the rank's own tile uses its exact block. The
reference computes all of this outside its kernels; so does the port.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from dibs_tpu_torch.config import (
    matmul_precision,
    ring_payload_dtype,
    transport_matmul_precision,
)
from dibs_tpu_torch.parallel.shard_ops import all_reduce_sum, start_rotation
from dibs_tpu_torch.utils.tree import tree_leaves, tree_rows, tree_unflatten

__all__ = ["ring_marginal_transport", "ring_joint_transport", "ring_available"]


def ring_available(kernel, sharding) -> bool:
    """The ring needs a sharding and one of the built-in SE kernels with
    float bandwidths (the tile reads their ``h`` and ``scale``); others go
    through the all-gather route."""
    from dibs_tpu_torch.kernel import (
        AdditiveFrobeniusSEKernel,
        JointAdditiveFrobeniusSEKernel,
    )

    if sharding is None:
        return False
    if not isinstance(kernel, (AdditiveFrobeniusSEKernel,
                               JointAdditiveFrobeniusSEKernel)):
        return False
    return not any(isinstance(getattr(kernel, name, None), str)
                   for name in ("h", "h_latent", "h_theta"))


def _se_tile(x_blk, y_loc, h, scale):
    """``[P_blk, n] x [P_loc, n] -> [P_blk, P_loc]`` SE tile, Gram form at
    IEEE float32."""
    x_sq = (x_blk * x_blk).sum(dim=1, keepdim=True)
    y_sq = (y_loc * y_loc).sum(dim=1, keepdim=True)
    with matmul_precision("highest"):
        cross = x_blk @ y_loc.T
    return scale * torch.exp(-(x_sq + y_sq.T - 2.0 * cross) / h)


def _kt_mm(k_blk, blk):
    """``K_blk^T blk`` at the transport's matmul precision."""
    with matmul_precision(transport_matmul_precision()):
        return k_blk.T @ blk


def _ring_loop(sharding, rotating, tile_step, acc):
    """Runs ``tile_step(acc, blocks)`` once for each rank's blocks,
    rotating ``rotating`` (a tuple of ``[P_blk, n]`` tensors) around the
    ring: ``world - 1`` rotations, each started before the tile it
    overlaps."""
    wire = ring_payload_dtype()
    blocks = rotating
    for r in range(sharding.world):
        finish = None
        if r < sharding.world - 1:  # the last tile needs no forward
            finish = start_rotation(
                tuple(b.to(wire) for b in blocks) if r == 0 else blocks,
                sharding)
        acc = tile_step(acc, tuple(b.to(torch.float32) for b in blocks))
        if finish is not None:
            blocks = finish()
    return acc


def _centred(flat, sharding, n_particles):
    mu = all_reduce_sum(flat.sum(dim=0, keepdim=True), sharding)
    return flat - mu / n_particles


def ring_marginal_transport(kernel, z: torch.Tensor, dz: torch.Tensor,
                            sharding) -> torch.Tensor:
    """Ring analog of :func:`dibs_tpu_torch.inference.transport.
    marginal_transport` on this rank's ``z, dz [P_local, d, k, 2]``:
    returns its rows of ``phi_z``."""
    p_loc = z.shape[0]
    n_particles = p_loc * sharding.world
    h, scale, factor = kernel.h, kernel.scale, kernel.grad_factor_z()
    z_f = _centred(z.reshape(p_loc, -1), sharding, n_particles)
    dz_f = dz.reshape(p_loc, -1)

    def tile_step(acc, blocks):
        zb, dzb = blocks
        k_blk = _se_tile(zb, z_f, h, scale)  # [P_blk, P_loc]
        drv, rep_kv, colsum = acc
        return (drv + _kt_mm(k_blk, dzb), rep_kv + _kt_mm(k_blk, zb),
                colsum + k_blk.sum(dim=0))

    drv, rep_kv, colsum = _ring_loop(
        sharding, (z_f, dz_f), tile_step,
        (torch.zeros_like(dz_f), torch.zeros_like(z_f),
         torch.zeros(p_loc, device=z.device)))
    rep = factor * (rep_kv - colsum[:, None] * z_f)
    return (-(drv + rep) / n_particles).reshape(z.shape)


def ring_joint_transport(kernel, z: torch.Tensor, theta: Any,
                         dz: torch.Tensor, dtheta: Any,
                         sharding) -> Tuple[torch.Tensor, Any]:
    """Ring analog of :func:`dibs_tpu_torch.inference.transport.
    joint_transport` on this rank's particles: the parameter tree rotates
    as one flattened ``[P_blk, n_theta]`` block; ``K = K_z + K_theta``
    drives both transports and each component gives its repulsion."""
    p_loc = z.shape[0]
    n_particles = p_loc * sharding.world
    h_z, h_t = kernel.h_latent, kernel.h_theta
    s_z, s_t = kernel.scale_latent, kernel.scale_theta
    c_z, c_t = kernel.grad_factor_z(), kernel.grad_factor_theta()
    z_f = _centred(z.reshape(p_loc, -1), sharding, n_particles)
    t_f = _centred(tree_rows(theta), sharding, n_particles)
    dz_f, dt_f = dz.reshape(p_loc, -1), tree_rows(dtheta)

    def tile_step(acc, blocks):
        zb, dzb, tb, dtb = blocks
        kz_blk = _se_tile(zb, z_f, h_z, s_z)
        kt_blk = _se_tile(tb, t_f, h_t, s_t)
        k_blk = kz_blk + kt_blk
        drv_z, rep_z, cs_z, drv_t, rep_t, cs_t = acc
        return (drv_z + _kt_mm(k_blk, dzb), rep_z + _kt_mm(kz_blk, zb),
                cs_z + kz_blk.sum(dim=0), drv_t + _kt_mm(k_blk, dtb),
                rep_t + _kt_mm(kt_blk, tb), cs_t + kt_blk.sum(dim=0))

    zeros = torch.zeros(p_loc, device=z.device)
    drv_z, rep_z, cs_z, drv_t, rep_t, cs_t = _ring_loop(
        sharding, (z_f, dz_f, t_f, dt_f), tile_step,
        (torch.zeros_like(dz_f), torch.zeros_like(z_f), zeros,
         torch.zeros_like(dt_f), torch.zeros_like(t_f), zeros))
    phi_z = -(drv_z + c_z * (rep_z - cs_z[:, None] * z_f)) / n_particles
    phi_t = -(drv_t + c_t * (rep_t - cs_t[:, None] * t_f)) / n_particles
    leaves, offset = [], 0
    for leaf in tree_leaves(theta):
        size = leaf[0].numel()
        leaves.append(phi_t[:, offset:offset + size].reshape(leaf.shape))
        offset += size
    return phi_z.reshape(z.shape), tree_unflatten(theta, leaves)
