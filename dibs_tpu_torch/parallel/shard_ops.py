"""Per-shard kernel launches and the collectives of a particle-sharded run
(counterpart of ``dibs_tpu/parallel/shard_ops.py``).

Each rank launches the kernels on its own block of particles. Two rules
keep a sharded run bitwise the unsharded one in every per-particle
quantity:

* **Global particle counters.** The sampler #1 and the fused estimators
  #5-#8 draw their noise from Philox with counter ``(element, sample,
  particle, stream)``. A shard holding particles ``[o, o + P_local)`` passes
  ``particle_offset = o``, so its particle ``b`` draws at counter ``o +
  b``, as in one launch over all the particles (the reference's
  ``seed_offset``).
* **Row blocks of the SE matrix.** #3 computes the ``[P_local, P]`` rows of
  the kernel matrix against the all-gathered opposite side.
* **Global sample counters** on the ``("p", "mc")`` mesh. Where the ``"mc"``
  axis divides a launch's ``M`` samples, ``"mc"`` rank ``j`` draws samples
  ``[j M / n_mc, (j + 1) M / n_mc)`` at ``sample_offset = j M / n_mc``:
  bitwise that slice of one launch. :func:`mc_gather` and :func:`mc_sum`
  are the collectives over the ``"mc"`` group that turn the estimators'
  sums over samples into sums over all ``M``.

The BGe pairs #2 score each graph on its own, so each shard scores its own
particles' graphs. The collectives here wait at most ``sharding.timeout``.
``gloo`` does not send CUDA tensors point to point, so its sends and
receives go through the host; that is the one branch on the backend, taken
before the call.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from dibs_tpu_torch.parallel import constrain_mc, mc_shard_size

__all__ = [
    "particle_axis_name",
    "sharded_gumbel_graphs",
    "sharded_se_matrix",
    "sharded_fused_linear",
    "sharded_fused_nonlinear",
]


def particle_axis_name(sharding) -> Optional[str]:
    """The sharding's axis name (``"p"``), or ``None`` without one."""
    return None if sharding is None else sharding.axis


def divides_mesh(sharding, n: int) -> bool:
    """True if a leading axis of size ``n`` splits evenly over the mesh."""
    return sharding is not None and n % sharding.world == 0


def shard_offset(sharding, n_local: int) -> int:
    """The global index of this rank's first particle when each of the
    ``world`` ranks holds ``n_local`` (0 without a sharding)."""
    return 0 if sharding is None else sharding.rank * n_local


# --- collectives -------------------------------------------------------------


def _wait(works, sharding) -> None:
    for work in works if isinstance(works, list) else [works]:
        work.wait(timeout=sharding.timeout)


def host_p2p(sharding, t: torch.Tensor) -> bool:
    """True where point-to-point sends of ``t`` go through the host: a
    CUDA tensor on a ``gloo`` group."""
    return t.is_cuda and dist.get_backend(sharding.group) == "gloo"


def gather_rows(t: torch.Tensor, sharding) -> torch.Tensor:
    """Every rank's ``t`` concatenated along dim 0, in rank order (one
    all-gather)."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(sharding.world)]
    _wait(dist.all_gather(parts, t, group=sharding.group, async_op=True),
          sharding)
    return torch.cat(parts)


def mc_block(sharding, n_samples: int):
    """``(sample_offset, n_local)``: this rank's block of ``n_samples``
    samples on the ``"mc"`` axis, or ``(0, n_samples)`` where the axis is
    size 1 or does not divide ``n_samples`` (every ``"mc"`` rank then
    draws all of them, replicated)."""
    n_mc = mc_shard_size(sharding)
    if n_mc == 1 or n_samples % n_mc:
        return 0, n_samples
    n_local = n_samples // n_mc
    return sharding.mc_rank * n_local, n_local


def mc_gather(t: torch.Tensor, sharding, dim: int = 1) -> torch.Tensor:
    """Every ``"mc"`` rank's ``t`` concatenated along ``dim`` (the sample
    axis), in ``"mc"`` order (one all-gather over the ``"mc"`` group)."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(sharding.mc_size)]
    _wait(dist.all_gather(parts, t, group=sharding.mc_group, async_op=True),
          sharding)
    return torch.cat(parts, dim=dim)


def mc_sum(t: torch.Tensor, sharding) -> torch.Tensor:
    """The sum of every ``"mc"`` rank's ``t``: one all-gather over the
    ``"mc"`` group, then the same sum of the same parts on every rank, so
    every rank holds the same bits whatever the backend's reduction
    order (an all-reduce need not give them)."""
    return mc_gather(t[None], sharding, dim=0).sum(0)


def all_reduce_sum(t: torch.Tensor, sharding) -> torch.Tensor:
    """The sum of every rank's ``t`` (one all-reduce)."""
    t = t.clone()
    _wait(dist.all_reduce(t, group=sharding.group, async_op=True), sharding)
    return t


def start_rotation(blocks, sharding):
    """Starts sending each of ``blocks`` to the next rank and receiving the
    previous rank's (one ``batch_isend_irecv``); returns ``finish()``,
    which waits and gives the received blocks on the blocks' device."""
    group, rank, world = sharding.group, sharding.rank, sharding.world
    nxt = dist.get_global_rank(group, (rank + 1) % world)
    prv = dist.get_global_rank(group, (rank - 1) % world)
    host = host_p2p(sharding, blocks[0])
    send = [b.cpu() if host else b.contiguous() for b in blocks]
    recv = [torch.empty_like(s) for s in send]
    ops = ([dist.P2POp(dist.isend, s, nxt, group) for s in send]
           + [dist.P2POp(dist.irecv, r, prv, group) for r in recv])
    works = dist.batch_isend_irecv(ops)

    def finish():
        _wait(works, sharding)
        if host:
            return tuple(r.to(b.device) for r, b in zip(recv, blocks))
        return tuple(recv)

    return finish


# --- per-shard kernels -------------------------------------------------------


def sharded_gumbel_graphs(scores, seed, stream, alpha, tau, n_samples, *,
                          sharding, hard: bool = False, eps=None):
    """The sampler #1 on this rank's ``scores [P_local, d, d]``: its
    ``[P_local, n_samples, d, d]`` samples, bitwise those of its particles
    in one launch over all of them. On the ``("p", "mc")`` mesh, where the
    ``"mc"`` axis divides ``n_samples``, it returns this rank's block
    ``[P_local, n_samples / n_mc, d, d]``, drawn at its global sample
    offset and bitwise that slice (an injected ``eps`` is the whole
    ``[P_local, n_samples, d, d]`` and is sliced here); elsewhere every
    ``"mc"`` rank draws all the samples, replicated, as the reference
    does. The reference also asks the per-shard count to fill its
    kernel's sample groups, whose seeds are per group; the port's
    counters are per sample, so any split that divides ``n_samples``
    serves."""
    from dibs_tpu_torch.ops.gpu_kernels import gumbel_graphs

    first, n_local = mc_block(sharding, n_samples)
    if eps is not None:
        eps = constrain_mc(eps, sharding).contiguous()
    return gumbel_graphs(scores, seed, stream, alpha, tau, n_local, hard,
                         eps=eps, particle_offset=shard_offset(
                             sharding, scores.shape[0]),
                         sample_offset=first)


def se_row_block(x, y_all, h: float, scale: float):
    """#3's ``[A_local, B]`` rows of the SE matrix: this rank's ``x
    [A_local, n]`` against the all-gathered ``y_all [B, n]``."""
    from dibs_tpu_torch.ops.gpu_kernels import se_matrix

    return se_matrix(x.contiguous(), y_all.contiguous(), float(h),
                     float(scale))


def sharded_se_matrix(x, y, h: float, scale: float, *, sharding):
    """``[A_local, B]``: the rows of the ``[A, B]`` SE matrix of this rank's
    ``x [A_local, n]`` against every rank's ``y [B_local, n]`` (all-gathered
    here)."""
    return se_row_block(x, gather_rows(y, sharding), h, scale)


def sharded_fused_linear(*, zs, thetas, x, interv_mask, seed, streams, alpha,
                         tau, n_samples, model, sharding, eps=None,
                         single_pass: bool = True):
    """The fused linear-Gaussian estimators (#5, or #6 + #7; the wide tier
    past d = 70) on this rank's particles, with global particle counters:
    bitwise its particles' part of one call over all of them."""
    from dibs_tpu_torch.inference.fused_linear import fused_linear_estimators

    return fused_linear_estimators(
        zs=zs, thetas=thetas, x=x, interv_mask=interv_mask, seed=seed,
        streams=streams, alpha=alpha, tau=tau, n_samples=n_samples,
        model=model, eps=eps, single_pass=single_pass,
        particle_offset=shard_offset(sharding, zs.shape[0]))


def sharded_fused_nonlinear(*, zs, thetas, x, interv_mask, seed, streams,
                            alpha, tau, n_samples, model, sharding,
                            eps=None):
    """Kernel #8's estimators on this rank's particles, with global
    particle counters (bitwise as :func:`sharded_fused_linear`)."""
    from dibs_tpu_torch.inference.fused_nonlinear import (
        fused_nonlinear_estimators,
    )

    return fused_nonlinear_estimators(
        zs=zs, thetas=thetas, x=x, interv_mask=interv_mask, seed=seed,
        streams=streams, alpha=alpha, tau=tau, n_samples=n_samples,
        model=model, eps=eps,
        particle_offset=shard_offset(sharding, zs.shape[0]))
