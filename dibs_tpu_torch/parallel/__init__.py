"""Particle-sharded SVGD over ``torch.distributed`` (counterpart of
``dibs_tpu/parallel/``).

The reference is single-controller: one process holds global arrays laid
out over a ``jax.sharding.Mesh`` and XLA inserts the collectives. The port
follows the PyTorch idiom instead, one process a card (``torchrun``), single
program, multiple data: every rank runs the same engine on its own block of
the particle axis and calls the collectives itself.

* :func:`make_particle_mesh` is a one-dimensional ``DeviceMesh`` named
  ``"p"`` over the default process group (initialize it first:
  ``torch.distributed.init_process_group``);
* :func:`particle_sharding` is the engines' ``sharding=``: the mesh, the
  axis name, this rank and the world size;
* :func:`shard_state` keeps this rank's block of every particle-major leaf
  of a state (rank >= 2, a leading ``P`` that the world divides) and leaves
  the rest replicated: the step counter, the seed and the rank-1 leaves
  (``sf_baseline``), as the reference's ``_leaf_spec``;
  :func:`gather_state` rebuilds the global state, which torch has no
  global array for.

Each shard draws its noise at its particles' global indices (the sampler
and the fused kernels take the shard's first particle as
``particle_offset``), so every per-particle quantity of a sharded step is
bitwise that of the unsharded step; only the ``[P, P]`` transport couples
the shards (:mod:`dibs_tpu_torch.parallel.ring`, or the all-gather route of
:mod:`dibs_tpu_torch.inference.transport`), and it differs from the
unsharded one in summation order only. A run whose particle count the world
does not divide is replicated: every rank runs the whole unsharded step. A
one-rank mesh shards nothing: its step is the unsharded step.

Every collective waits at most ``sharding.timeout`` (``COLLECTIVE_TIMEOUT``
by default), so a rank that hangs fails the run instead of hanging it. Two
NCCL ranks on one card are refused up front (NCCL refuses duplicate
devices); ``gloo`` ranks may share a card, and their point-to-point sends go
through the host (one branch on the backend, see ``shard_ops``).
"""
from __future__ import annotations

import datetime
import socket
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from dibs_tpu_torch.utils.tree import tree_map

__all__ = [
    "make_particle_mesh",
    "particle_sharding",
    "shard_state",
    "make_constraint",
    "shard_ops",
]

PARTICLE_AXIS = "p"
MC_AXIS = "mc"
# the longest any collective of a sharded run may wait
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=300)


class ParticleSharding(NamedTuple):
    """The ``sharding=`` of the engines: a mesh axis and this rank on it."""

    mesh: Any  # torch.distributed.device_mesh.DeviceMesh
    axis: str  # the mesh dimension's name ("p"; a fleet's "datasets")
    rank: int  # this process's index on the axis
    world: int  # the axis's size
    group: Any  # the axis's process group
    host_group: Any  # a gloo group over the same ranks (host-side checks)
    timeout: datetime.timedelta  # the longest a collective may wait


def make_particle_mesh(devices=None, n_mc: int = 1):
    """A one-dimensional ``DeviceMesh`` named ``"p"`` over every rank of the
    default process group. ``devices`` is the mesh's device type (``"cuda"``
    for NCCL, ``"cpu"`` otherwise by default). ``n_mc > 1`` (the
    reference's ``("p", "mc")`` mesh, which shards the Monte Carlo samples
    inside the estimators) raises ``NotImplementedError``."""
    from torch.distributed.device_mesh import DeviceMesh

    if n_mc != 1:
        raise NotImplementedError(
            f"n_mc={n_mc}: the ('p', 'mc') mesh needs all-reduces over the "
            "samples inside the estimators; it is the next item of slice 6 "
            "(ROADMAP.md queue 1, item 3)")
    if not dist.is_initialized():
        raise RuntimeError("make_particle_mesh: call torch.distributed."
                           "init_process_group first (torchrun sets its "
                           "address, rank and world size)")
    if devices is None:
        devices = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if not isinstance(devices, str):
        raise ValueError(f"devices must be a device type such as 'cuda' or "
                         f"'cpu'; got {devices!r}")
    return DeviceMesh(devices, list(range(dist.get_world_size())),
                      mesh_dim_names=(PARTICLE_AXIS,))


def axis_sharding(mesh, axis: str,
                  timeout: datetime.timedelta = COLLECTIVE_TIMEOUT
                  ) -> ParticleSharding:
    """:class:`ParticleSharding` of the mesh dimension named ``axis``
    (collective: every rank of the mesh calls it)."""
    names = getattr(mesh, "mesh_dim_names", None) or ()
    if axis not in names:
        raise ValueError(f"the mesh has no axis {axis!r} (axes {names})")
    group = mesh.get_group(axis)
    host = group
    if dist.get_backend(group) != "gloo":
        host = dist.new_group(mesh.mesh.flatten().tolist(), backend="gloo",
                              timeout=timeout)
    return ParticleSharding(mesh, axis, mesh.get_local_rank(axis),
                            mesh.size(names.index(axis)), group, host,
                            timeout)


def particle_sharding(mesh) -> ParticleSharding:
    """The engines' ``sharding=`` for a mesh from
    :func:`make_particle_mesh` (collective: every rank calls it)."""
    return axis_sharding(mesh, PARTICLE_AXIS)


def check_devices(sharding: ParticleSharding, device) -> None:
    """Raises ``ValueError`` where the ranks' devices cannot run the
    backend: NCCL needs one CUDA card a rank, and refuses two ranks on one
    card. Collective over the host group."""
    device = torch.device(device)
    if dist.get_backend(sharding.group) != "nccl":
        return
    if device.type != "cuda":
        raise ValueError(f"the NCCL backend needs CUDA devices; this rank's "
                         f"engine runs on {device}")
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    seen = [None] * sharding.world
    dist.all_gather_object(seen, (socket.gethostname(), index),
                           group=sharding.host_group)
    dup = sorted({s for s in seen if seen.count(s) > 1})
    if dup:
        cards = ", ".join(f"{host}:cuda:{i}" for host, i in dup)
        raise ValueError(
            f"NCCL ranks share a card ({cards}): NCCL refuses duplicate "
            "devices; give each rank its own card (torchrun: "
            "cuda:LOCAL_RANK) or use the gloo backend")


def _is_particle_leaf(leaf, world: int) -> bool:
    return leaf.dim() >= 2 and leaf.shape[0] > 0 and leaf.shape[0] % world == 0


def _on_tensors(fn, state):
    """``fn`` on every tensor of a state tree; ints and ``None`` stay."""
    return tree_map(lambda leaf: fn(leaf) if isinstance(leaf, torch.Tensor)
                    else leaf, state)


def shard_state(state: Any, sharding: ParticleSharding) -> Any:
    """This rank's block of every particle-major leaf of ``state`` (rank
    >= 2 with a leading dim the world divides); everything else (the step
    counter, the seed, rank-1 leaves, a batch the world does not divide)
    stays as it is, replicated."""
    w, r = sharding.world, sharding.rank

    def keep(leaf):
        if not _is_particle_leaf(leaf, w):
            return leaf
        n = leaf.shape[0] // w
        return leaf[r * n:(r + 1) * n].clone()

    return _on_tensors(keep, state)


def make_constraint(sharding: ParticleSharding):
    """``constrain(tree)``: :func:`shard_state`'s rule on any tree of
    global tensors (the reference's ``with_sharding_constraint``)."""
    return lambda tree: shard_state(tree, sharding)


def gather_state(state: Any, sharding: ParticleSharding) -> Any:
    """The global state of a sharded ``state``: every rank >= 2 leaf
    all-gathered along its leading (particle) axis, in rank order; the rest
    as it is. Collective: every rank calls it."""
    from dibs_tpu_torch.parallel.shard_ops import gather_rows

    return _on_tensors(lambda leaf: gather_rows(leaf, sharding)
                       if leaf.dim() >= 2 else leaf, state)


from dibs_tpu_torch.parallel import shard_ops  # noqa: E402
