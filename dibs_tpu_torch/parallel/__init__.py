"""Particle-sharded SVGD over ``torch.distributed`` (counterpart of
``dibs_tpu/parallel/``).

The reference is single-controller: one process holds global arrays laid
out over a ``jax.sharding.Mesh`` and XLA inserts the collectives. The port
follows the PyTorch idiom instead, one process a card (``torchrun``), single
program, multiple data: every rank runs the same engine on its own block of
the particle axis and calls the collectives itself.

* :func:`make_particle_mesh` is a one-dimensional ``DeviceMesh`` named
  ``"p"`` over the default process group (initialize it first:
  ``torch.distributed.init_process_group``), or with ``n_mc > 1`` the
  two-dimensional ``("p", "mc")`` mesh, whose second axis splits the Monte
  Carlo samples of the estimators;
* :func:`particle_sharding` is the engines' ``sharding=``: the mesh, the
  axis name, this rank and the size of the ``"p"`` axis, and this rank and
  the size of the ``"mc"`` axis (1 on a one-dimensional mesh);
* :func:`shard_state` keeps this rank's block of every particle-major leaf
  of a state (rank >= 2, a leading ``P`` that the ``"p"`` axis divides) and
  leaves the rest replicated: the step counter, the seed and the rank-1
  leaves (``sf_baseline``), as the reference's ``_leaf_spec``. The state is
  never split over ``"mc"``: every ``"mc"`` rank of a ``"p"`` block holds
  the same block. :func:`gather_state` rebuilds the global state, which
  torch has no global array for.

Each shard draws its noise at its particles' global indices (the sampler
and the fused kernels take the shard's first particle as
``particle_offset``), so every per-particle quantity of a sharded step is
bitwise that of the unsharded step; only the ``[P, P]`` transport couples
the shards (:mod:`dibs_tpu_torch.parallel.ring`, or the all-gather route of
:mod:`dibs_tpu_torch.inference.transport`), and it differs from the
unsharded one in summation order only. A run whose particle count the
``"p"`` axis does not divide is replicated over it: every ``"p"`` rank runs
the whole unsharded step. A one-rank mesh shards nothing: its step is the
unsharded step.

On the ``("p", "mc")`` mesh, an ``"mc"`` rank draws its block of the
samples at their global sample indices (``sample_offset``), and the
estimators' sums over samples become local sums followed by collectives
over the ``"mc"`` group (:mod:`dibs_tpu_torch.inference.estimators`);
:func:`constrain_mc` takes this rank's block of a ``[P, M, ...]`` tree.

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
    """The ``sharding=`` of the engines: a mesh axis and this rank on it,
    and this rank on the mesh's ``"mc"`` axis (size 1 without one)."""

    mesh: Any  # torch.distributed.device_mesh.DeviceMesh
    axis: str  # the mesh dimension's name ("p"; a fleet's "datasets")
    rank: int  # this process's index on the axis
    world: int  # the axis's size
    group: Any  # the axis's process group
    host_group: Any  # a gloo group over the same ranks (host-side checks)
    timeout: datetime.timedelta  # the longest a collective may wait
    mc_rank: int = 0  # this process's index on the "mc" axis
    mc_size: int = 1  # the "mc" axis's size
    mc_group: Any = None  # the "mc" axis's process group
    # a gloo group over every rank of a two-dimensional mesh whose backend
    # is not gloo (the device check's), else None
    mesh_host_group: Any = None


def make_particle_mesh(devices=None, n_mc: int = 1):
    """A ``DeviceMesh`` over every rank of the default process group:
    one-dimensional, named ``"p"``, or with ``n_mc > 1`` two-dimensional,
    named ``("p", "mc")``, of shape ``(world // n_mc, n_mc)`` in row-major
    order (rank ``r`` at ``p = r // n_mc``, ``mc = r % n_mc``, as the
    reference's ``devices.reshape(size // n_mc, n_mc)``). ``devices`` is
    the mesh's device type (``"cuda"`` for NCCL, ``"cpu"`` otherwise by
    default). Raises ``ValueError`` where ``n_mc`` does not divide the
    world."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_particle_mesh: call torch.distributed."
                           "init_process_group first (torchrun sets its "
                           "address, rank and world size)")
    if devices is None:
        devices = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if not isinstance(devices, str):
        raise ValueError(f"devices must be a device type such as 'cuda' or "
                         f"'cpu'; got {devices!r}")
    size = dist.get_world_size()
    if n_mc == 1:
        return DeviceMesh(devices, list(range(size)),
                          mesh_dim_names=(PARTICLE_AXIS,))
    if n_mc < 1 or size % n_mc:
        raise ValueError(f"{size} devices not divisible by n_mc={n_mc}")
    ranks = torch.arange(size).reshape(size // n_mc, n_mc)
    return DeviceMesh(devices, ranks, mesh_dim_names=(PARTICLE_AXIS,
                                                      MC_AXIS))


def _host_group(mesh, dim: int, group, timeout):
    """A ``gloo`` group over the ranks of this rank's line of the mesh
    along dimension ``dim`` (``group`` itself where it is ``gloo``). Every
    rank creates every line's group, in the same order, as
    ``new_group`` requires."""
    if dist.get_backend(group) == "gloo":
        return group
    lines = mesh.mesh.movedim(dim, -1).reshape(-1, mesh.mesh.shape[dim])
    mine = None
    for line in lines.tolist():
        made = dist.new_group(line, backend="gloo", timeout=timeout)
        if dist.get_rank() in line:
            mine = made
    return mine


def axis_sharding(mesh, axis: str,
                  timeout: datetime.timedelta = COLLECTIVE_TIMEOUT
                  ) -> ParticleSharding:
    """:class:`ParticleSharding` of the mesh dimension named ``axis``, and
    of the mesh's ``"mc"`` dimension where it has one (collective: every
    rank of the mesh calls it)."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if axis not in names:
        raise ValueError(f"the mesh has no axis {axis!r} (axes {names})")
    dim = names.index(axis)
    group = mesh.get_group(axis)
    host = _host_group(mesh, dim, group, timeout)
    mc = {}
    if MC_AXIS in names and axis != MC_AXIS:
        mc = dict(mc_rank=mesh.get_local_rank(MC_AXIS),
                  mc_size=mesh.size(names.index(MC_AXIS)),
                  mc_group=mesh.get_group(MC_AXIS))
    if len(names) > 1 and dist.get_backend(group) != "gloo":
        mc["mesh_host_group"] = dist.new_group(
            mesh.mesh.flatten().tolist(), backend="gloo", timeout=timeout)
    return ParticleSharding(mesh, axis, mesh.get_local_rank(axis),
                            mesh.size(dim), group, host, timeout, **mc)


def particle_sharding(mesh) -> ParticleSharding:
    """The engines' ``sharding=`` for a mesh from
    :func:`make_particle_mesh` (collective: every rank calls it)."""
    return axis_sharding(mesh, PARTICLE_AXIS)


def mc_shard_size(sharding) -> int:
    """The size of the ``"mc"`` axis (1 without a sharding or on a
    one-dimensional mesh)."""
    return 1 if sharding is None else sharding.mc_size


def constrain_mc(tree: Any, sharding) -> Any:
    """This rank's block of the sample axis (dim 1) of every ``[P, M,
    ...]`` tensor of ``tree`` whose ``M`` the ``"mc"`` axis divides; the
    rest as it is. Nothing changes on a one-dimensional mesh (the
    reference pins the same leaves to the ``("p", "mc")`` layout)."""
    n_mc = mc_shard_size(sharding)
    if n_mc == 1:
        return tree

    def keep(leaf):
        if leaf.dim() < 2 or leaf.shape[1] % n_mc:
            return leaf
        n = leaf.shape[1] // n_mc
        return leaf[:, sharding.mc_rank * n:(sharding.mc_rank + 1) * n]

    return _on_tensors(keep, tree)


def check_devices(sharding: ParticleSharding, device) -> None:
    """Raises ``ValueError`` where the ranks' devices cannot run the
    backend: NCCL needs one CUDA card a rank, and refuses two ranks on one
    card. Collective over every rank of the mesh (its host groups)."""
    device = torch.device(device)
    if dist.get_backend(sharding.group) != "nccl":
        return
    if device.type != "cuda":
        raise ValueError(f"the NCCL backend needs CUDA devices; this rank's "
                         f"engine runs on {device}")
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    host = sharding.mesh_host_group or sharding.host_group
    seen = [None] * dist.get_world_size(host)
    dist.all_gather_object(seen, (socket.gethostname(), index), group=host)
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
