"""Fleet inference: many independent structure-learning problems at once
(PyTorch twin of ``dibs_tpu/fleet.py``).

``fleet_sample`` runs one engine's SVGD on ``B`` independent datasets of the
same shape as one batched step: every tensor of the state leads with the
dataset axis, and every kernel of the step takes that axis in one launch
(the sampler #1 and the fused joint kernels #5-#8, both tiers, read each
dataset's key, the BGe pairs #2 each dataset's posterior matrices, #5-#8
each dataset's data, the SE matrix #3 and the transport #4 one grid slice
a dataset; the generic estimators score each particle's samples on its
dataset's data in one call). A fleet step therefore launches each kernel
as many times as one dataset's step, whatever ``B`` is: on a card where
the d <= 30 steps are bound by the host's launches, the host cost of
``B`` datasets is about that of one.

Datasets are independent: dataset ``b`` of a fleet equals a single engine
run on ``xs[b]`` with ``sample(seed=fleet_seeds(seed, B)[b])`` (the same
initial particles, the same noise streams, the same key).

Serves every engine a single run serves: ``MarginalDiBS`` (``score``,
``score_rb``) and ``JointDiBS`` (``reparam`` through the fused kernels of
both tiers or the generic estimators, and ``score``), with every SVGD
kernel (float or ``"median"`` bandwidths, or only ``eval``). Like the
reference, it refuses an engine with a particle ``sharding``. Typical
use::

    dibs = JointDiBS(x=xs[0], graph_model=gm, likelihood_model=lm)
    gs, thetas = fleet_sample(dibs, xs=xs, seed=0, n_particles=30,
                              steps=1000)   # gs: [B, P, d, d]

With ``mesh=`` (a ``DeviceMesh`` with a ``"datasets"`` axis, one rank a
card) each rank runs ``B / world`` of the datasets, keyed by their entries
of ``fleet_seeds(seed, B)``, and every rank gets the gathered result:
datasets are independent, so no other collective runs.
"""
from __future__ import annotations

import torch

from dibs_tpu_torch.inference.optimizers import ScaleByRmsState
from dibs_tpu_torch.inference.svgd import JointDiBS, MarginalDiBS, SVGDState
from dibs_tpu_torch.ops.edges import particle_to_g_lim
from dibs_tpu_torch.parallel import axis_sharding, gather_state
from dibs_tpu_torch.parallel.shard_ops import gather_rows
from dibs_tpu_torch.utils.tree import tree_map

__all__ = ["fleet_sample", "fleet_seeds", "fleet_init_state", "fleet_step"]


def fleet_seeds(seed: int, n_datasets: int) -> torch.Tensor:
    """The per-dataset seeds of a fleet: ``n_datasets`` draws from
    ``[0, 2^63 - 1)`` of ``torch.randint`` under ``torch.Generator().
    manual_seed(seed)``, int64 on the CPU. Dataset ``b`` is keyed, and its
    particles initialised, exactly as ``sample(seed=int(seeds[b]))``."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 2 ** 63 - 1, (n_datasets,), generator=gen,
                         dtype=torch.int64)


def _stack(*trees):
    return tree_map(lambda *leaves: torch.stack(leaves), *trees)


def fleet_init_state(dibs, seeds: torch.Tensor,
                     n_particles: int) -> SVGDState:
    """The stacked initial state of a fleet: each dataset's
    ``dibs.init_state(seed=seeds[b])``, its tensors (and parameter leaves)
    stacked on a leading dataset axis, and ``seed`` the ``[B]`` int64 keys
    on ``dibs``'s device."""
    states = [dibs.init_state(seed=int(s), n_particles=n_particles)
              for s in seeds.tolist()]
    joint = states[0].theta is not None
    return SVGDState(
        t=0, seed=seeds.to(dibs.device),
        z=torch.stack([st.z for st in states]),
        theta=_stack(*[st.theta for st in states]) if joint else None,
        opt_state_z=(ScaleByRmsState(nu=torch.stack(
            [st.opt_state_z[0].nu for st in states])),),
        opt_state_theta=((ScaleByRmsState(nu=_stack(
            *[st.opt_state_theta[0].nu for st in states])),)
                         if joint else None),
        sf_baseline=torch.stack([st.sf_baseline for st in states]))


def _check(dibs, xs, interv_masks):
    if not isinstance(dibs, (MarginalDiBS, JointDiBS)):
        raise ValueError(f"fleet_sample: not a DiBS engine: "
                         f"{type(dibs).__name__}")
    xs = torch.as_tensor(xs, dtype=torch.float32).to(dibs.device)
    if xs.dim() != 3 or tuple(xs.shape[1:]) != tuple(dibs.x.shape):
        raise ValueError(
            f"xs must be [B, N, d] with (N, d) == {tuple(dibs.x.shape)}; "
            f"got {tuple(xs.shape)}")
    if interv_masks is None:
        interv_masks = torch.zeros(xs.shape, dtype=torch.int32)
    interv_masks = torch.as_tensor(interv_masks).to(dibs.device)
    if tuple(interv_masks.shape) != tuple(xs.shape):
        raise ValueError("interv_masks must match xs's shape")
    return xs, interv_masks


def fleet_step(dibs, xs, interv_masks=None):
    """``step(state, noise=None) -> state``: one batched SVGD step of
    ``dibs`` on the datasets ``xs [B, N, d]`` (``interv_masks`` alike, all
    observational by default), for states from :func:`fleet_init_state`.
    Raises ``ValueError`` for data of another shape than ``dibs.x``'s."""
    xs, interv_masks = _check(dibs, xs, interv_masks)
    std = dibs._resolve_latent_std(dibs.n_vars)
    if isinstance(dibs, JointDiBS):
        return dibs._make_step(std, transport_fn=dibs._make_fleet_transport(
            xs, interv_masks, std))
    return dibs._make_step(
        std, phi_fn=dibs._make_fleet_phi(xs, interv_masks, std))


def fleet_sample(dibs, *, xs, seed: int, n_particles: int, steps: int,
                 interv_masks=None, mesh=None, axis_name: str = "datasets",
                 return_states: bool = False):
    """Runs ``dibs``'s SVGD on ``B`` independent datasets as one batched
    step.

    Args:
        dibs: a constructed :class:`MarginalDiBS` or :class:`JointDiBS`;
            its models and hyperparameters serve every dataset, its own
            ``x`` only defines the common ``[N, d]`` shape.
        xs: ``[B, N, d]`` observation batches (the shape of ``dibs.x``).
        seed: int; :func:`fleet_seeds` turns it into one seed a dataset.
        interv_masks: optional ``[B, N, d]`` hard-intervention masks
            (all-observational by default, as the engine).
        mesh: optional ``torch.distributed.device_mesh.DeviceMesh`` with
            an axis ``axis_name``; the datasets are split over it (``B``
            a multiple of the axis's size), each rank running its block
            of datasets as one fleet, and the results gathered on every
            rank. Each dataset's result is that of the meshless fleet.
        return_states: also return the stacked final :class:`SVGDState`.

    Returns:
        ``gs [B, P, d, d]`` (int32) for marginal engines; ``(gs, thetas)``
        (parameter leaves with leading ``[B, P]``) for joint ones; the
        stacked state last with ``return_states=True``.
    """
    if getattr(dibs, "sharding", None) is not None:
        raise ValueError(
            "fleet_sample shards the dataset axis; construct the engine "
            "without a particle sharding (sharding=None)")
    seeds = fleet_seeds(seed, len(xs))
    shards = None
    if mesh is not None:
        shards = axis_sharding(mesh, axis_name)
        if len(xs) % shards.world != 0:
            raise ValueError(f"B={len(xs)} must divide the '{axis_name}' "
                             f"mesh axis ({shards.world})")
        per = len(xs) // shards.world
        rows = slice(shards.rank * per, (shards.rank + 1) * per)
        xs, seeds = xs[rows], seeds[rows]
        if interv_masks is not None:
            interv_masks = interv_masks[rows]
    step = fleet_step(dibs, xs, interv_masks)
    state = fleet_init_state(dibs, seeds, n_particles)
    for _ in range(steps):
        state = step(state)
    if shards is not None:
        state = gather_state(state, shards)._replace(
            seed=gather_rows(state.seed, shards))
    gs = particle_to_g_lim(state.z)
    out = (gs,) if state.theta is None else (gs, state.theta)
    if return_states:
        out = (*out, state)
    return out[0] if len(out) == 1 else out
