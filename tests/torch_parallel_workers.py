"""The rank side of ``tests/test_torch_parallel.py``: ``gloo`` worlds of
processes on the CPU, each rank running the port (this module imports torch
and the port only, so a rank never loads JAX).

:func:`run_world` spawns ``world`` ranks over a file store under the test's
``tmp_path`` (so that parallel test workers never share a port), runs one
check function on every rank and returns what each rank returned. A world
that does not finish within its timeout is killed and fails the test.
"""
from __future__ import annotations

import datetime
import os
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from dibs_tpu_torch import config
from dibs_tpu_torch.fleet import fleet_sample
from dibs_tpu_torch.inference import JointDiBS, MarginalDiBS
from dibs_tpu_torch.interop import (
    bge_from_reference,
    linear_gaussian_from_reference,
    nonlinear_gaussian_from_reference,
)
from dibs_tpu_torch.kernel import (
    AdditiveFrobeniusSEKernel,
    JointAdditiveFrobeniusSEKernel,
)
from dibs_tpu_torch.models import (
    ErdosReniDAGDistribution,
    ScaleFreeDAGDistribution,
)
from dibs_tpu_torch.parallel import (
    check_devices,
    gather_state,
    make_particle_mesh,
    particle_sharding,
    shard_state,
)
from dibs_tpu_torch.parallel.ring import (
    ring_joint_transport,
    ring_marginal_transport,
)
from dibs_tpu_torch.parallel.shard_ops import gather_rows, sharded_se_matrix
from dibs_tpu_torch.utils.tree import tree_leaves, tree_map

WORLD_TIMEOUT = 240  # seconds a world may take, start-up included


def _entry(rank, world, store, fn, args, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        result = fn(rank, world, *args)
        torch.save(result, os.path.join(out_dir, f"{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_world(fn, world, tmp_path, *args):
    """``[fn(rank, world, *args) for rank]``, each on its own rank of a
    ``gloo`` world of ``world`` processes."""
    out_dir = tmp_path / f"world{world}_{fn.__name__}"
    out_dir.mkdir()
    ctx = mp.spawn(_entry, args=(world, str(out_dir / "store"), fn, args,
                                 str(out_dir)),
                   nprocs=world, join=False)
    deadline = time.monotonic() + WORLD_TIMEOUT
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            raise TimeoutError(f"{fn.__name__}: a world of {world} ranks "
                               f"took more than {WORLD_TIMEOUT} s")
    return [torch.load(out_dir / f"{r}.pt", weights_only=False)
            for r in range(world)]


def _sharding():
    return particle_sharding(make_particle_mesh())


def _gather_tree(tree, sharding):
    return tree_map(lambda leaf: gather_rows(leaf, sharding), tree)


# --- the ring transport ------------------------------------------------------


class _Counter:
    """Counts the collectives the ring calls (monkeypatched over
    ``torch.distributed``): each ``batch_isend_irecv`` with its sends'
    shapes and dtypes, and the shapes of every all-gather and all-reduce."""

    def __init__(self):
        self.sends, self.gathers, self.reduces = [], [], []
        self._saved = {}

    def __enter__(self):
        for name, wrap in (("batch_isend_irecv", self._p2p),
                           ("all_gather", self._gather),
                           ("all_reduce", self._reduce)):
            self._saved[name] = getattr(dist, name)
            setattr(dist, name, wrap(self._saved[name]))
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(dist, name, fn)

    def _p2p(self, fn):
        def call(ops):
            self.sends.append([(tuple(op.tensor.shape), str(op.tensor.dtype))
                               for op in ops if op.op is dist.isend])
            return fn(ops)
        return call

    def _gather(self, fn):
        def call(parts, t, *a, **k):
            self.gathers.append(tuple(t.shape))
            return fn(parts, t, *a, **k)
        return call

    def _reduce(self, fn):
        def call(t, *a, **k):
            self.reduces.append(tuple(t.shape))
            return fn(t, *a, **k)
        return call


def ring_checks(rank, world, z, dz, theta, dtheta):
    """This rank's block of the global inputs through both rings (float32,
    then bfloat16, then float32 again), gathered; the collectives of each
    float32 ring; the SE matrix's row block against the gathered side."""
    sharding = _sharding()
    n = z.shape[0] // world
    rows = slice(rank * n, (rank + 1) * n)
    km = AdditiveFrobeniusSEKernel(h=5.0)
    kj = JointAdditiveFrobeniusSEKernel(h_latent=5.0, h_theta=500.0)

    def rings():
        m = ring_marginal_transport(km, z[rows], dz[rows], sharding)
        jz, jt = ring_joint_transport(kj, z[rows], theta[rows], dz[rows],
                                      dtheta[rows], sharding)
        return tuple(gather_rows(a, sharding) for a in (m, jz, jt))

    out = {}
    with _Counter() as marg:
        ring_marginal_transport(km, z[rows], dz[rows], sharding)
    with _Counter() as joint:
        ring_joint_transport(kj, z[rows], theta[rows], dz[rows],
                             dtheta[rows], sharding)
    out["counts"] = {"marginal": (marg.sends, marg.gathers, marg.reduces),
                     "joint": (joint.sends, joint.gathers, joint.reduces)}
    out["f32"] = rings()
    config.set_ring_payload_dtype("bfloat16")
    try:
        with _Counter() as bf:
            out["bf16"] = rings()
    finally:
        config.set_ring_payload_dtype("float32")
    out["bf16_sends"] = bf.sends
    out["f32_again"] = rings()
    flat = z.reshape(z.shape[0], -1)
    out["se_rows"] = sharded_se_matrix(flat[rows], flat[rows], 5.0, 1.0,
                                       sharding=sharding)
    return out


# --- the engines -------------------------------------------------------------


def _engine(spec, sharding):
    kind, model_kw, cfg = spec
    if kind == "marginal":
        d = model_kw["n_vars"]
        return MarginalDiBS(
            x=torch.from_numpy(model_kw["x"]),
            graph_model=ErdosReniDAGDistribution(d),
            likelihood_model=bge_from_reference(
                n_vars=d, mean_obs=model_kw["mean_obs"],
                alpha_mu=model_kw["alpha_mu"],
                alpha_lambd=model_kw["alpha_lambd"], device="cpu"),
            sharding=sharding, device="cpu", **cfg)
    d = model_kw["n_vars"]
    lik = {k: v for k, v in model_kw.items() if k != "x"}
    model = (linear_gaussian_from_reference(**lik) if kind == "linear"
             else nonlinear_gaussian_from_reference(**lik))
    return JointDiBS(x=torch.from_numpy(model_kw["x"]),
                     graph_model=ScaleFreeDAGDistribution(d),
                     likelihood_model=model, sharding=sharding, device="cpu",
                     **cfg)


def engine_checks(rank, world, cases):
    """For each case ``(spec, std, tf_states, tf_noise, free)``: the
    sharded engine's teacher-forced transports from the whole states
    (gathered), then its free run ``sample(**free)`` (gathered graphs and
    final state) and, for the first state, its shard's layout."""
    sharding = _sharding()
    out = {}
    for name, (spec, std, states, noises, free) in cases.items():
        dibs = _engine(spec, sharding)
        phi_fn = dibs._make_phi(std)
        phis = []
        for state, noise in zip(states, noises):
            with torch.no_grad():
                phi = phi_fn(shard_state(state, sharding), noise)
            phis.append(gather_rows(phi[0], sharding) if spec[0] == "marginal"
                        else (gather_rows(phi[0], sharding),
                              _gather_tree(phi[1], sharding)))
        run = dibs.sample(**free, return_state=True)
        out[name] = dict(phi=phis, g=run[0], state=run[-1])
        if states:
            local = shard_state(states[0], sharding)
            back = gather_state(local, sharding)
            out[name].update(local_z=tuple(local.z.shape), round_trip=bool(
                torch.equal(back.z, states[0].z)))
    return out


# --- the fleet, shard_state, the refusals -----------------------------------


def fleet_checks(rank, world, spec, xs, free, odd_xs):
    """``fleet_sample(mesh=)`` over the ``datasets`` axis, and its
    refusals."""
    from torch.distributed.device_mesh import DeviceMesh

    mesh = DeviceMesh("cpu", list(range(world)),
                      mesh_dim_names=("datasets",))
    dibs = _engine(spec, None)
    gs, state = fleet_sample(dibs, xs=xs, mesh=mesh, return_states=True,
                             **free)
    errors = []
    try:
        fleet_sample(dibs, xs=odd_xs, mesh=mesh, **free)
    except ValueError as err:
        errors.append(str(err))
    try:
        fleet_sample(_engine(spec, _sharding()), xs=xs, mesh=mesh, **free)
    except ValueError as err:
        errors.append(str(err))
    return dict(gs=gs, state=state, errors=errors)


def layout_and_refusal_checks(rank, world, state):
    """``shard_state`` and ``gather_state`` in a world, and the NCCL
    device check's refusals (the backend read as ``nccl``)."""
    sharding = _sharding()
    local = shard_state(state, sharding)
    back = gather_state(local, sharding)
    same = all(torch.equal(a, b) for a, b in
               zip(_tensors(back), _tensors(state)))
    errors = []
    saved = dist.get_backend
    dist.get_backend = lambda group=None: "nccl"
    try:
        for device in ("cuda:0", "cpu"):
            try:
                check_devices(sharding, torch.device(device))
            except ValueError as err:
                errors.append(str(err))
    finally:
        dist.get_backend = saved
    return dict(local=[tuple(t.shape) for t in _tensors(local)],
                same=same, errors=errors)


def _tensors(tree):
    """The tensors of a state tree, depth first."""
    return [leaf for leaf in tree_leaves(tree)
            if isinstance(leaf, torch.Tensor)]


# --- the ("p", "mc") mesh ----------------------------------------------------


def _mc_sharding(n_mc):
    return particle_sharding(make_particle_mesh(n_mc=n_mc))


def _estimator_outputs(est, state, stream, noise):
    """Every estimator of ``est`` on ``state`` (this rank's particles):
    the Z likelihood gradient and baseline, the Theta likelihood gradient
    and the fused pair where the engine has them, the latent prior."""
    eps_z, eps_theta, eps_prior = noise
    out = {}
    with torch.no_grad():
        out["z"] = est.eltwise_grad_z_likelihood(
            state.z, state.theta, state.sf_baseline, state.t, state.seed,
            stream, eps=eps_z)
        if est.eltwise_grad_theta_likelihood is not None:
            out["theta"] = est.eltwise_grad_theta_likelihood(
                state.z, state.theta, state.t, state.seed, stream + 1,
                eps=eps_theta)
        if est.fused_grad_both is not None:
            out["both"] = est.fused_grad_both(
                state.z, state.theta, state.t, state.seed,
                (stream, stream), eps=(eps_z, eps_theta))
        out["prior"] = est.eltwise_grad_latent_prior(
            state.z, state.t, state.seed, stream + 2, 0.4, eps=eps_prior)
    return out


def _rows_of(tree, rows):
    return tree_map(lambda leaf: leaf[rows] if isinstance(leaf, torch.Tensor)
                    and leaf.dim() >= 1 else leaf, tree)


def mc_checks(rank, world, n_mc, est_cases, engine_cases, odd_case):
    """The ``("p", "mc")`` mesh of ``world // n_mc`` x ``n_mc`` ranks:

    * ``est_cases``: ``name -> (spec, state, stream, noise)``; this rank's
      estimator outputs on its ``"p"`` block of the whole ``state`` (the
      global noise, whose rows and samples the estimators take);
    * ``engine_cases``: as :func:`engine_checks` (teacher-forced
      transports gathered over ``"p"``, a free run's graphs and whole
      state), plus the shapes of every sampler call of one step;
    * ``odd_case``: ``(spec, free)``, a run whose ``M`` the ``"mc"`` axis
      does not divide;
    * the refusal of an ``n_mc`` that does not divide the world.
    """
    from dibs_tpu_torch.ops import soft_graphs

    sharding = _mc_sharding(n_mc)
    out = dict(p_rank=sharding.rank, p_size=sharding.world,
               mc_rank=sharding.mc_rank, mc_size=sharding.mc_size,
               mesh=tuple(sharding.mesh.mesh.shape),
               names=tuple(sharding.mesh.mesh_dim_names))
    for name, (spec, state, stream, noise) in est_cases.items():
        dibs = _engine(spec, sharding)
        n = state.z.shape[0] // sharding.world
        rows = slice(sharding.rank * n, (sharding.rank + 1) * n)
        local = shard_state(state, sharding)._replace(
            sf_baseline=state.sf_baseline[rows])
        out[("est", name)] = _estimator_outputs(
            dibs.est, local, stream, _rows_of(noise, rows))
    shapes = []
    saved = soft_graphs.gumbel_graphs

    def recording(scores, *args, **kwargs):
        got = saved(scores, *args, **kwargs)
        shapes.append(tuple(got.shape))
        return got

    for name, (spec, std, states, noises, free) in engine_cases.items():
        dibs = _engine(spec, sharding)
        phi_fn = dibs._make_phi(std)
        phis = []
        for i, (state, noise) in enumerate(zip(states, noises)):
            soft_graphs.gumbel_graphs = recording if i == 0 else saved
            try:
                with torch.no_grad():
                    phi = phi_fn(dibs._local_state(state), noise)
            finally:
                soft_graphs.gumbel_graphs = saved
            phis.append(_gather_phi(spec, phi, state.z.shape[0], sharding))
        run = dibs.sample(**free, return_state=True)
        out[("engine", name)] = dict(phi=phis, g=run[0], state=run[-1],
                                     shapes=list(shapes))
        shapes.clear()
    spec, free = odd_case
    run = _engine(spec, sharding).sample(**free, return_state=True)
    out["odd"] = dict(g=run[0], state=run[-1])
    try:
        make_particle_mesh(n_mc=3)
    except ValueError as err:
        out["refusal"] = str(err)
    return out


def _gather_phi(spec, phi, n_particles, sharding):
    """A step's transports, gathered over ``"p"`` where the step ran on a
    shard of the ``n_particles``."""
    def whole(a):
        return gather_rows(a, sharding) if a.shape[0] < n_particles else a

    if spec[0] == "marginal":
        return whole(phi[0])
    return whole(phi[0]), tree_map(whole, phi[1])


# --- the engine's spans ------------------------------------------------------


def span_checks(rank, world):
    """Two traced steps of a marginal (BGe) and a joint (linear, d > 70)
    engine whose particles split over the world: each rank's span log as
    ``[name, thread, start_ns, end_ns]`` rows."""
    import numpy as np

    from dibs_tpu_torch import profiling
    from dibs_tpu_torch.models import BGe, LinearGaussian

    sharding = _sharding()
    out = {}
    for kind, d in (("marginal", 40), ("joint_linear", 72)):
        x = torch.from_numpy(np.random.default_rng(0).normal(
            size=(20, d)).astype(np.float32))
        common = dict(x=x, graph_model=ScaleFreeDAGDistribution(d),
                      n_grad_mc_samples=4, n_acyclicity_mc_samples=2,
                      sharding=sharding, device="cpu")
        dibs = (MarginalDiBS(likelihood_model=BGe(n_vars=d, device="cpu"),
                             **common) if kind == "marginal" else
                JointDiBS(likelihood_model=LinearGaussian(n_vars=d),
                          **common))
        state = dibs.init_state(seed=3, n_particles=4)
        assert state.z.shape[0] == 4 // world  # this rank's shard
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            dibs.resume(state, steps=2)
        out[kind] = [list(s) for s in profiling.spans()]
    return out
