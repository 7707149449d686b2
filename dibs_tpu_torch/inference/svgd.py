"""SVGD engine with the marginal and joint inference classes (PyTorch twin
of ``dibs_tpu/inference/svgd.py``).

All mutable quantities live in an :class:`SVGDState`; one SVGD step is a
``state -> state`` function built once per run and driven by a plain eager
loop. The state carries an integer ``seed`` instead of a JAX key; each step
draws its noise inside the kernels from counter-based streams of that seed:

* ``MarginalDiBS``, step ``t``: hard MC graphs from stream ``2 t``, soft
  acyclicity samples from ``2 t + 1``; ``step(state, noise)`` can instead
  take the Logistic pair ``(eps_hard [P, M, d, d], eps_soft [P, K, d, d])``.
* ``JointDiBS``, step ``t``: the Z estimator's samples from stream
  ``3 t`` (soft for ``reparam``, hard for ``score``), hard Theta samples
  from ``3 t + 1`` (from ``3 t`` where ``fused_sample_sharing='hard'``
  serves the reparameterization estimator: the thresholds of the soft
  samples' noise), acyclicity samples from ``3 t + 2``; ``step(state,
  noise)`` can take ``(eps_soft [P, M, d, d], eps_hard [P, M, d, d],
  eps_acyc [P, K, d, d])``, ``eps_soft`` the Z estimator's noise.

A fleet (:mod:`dibs_tpu_torch.fleet`) steps ``B_ds`` datasets of one
engine at once: ``MarginalDiBS._make_fleet_phi`` with ``_make_step(...,
phi_fn=)``, ``JointDiBS._make_fleet_transport`` with ``_make_step(...,
transport_fn=)``, take a state whose tensors (and parameter leaves) lead
with ``[B_ds, P]`` and whose ``seed`` is the ``[B_ds]`` int64 keys, with
the same streams a step and the noise above with a leading ``[B_ds]``.

With ``sharding=`` (:func:`dibs_tpu_torch.parallel.particle_sharding`) each
rank of a ``torch.distributed`` world runs the engine on its block of the
particles: every rank draws the global initial particles from the same
generator and keeps its block, the estimators draw at the block's global
particle indices (bitwise the unsharded step's per-particle quantities),
and the transport runs around the ring (:mod:`dibs_tpu_torch.parallel.
ring`) or, for kernels the ring does not serve, by the all-gather route;
``sample`` and ``resume`` return the gathered global result on every rank.
An injected ``noise`` is the global tensor; each rank takes its rows. A
run whose particle count the world does not divide is replicated (every
rank runs the whole unsharded step, kernel #4 off, as in the reference),
and a one-rank world runs the unsharded step. On a ``("p", "mc")`` mesh
the particles split over ``"p"`` only (the transport, the ring and
``shard_offset`` take the ``"p"`` group, rank and size) and the
estimators split their samples over ``"mc"``: every ``"mc"`` rank of a
``"p"`` block ends each step with the same state, bitwise.

While a ``torch.profiler`` records, a step marks its layers with the spans
of :mod:`dibs_tpu_torch.profiling` (``dibs.step``; ``dibs.likelihood``, the
latent prior's ``dibs.prior``, ``dibs.transport`` and ``dibs.update``
inside it); otherwise the spans do nothing.

Every class runs on the card unless ``device="cpu"`` is passed (and raises
where CUDA is absent). ``theta`` is the likelihood's parameter tree
(:mod:`dibs_tpu_torch.utils.tree`): ``[P, d, d]`` for ``LinearGaussian``,
``[(W1, b1), (W2, b2), ...]`` for ``DenseNonlinearGaussian``.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from dibs_tpu_torch.config import DEFAULT_DEVICE, resolve_device
from dibs_tpu_torch.inference.estimators import EstimatorConfig, make_estimators
from dibs_tpu_torch.inference.optimizers import get_optimizer
from dibs_tpu_torch.inference.transport import (
    fleet_joint_transport,
    fleet_marginal_transport,
    gathered_joint_transport,
    gathered_marginal_transport,
    joint_transport,
    marginal_transport,
)
from dibs_tpu_torch.kernel import (
    AdditiveFrobeniusSEKernel,
    JointAdditiveFrobeniusSEKernel,
)
from dibs_tpu_torch.metrics import ParticleDistribution
from dibs_tpu_torch.models.linear_gaussian import LinearGaussian
from dibs_tpu_torch.models.nonlinear_gaussian import DenseNonlinearGaussian
from dibs_tpu_torch.ops import edges as edge_ops
from dibs_tpu_torch.parallel import (
    check_devices,
    gather_state,
    shard_state,
)
from dibs_tpu_torch.parallel.ring import (
    ring_available,
    ring_joint_transport,
    ring_marginal_transport,
)
from dibs_tpu_torch.parallel.shard_ops import (
    divides_mesh,
    gather_rows,
    shard_offset,
)
from dibs_tpu_torch.profiling import span
from dibs_tpu_torch.utils.tree import tree_map

__all__ = ["SVGDState", "DiBS", "MarginalDiBS", "JointDiBS"]


class SVGDState(NamedTuple):
    """Complete carry of an SVGD run (``theta`` / ``opt_state_theta`` are
    ``None`` for marginal inference)."""

    t: int  # step counter
    seed: Any  # key of the noise streams: an int (a fleet: [B_ds] int64)
    z: torch.Tensor  # [n_particles, d, k, 2]
    theta: Any
    opt_state_z: Any
    opt_state_theta: Any
    # [n_particles], whole on every rank of a sharded run (rank-1 leaves
    # are replicated), so z holding fewer particles marks a shard
    sf_baseline: torch.Tensor


def _check_precision():
    """Every path held to the float32 reference runs with TF32 off."""
    if (torch.get_float32_matmul_precision() != "highest"
            or torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError(
            "TF32 matmuls are enabled; the port is held to full float32 "
            "(torch.set_float32_matmul_precision('highest'))")


class DiBS:
    """Shared backbone: config, data, latent->graph maps."""

    def __init__(self, *, x, interv_mask, log_graph_prior, alpha_linear,
                 batched_node_log_joint_prob=None, log_joint_prob=None,
                 fused_linear_model=None, fused_nonlinear_model=None,
                 fused_sample_sharing=None,
                 fused_single_pass=True, beta_linear=1.0, tau=1.0,
                 n_grad_mc_samples=128, n_acyclicity_mc_samples=32,
                 grad_estimator_z="reparam",
                 score_function_baseline=0.0, latent_prior_std=None,
                 acyclicity="notears", acyclicity_constraint="sampled",
                 verbose=False, sharding=None, device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.sharding = sharding
        if sharding is not None:
            check_devices(sharding, self.device)
        self.x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        self.interv_mask = torch.as_tensor(interv_mask).to(self.device)
        self.n_vars = self.x.shape[-1]
        self.log_graph_prior = log_graph_prior
        self.batched_node_log_joint_prob = batched_node_log_joint_prob
        self.log_joint_prob = log_joint_prob
        self.cfg = EstimatorConfig(
            alpha_linear=alpha_linear, beta_linear=beta_linear, tau=tau,
            n_grad_mc_samples=n_grad_mc_samples,
            n_acyclicity_mc_samples=n_acyclicity_mc_samples,
            grad_estimator_z=grad_estimator_z,
            score_function_baseline=score_function_baseline,
            latent_prior_std=latent_prior_std, acyclicity=acyclicity,
            acyclicity_constraint=acyclicity_constraint)
        self.latent_prior_std = latent_prior_std
        self.verbose = verbose
        # the models and options the estimators are built from (again, on
        # a fleet's datasets, by _make_fleet_estimators)
        self._est_kwargs = dict(
            log_graph_prior=log_graph_prior,
            batched_node_log_joint_prob=batched_node_log_joint_prob,
            log_joint_prob=log_joint_prob,
            fused_linear_model=fused_linear_model,
            fused_nonlinear_model=fused_nonlinear_model,
            fused_sample_sharing=fused_sample_sharing,
            fused_single_pass=fused_single_pass)
        self.est = make_estimators(cfg=self.cfg, x=self.x,
                                   interv_mask=self.interv_mask,
                                   sharding=sharding, **self._est_kwargs)
        self._est_whole = None if sharding is not None else self.est

    def alpha(self, t):
        return self.cfg.alpha(t)

    def beta(self, t):
        return self.cfg.beta(t)

    def particle_to_g_lim(self, z):
        return edge_ops.particle_to_g_lim(z)

    def edge_probs(self, z, t):
        return edge_ops.edge_probs(z, self.cfg.alpha(t))

    def edge_log_probs(self, z, t):
        return edge_ops.edge_log_probs(z, self.cfg.alpha(t))

    def particle_to_soft_graph(self, z, eps, t):
        return edge_ops.particle_to_soft_graph(z, eps, self.cfg.alpha(t),
                                               self.cfg.tau)

    def particle_to_hard_graph(self, z, eps, t):
        return edge_ops.particle_to_hard_graph(z, eps, self.cfg.alpha(t))

    def sample_g(self, p, generator, n_samples):
        """``n_samples`` Bernoulli graphs from edge probabilities ``p``;
        a ``torch.Generator`` takes the place of the reference's key."""
        return edge_ops.sample_g(p, generator, n_samples)

    def latent_log_prob(self, single_g, single_z, t):
        """``log p(G | Z)`` of one graph sample."""
        return edge_ops.latent_log_prob(single_g, single_z, self.cfg.alpha(t))

    def eltwise_grad_latent_log_prob(self, gs, single_z, t):
        """``grad_Z log p(G | Z)`` over graph samples ``[M, d, d]`` ->
        ``[M, d, k, 2]``, in closed form."""
        return edge_ops.grad_latent_log_prob_batch(gs, single_z,
                                                   self.cfg.alpha(t))

    def eltwise_log_joint_prob(self, gs, single_theta, rng=None):
        """``log p(Theta, D | G)`` of graph samples ``[M, d, d]`` with one
        particle's parameters -> ``[M]``."""
        return self.log_joint_prob(gs, single_theta, self.x,
                                   self.interv_mask, rng)

    def log_joint_prob_soft(self, single_z, single_theta, eps, t, rng=None):
        """``log p(Theta, D | G_soft(Z, eps))``: the Gumbel-softmax
        composition the reparameterization estimator differentiates."""
        soft_g = self.particle_to_soft_graph(single_z, eps, t)
        return self.log_joint_prob(soft_g, single_theta, self.x,
                                   self.interv_mask, rng)

    def visualize_callback(self, ipython=True, save_path=None):
        """Callback printing iteration stats and plotting the particles'
        edge probabilities every ``callback_every`` steps (matplotlib, and
        IPython with ``ipython=True``, are imported here)."""
        from dibs_tpu_torch.ops.acyclic import elwise_acyclic_constr
        from dibs_tpu_torch.utils.visualize import visualize

        if ipython:
            from IPython import display

        def callback(**kwargs):
            zs, t = kwargs["zs"], kwargs["t"]
            gs = self.particle_to_g_lim(zs)
            probs = self.edge_probs(zs, t)
            if ipython:
                display.clear_output(wait=True)
            visualize(probs, save_path=save_path, t=t, show=True)
            n_cyclic = int((elwise_acyclic_constr(
                gs.to(torch.float32), self.n_vars) > 0).sum())
            print(f"iteration {t:6d} | alpha {float(self.alpha(t)):6.1f} | "
                  f"beta {float(self.beta(t)):6.1f} | #cyclic {n_cyclic:3d}")

        return callback

    def _make_fleet_estimators(self, xs, interv_masks):
        """The estimators on a fleet's datasets ``xs [B_ds, N, d]`` (masks
        alike): the dataset axis through the data-dependent parts."""
        return make_estimators(cfg=self.cfg, x=xs, interv_mask=interv_masks,
                               **self._est_kwargs)

    # --- particle sharding ---

    def _attach_kernel_sharding(self):
        """The kernel learns of a sharding that splits particles (a world
        of more than one rank): kernel #4 is then off, as in the
        reference."""
        if (self.sharding is not None and self.sharding.world > 1
                and hasattr(self.kernel, "sharding")):
            self.kernel.sharding = self.sharding

    def _shards(self, n_particles: int) -> bool:
        """True where a run of ``n_particles`` splits over the mesh: more
        than one rank, and the world divides the particles."""
        s = self.sharding
        return s is not None and s.world > 1 and divides_mesh(s, n_particles)

    def _is_shard(self, state) -> bool:
        return (self.sharding is not None
                and state.z.shape[0] < state.sf_baseline.shape[0])

    def _view(self, state):
        """``(estimators, rows, sharded)`` of a step on ``state``: a
        shard's estimators (global particle indices) and its rows of the
        whole batch's tensors, or the unsharded estimators and every
        row."""
        if self._is_shard(state):
            n = state.z.shape[0]
            offset = shard_offset(self.sharding, n)
            return self.est, slice(offset, offset + n), True
        if self._est_whole is None:
            # every particle on this rank: the samples still split over a
            # ("p", "mc") mesh's "mc" axis, at particle offset 0
            whole = (self.sharding._replace(rank=0, world=1)
                     if self.sharding.mc_size > 1 else None)
            self._est_whole = make_estimators(
                cfg=self.cfg, x=self.x, interv_mask=self.interv_mask,
                sharding=whole, **self._est_kwargs)
        return self._est_whole, slice(None), False

    def _baselines(self, state, new, sharded):
        """The step's new ``sf_baseline``, whole on every rank (a shard's
        new rows gathered where the EMA baseline moves them)."""
        if sharded and self.cfg.score_function_baseline > 0.0:
            return gather_rows(new, self.sharding)
        return state.sf_baseline if sharded else new

    def _local_state(self, state):
        """This rank's shard of a whole ``state`` where the run splits its
        particles, else ``state``."""
        if self._shards(state.z.shape[0]) and not self._is_shard(state):
            return shard_state(state, self.sharding)
        return state

    def _whole_state(self, state):
        """The whole (gathered) state of a shard, else ``state``."""
        if self._is_shard(state):
            return gather_state(state, self.sharding)
        return state

    def _resolve_latent_std(self, n_dim):
        return self.latent_prior_std or (1.0 / math.sqrt(n_dim))

    def _init_sf_baseline(self, n_particles):
        """``-inf`` (= off) in the log-space EMA when the control variate is
        enabled, zeros otherwise."""
        if self.cfg.score_function_baseline > 0.0:
            return torch.full((n_particles,), -math.inf, device=self.device)
        return torch.zeros(n_particles, device=self.device)

    def _init_z(self, gen, n_particles, n_dim):
        std = self._resolve_latent_std(n_dim)
        return torch.randn((n_particles, self.n_vars, n_dim, 2),
                           generator=gen).to(self.device) * std

    def _run(self, state: SVGDState, steps: int, callback,
             callback_every: Optional[int], step_fn) -> SVGDState:
        callback_every = callback_every or steps
        for i in range(steps):
            state = step_fn(state)
            if callback and ((i + 1) % callback_every == 0 or i + 1 == steps):
                whole = self._whole_state(state)
                kwargs = dict(dibs=self, t=int(state.t), zs=whole.z)
                if state.theta is not None:
                    kwargs["thetas"] = whole.theta
                callback(**kwargs)
        return state


class MarginalDiBS(DiBS):
    """SVGD inference of the marginal DAG posterior ``p(G | D)``.

    Defaults as the reference: SE kernel with ``h=5``, rmsprop(0.005),
    ``alpha_linear=1``, the score-function estimator. ``device`` places the
    data, the particles and every kernel launch.
    """

    def __init__(self, *, x, graph_model, likelihood_model, interv_mask=None,
                 kernel=AdditiveFrobeniusSEKernel, kernel_param=None,
                 optimizer="rmsprop", optimizer_param=None, alpha_linear=1.0,
                 beta_linear=1.0, tau=1.0, n_grad_mc_samples=128,
                 n_acyclicity_mc_samples=32, grad_estimator_z="score",
                 score_function_baseline=0.0, latent_prior_std=None,
                 acyclicity="notears", acyclicity_constraint="sampled",
                 sharding=None, verbose=False, device=DEFAULT_DEVICE):
        if kernel_param is None:
            kernel_param = {"h": 5.0}
        if optimizer_param is None:
            optimizer_param = {"stepsize": 0.005}
        if interv_mask is None:
            interv_mask = torch.zeros(tuple(x.shape), dtype=torch.int32)
        batched = getattr(likelihood_model,
                          "batched_interventional_node_log_marginal_probs",
                          None)
        if batched is None:
            raise ValueError("the likelihood model needs the batched per-node "
                             "hook batched_interventional_node_log_marginal_"
                             "probs (e.g. BGe)")
        super().__init__(
            x=x, interv_mask=interv_mask,
            log_graph_prior=graph_model.unnormalized_log_prob_soft,
            batched_node_log_joint_prob=batched, alpha_linear=alpha_linear,
            beta_linear=beta_linear, tau=tau,
            n_grad_mc_samples=n_grad_mc_samples,
            n_acyclicity_mc_samples=n_acyclicity_mc_samples,
            grad_estimator_z=grad_estimator_z,
            score_function_baseline=score_function_baseline,
            latent_prior_std=latent_prior_std, acyclicity=acyclicity,
            acyclicity_constraint=acyclicity_constraint, verbose=verbose,
            sharding=sharding, device=device)
        self.likelihood_model = likelihood_model
        self.graph_model = graph_model
        # the per-graph marginal likelihood, as the reference's log_joint_prob
        # (the estimators keep the batched hook)
        self.log_joint_prob = getattr(likelihood_model,
                                      "interventional_log_marginal_prob", None)
        self.kernel = kernel(**kernel_param) if isinstance(kernel, type) else kernel
        self._attach_kernel_sharding()
        self.opt = (get_optimizer(optimizer, optimizer_param)
                    if isinstance(optimizer, str) else optimizer)

    def _log_marginal(self, gs, x, interv_mask):
        """``[n]`` marginal log-likelihoods of graphs ``[n, d, d]`` through
        the batched per-node hook (node scores summed in float64)."""
        return self.batched_node_log_joint_prob(
            gs.to(torch.float32), None, x, interv_mask,
            None).double().sum(-1).float()

    def eltwise_log_joint_prob(self, gs, single_theta=None, rng=None):
        """``log p(D | G)`` of graph samples ``[M, d, d]`` -> ``[M]``."""
        return self._log_marginal(gs, self.x, self.interv_mask)

    def eltwise_log_marginal_likelihood_observ(self, gs, x_ho):
        """Held-out marginal log-likelihoods ``[n]`` of observational data
        (the hook of ``metrics.neg_ave_log_marginal_likelihood``)."""
        return self._log_marginal(gs, x_ho, torch.zeros_like(x_ho))

    def eltwise_log_marginal_likelihood_interv(self, gs, x_ho, interv_msk_ho):
        """Held-out marginal log-likelihoods ``[n]`` of interventional
        data."""
        return self._log_marginal(gs, x_ho, interv_msk_ho)

    # --- functional engine ---

    def init_state(self, *, seed: int, n_particles: int,
                   n_dim_particles=None) -> SVGDState:
        """Initial particles ``z ~ N(0, sigma_z^2)`` from a ``torch.Generator``
        seeded with ``seed``, plus the optimizer state (under a sharding
        that splits the particles, this rank's shard of it)."""
        gen = torch.Generator().manual_seed(seed)
        z = self._init_z(gen, n_particles, n_dim_particles or self.n_vars)
        return self._local_state(SVGDState(
            t=0, seed=seed, z=z, theta=None, opt_state_z=self.opt.init(z),
            opt_state_theta=None,
            sf_baseline=self._init_sf_baseline(n_particles)))

    def _make_phi(self, latent_prior_std) -> Callable:
        """``phi(state, noise=None) -> (phi_z, sf_baseline)``: the transport
        of one step, before the optimizer."""
        kernel = self.kernel

        def phi(state: SVGDState, noise=None):
            est, rows, sharded = self._view(state)
            eps_hard, eps_soft = (None, None) if noise is None else (
                e[rows] for e in noise)
            stream = 2 * state.t
            with span("dibs.likelihood"):
                dz_lik, sf_baseline = est.eltwise_grad_z_likelihood(
                    state.z, None, state.sf_baseline[rows], state.t,
                    state.seed, stream, eps=eps_hard)
            dz_prior = est.eltwise_grad_latent_prior(
                state.z, state.t, state.seed, stream + 1, latent_prior_std,
                eps=eps_soft)
            dz = dz_prior + dz_lik
            with span("dibs.transport"):
                if not sharded:
                    phi_z = marginal_transport(kernel, state.z, dz)
                elif ring_available(kernel, self.sharding):
                    phi_z = ring_marginal_transport(kernel, state.z, dz,
                                                    self.sharding)
                else:
                    phi_z = gathered_marginal_transport(kernel, state.z, dz,
                                                        self.sharding)
            return phi_z, self._baselines(state, sf_baseline, sharded)

        return phi

    def _make_fleet_phi(self, xs, interv_masks, latent_prior_std) -> Callable:
        """``phi(state, noise=None) -> (phi_z, sf_baseline)`` of a fleet on
        the datasets ``xs [B_ds, N, d]`` (masks alike): one batched step,
        each kernel launched as often as in one dataset's step. ``state.z``
        is ``[B_ds, P, d, k, 2]``, ``state.sf_baseline`` ``[B_ds, P]`` and
        ``state.seed`` the ``[B_ds]`` int64 keys on the device; dataset
        ``i``'s ``phi`` is that of a single run on ``xs[i]`` keyed
        ``seed[i]``."""
        est = self._make_fleet_estimators(xs, interv_masks)
        kernel = self.kernel

        def phi(state: SVGDState, noise=None):
            n_ds, p = state.z.shape[:2]
            z = state.z.reshape(n_ds * p, *state.z.shape[2:])
            eps_hard, eps_soft = (None, None) if noise is None else (
                e.reshape(n_ds * p, *e.shape[2:]) for e in noise)
            stream = 2 * state.t
            with span("dibs.likelihood"):
                dz_lik, sf_baseline = est.eltwise_grad_z_likelihood(
                    z, None, state.sf_baseline.reshape(n_ds * p), state.t,
                    state.seed, stream, eps=eps_hard)
            dz_prior = est.eltwise_grad_latent_prior(
                z, state.t, state.seed, stream + 1, latent_prior_std,
                eps=eps_soft)
            dz = (dz_prior + dz_lik).reshape(state.z.shape)
            with span("dibs.transport"):
                phi_z = fleet_marginal_transport(kernel, state.z, dz)
            return phi_z, sf_baseline.reshape(n_ds, p)

        return phi

    def _make_step(self, latent_prior_std, phi_fn=None) -> Callable:
        """``step(state, noise=None) -> state`` (a fleet's with its
        ``phi_fn`` from :meth:`_make_fleet_phi`)."""
        phi_fn = phi_fn or self._make_phi(latent_prior_std)
        opt = self.opt

        def step(state: SVGDState, noise=None) -> SVGDState:
            with span("dibs.step"), torch.no_grad():
                _check_precision()
                phi_z, sf_baseline = phi_fn(state, noise)
                with span("dibs.update"):
                    updates, opt_state_z = opt.update(phi_z,
                                                      state.opt_state_z)
                    z = state.z + updates
                return SVGDState(t=state.t + 1, seed=state.seed, z=z,
                                 theta=None, opt_state_z=opt_state_z,
                                 opt_state_theta=None,
                                 sf_baseline=sf_baseline)

        return step

    def sample(self, *, seed: int, n_particles: int, steps: int,
               n_dim_particles=None, callback=None, callback_every=None,
               return_state=False):
        """Runs SVGD and returns hard graphs ``[n_particles, d, d]`` (int32),
        plus the final :class:`SVGDState` with ``return_state=True`` (both
        whole on every rank of a sharded run)."""
        state = self.init_state(seed=seed, n_particles=n_particles,
                                n_dim_particles=n_dim_particles)
        return self.resume(state, steps=steps, callback=callback,
                           callback_every=callback_every,
                           return_state=return_state)

    def resume(self, state: SVGDState, *, steps, callback=None,
               callback_every=None, return_state=False):
        """Continues a run from ``state`` (whole, or this rank's shard) for
        ``steps`` more steps."""
        step_fn = self._make_step(self._resolve_latent_std(state.z.shape[2]))
        state = self._run(self._local_state(state), steps, callback,
                          callback_every, step_fn)
        state = self._whole_state(state)
        g_final = self.particle_to_g_lim(state.z)
        if return_state:
            return g_final, state
        return g_final

    # --- posterior wrappers ---

    def get_empirical(self, g) -> ParticleDistribution:
        """Empirical distribution: deduplicated graphs weighted by counts."""
        n_particles = g.shape[0]
        unique, counts = torch.unique(g, dim=0, return_counts=True)
        logp = torch.log(counts.to(torch.float32)) - math.log(n_particles)
        return ParticleDistribution(logp=logp, g=unique)

    def get_mixture(self, g) -> ParticleDistribution:
        """DiBS+ mixture: weights proportional to the marginal posterior."""
        logp = self._log_marginal(g, self.x, self.interv_mask)
        logp = logp - torch.logsumexp(logp, dim=0)
        return ParticleDistribution(logp=logp, g=g)


class JointDiBS(DiBS):
    """SVGD inference of the joint posterior ``p(G, Theta | D)``.

    Constructor surface and defaults as the reference: joint SE kernel with
    ``h_latent=5, h_theta=500``, rmsprop(0.005), ``alpha_linear=0.05``, the
    Gumbel reparameterization estimator, ``fused_sample_sharing='hard'``
    (one noise batch per step serves both likelihood gradients; ``None``
    keeps separate streams). ``grad_estimator_z='score'`` takes the
    REINFORCE estimator (with the signed EMA baseline where
    ``score_function_baseline > 0``): each particle's hard samples, drawn
    by the sampler kernel, scored by ``log_joint_prob`` with its own
    parameters; the Theta gradient then takes its own hard samples, and
    the fused kernels and the shared noise serve ``reparam`` only, as in
    the reference. ``'score_rb'`` raises ``ValueError``: the joint
    likelihood has no per-node decomposition. For ``LinearGaussian`` both
    likelihood gradients come from the fused kernels
    (:mod:`dibs_tpu_torch.inference.fused_linear`): the one-pass kernel, or
    with ``fused_single_pass=False`` the two-pass pair. For a
    one-hidden-layer ``DenseNonlinearGaussian`` they come from kernel #8
    (:mod:`dibs_tpu_torch.inference.fused_nonlinear`); other MLPs take the
    generic estimators. ``device`` places the data, the particles and every
    kernel launch.
    """

    def __init__(self, *, x, graph_model, likelihood_model, interv_mask=None,
                 kernel=JointAdditiveFrobeniusSEKernel, kernel_param=None,
                 optimizer="rmsprop", optimizer_param=None, alpha_linear=0.05,
                 beta_linear=1.0, tau=1.0, n_grad_mc_samples=128,
                 n_acyclicity_mc_samples=32, grad_estimator_z="reparam",
                 score_function_baseline=0.0, latent_prior_std=None,
                 acyclicity="notears", acyclicity_constraint="sampled",
                 sharding=None, verbose=False, fused_sample_sharing="hard",
                 fused_single_pass=True, device=DEFAULT_DEVICE):
        if kernel_param is None:
            kernel_param = {"h_latent": 5.0, "h_theta": 500.0}
        if optimizer_param is None:
            optimizer_param = {"stepsize": 0.005}
        if interv_mask is None:
            interv_mask = torch.zeros(tuple(x.shape), dtype=torch.int32)
        super().__init__(
            x=x, interv_mask=interv_mask,
            log_graph_prior=graph_model.unnormalized_log_prob_soft,
            log_joint_prob=likelihood_model.interventional_log_joint_prob,
            fused_linear_model=(likelihood_model if isinstance(
                likelihood_model, LinearGaussian) else None),
            fused_nonlinear_model=(likelihood_model if isinstance(
                likelihood_model, DenseNonlinearGaussian) else None),
            fused_sample_sharing=fused_sample_sharing,
            fused_single_pass=fused_single_pass,
            alpha_linear=alpha_linear, beta_linear=beta_linear, tau=tau,
            n_grad_mc_samples=n_grad_mc_samples,
            n_acyclicity_mc_samples=n_acyclicity_mc_samples,
            grad_estimator_z=grad_estimator_z,
            score_function_baseline=score_function_baseline,
            latent_prior_std=latent_prior_std, acyclicity=acyclicity,
            acyclicity_constraint=acyclicity_constraint, verbose=verbose,
            sharding=sharding, device=device)
        self.likelihood_model = likelihood_model
        self.graph_model = graph_model
        self.fused_sample_sharing = fused_sample_sharing
        self.kernel = kernel(**kernel_param) if isinstance(kernel, type) else kernel
        self._attach_kernel_sharding()
        self.opt = (get_optimizer(optimizer, optimizer_param)
                    if isinstance(optimizer, str) else optimizer)

    def eltwise_log_likelihood_observ(self, gs, thetas, x_ho):
        """Held-out joint log-likelihoods ``[P]`` of observational data
        (the hook of ``metrics.neg_ave_log_likelihood``)."""
        return self.likelihood_model.interventional_log_joint_prob(
            gs.to(torch.float32), thetas, x_ho, torch.zeros_like(x_ho), None)

    def eltwise_log_likelihood_interv(self, gs, thetas, x_ho, interv_msk_ho):
        """Held-out joint log-likelihoods ``[P]`` of interventional data."""
        return self.likelihood_model.interventional_log_joint_prob(
            gs.to(torch.float32), thetas, x_ho, interv_msk_ho, None)

    # --- functional engine ---

    def init_state(self, *, seed: int, n_particles: int,
                   n_dim_particles=None) -> SVGDState:
        """Initial ``z ~ N(0, sigma_z^2)`` and ``theta ~ p(Theta)`` from a
        ``torch.Generator`` seeded with ``seed``, plus the optimizer states
        (under a sharding that splits the particles, this rank's shard)."""
        gen = torch.Generator().manual_seed(seed)
        z = self._init_z(gen, n_particles, n_dim_particles or self.n_vars)
        theta = self.likelihood_model.sample_parameters(
            generator=gen, n_particles=n_particles, n_vars=self.n_vars,
            device=self.device)
        return self._local_state(SVGDState(
            t=0, seed=seed, z=z, theta=theta, opt_state_z=self.opt.init(z),
            opt_state_theta=self.opt.init(theta),
            sf_baseline=self._init_sf_baseline(n_particles)))

    def _streams(self, t):
        """``(soft, hard, acyclicity)`` noise streams of step ``t``; the
        shared-noise estimators draw both likelihood batches from the
        soft stream."""
        shared = (self.fused_sample_sharing == "hard"
                  and self.est.fused_grad_both is not None)
        return 3 * t, 3 * t if shared else 3 * t + 1, 3 * t + 2

    def _make_transport(self, latent_prior_std) -> Callable:
        """``transport(state, noise=None) -> (phi_z, phi_theta,
        sf_baseline)``: the transports of one step, before the optimizer,
        and the score estimator's updated baseline."""
        kernel = self.kernel

        def transport(state: SVGDState, noise=None):
            est, rows, sharded = self._view(state)
            eps_soft, eps_hard, eps_acyc = (None,) * 3 if noise is None \
                else (e[rows] for e in noise)
            s_soft, s_hard, s_acyc = self._streams(state.t)
            sf_baseline = state.sf_baseline[rows]
            with span("dibs.likelihood"):
                if est.fused_grad_both is not None:
                    dz_lik, dtheta = est.fused_grad_both(
                        state.z, state.theta, state.t, state.seed,
                        (s_soft, s_hard),
                        eps=None if noise is None else (eps_soft, eps_hard))
                else:
                    dtheta = est.eltwise_grad_theta_likelihood(
                        state.z, state.theta, state.t, state.seed, s_hard,
                        eps=eps_hard)
                    dz_lik, sf_baseline = est.eltwise_grad_z_likelihood(
                        state.z, state.theta, sf_baseline, state.t,
                        state.seed, s_soft, eps=eps_soft)
            dz_prior = est.eltwise_grad_latent_prior(
                state.z, state.t, state.seed, s_acyc, latent_prior_std,
                eps=eps_acyc)
            args = (kernel, state.z, state.theta, dz_prior + dz_lik, dtheta)
            with span("dibs.transport"):
                if not sharded:
                    phis = joint_transport(*args)
                elif ring_available(kernel, self.sharding):
                    phis = ring_joint_transport(*args, self.sharding)
                else:
                    phis = gathered_joint_transport(*args, self.sharding)
            return (*phis, self._baselines(state, sf_baseline, sharded))

        return transport

    def _make_fleet_transport(self, xs, interv_masks,
                              latent_prior_std) -> Callable:
        """``transport(state, noise=None) -> (phi_z, phi_theta,
        sf_baseline)`` of a fleet on the datasets ``xs [B_ds, N, d]``
        (masks alike): one batched step on the route the single engine
        takes (the fused kernels, or the generic estimators with their
        ``[B_ds P]`` particles scored on their datasets' data), each kernel
        launched as often as in one dataset's step. The state's tensors and
        parameter leaves lead with ``[B_ds, P]``, its ``seed`` is the
        ``[B_ds]`` int64 keys on the device; ``noise`` is ``(eps_soft,
        eps_hard, eps_acyc)`` with a leading ``[B_ds]``; joint ``score``
        returns the updated ``[B_ds, P]`` baselines."""
        est = self._make_fleet_estimators(xs, interv_masks)
        kernel = self.kernel

        def transport(state: SVGDState, noise=None):
            n_ds, p = state.z.shape[:2]

            def flat(a):
                return a.reshape(n_ds * p, *a.shape[2:])

            def unflat(a):
                return a.reshape(n_ds, p, *a.shape[1:])

            eps_soft, eps_hard, eps_acyc = (None,) * 3 if noise is None \
                else tuple(flat(e) for e in noise)
            s_soft, s_hard, s_acyc = self._streams(state.t)
            z, theta = flat(state.z), tree_map(flat, state.theta)
            sf_baseline = state.sf_baseline
            with span("dibs.likelihood"):
                if est.fused_grad_both is not None:
                    dz_lik, dtheta = est.fused_grad_both(
                        z, theta, state.t, state.seed, (s_soft, s_hard),
                        eps=None if noise is None else (eps_soft, eps_hard))
                else:
                    dtheta = est.eltwise_grad_theta_likelihood(
                        z, theta, state.t, state.seed, s_hard, eps=eps_hard)
                    dz_lik, baselines = est.eltwise_grad_z_likelihood(
                        z, theta, flat(sf_baseline), state.t, state.seed,
                        s_soft, eps=eps_soft)
                    sf_baseline = unflat(baselines)
            dz_prior = est.eltwise_grad_latent_prior(
                z, state.t, state.seed, s_acyc, latent_prior_std,
                eps=eps_acyc)
            dz = unflat(dz_prior + dz_lik)
            with span("dibs.transport"):
                phis = fleet_joint_transport(kernel, state.z, state.theta,
                                             dz, tree_map(unflat, dtheta))
            return (*phis, sf_baseline)

        return transport

    def _make_phi(self, latent_prior_std) -> Callable:
        """``phi(state, noise=None) -> (phi_z, phi_theta)``: the transports
        of one step, before the optimizer."""
        transport = self._make_transport(latent_prior_std)
        return lambda state, noise=None: transport(state, noise)[:2]

    def _make_step(self, latent_prior_std, transport_fn=None) -> Callable:
        """``step(state, noise=None) -> state`` (a fleet's with its
        ``transport_fn`` from :meth:`_make_fleet_transport`)."""
        transport = transport_fn or self._make_transport(latent_prior_std)
        opt = self.opt

        def step(state: SVGDState, noise=None) -> SVGDState:
            with span("dibs.step"), torch.no_grad():
                _check_precision()
                phi_z, phi_theta, sf_baseline = transport(state, noise)
                with span("dibs.update"):
                    up_z, opt_state_z = opt.update(phi_z, state.opt_state_z)
                    up_t, opt_state_t = opt.update(phi_theta,
                                                   state.opt_state_theta)
                    z = state.z + up_z
                    theta = tree_map(torch.add, state.theta, up_t)
                return SVGDState(t=state.t + 1, seed=state.seed, z=z,
                                 theta=theta, opt_state_z=opt_state_z,
                                 opt_state_theta=opt_state_t,
                                 sf_baseline=sf_baseline)

        return step

    def sample(self, *, seed: int, n_particles: int, steps: int,
               n_dim_particles=None, callback=None, callback_every=None,
               return_state=False):
        """Runs SVGD; returns ``(g [P, d, d] int32, theta tree)``, plus
        the final :class:`SVGDState` with ``return_state=True`` (whole on
        every rank of a sharded run)."""
        state = self.init_state(seed=seed, n_particles=n_particles,
                                n_dim_particles=n_dim_particles)
        return self.resume(state, steps=steps, callback=callback,
                           callback_every=callback_every,
                           return_state=return_state)

    def resume(self, state: SVGDState, *, steps, callback=None,
               callback_every=None, return_state=False):
        """Continues a run from ``state`` (whole, or this rank's shard) for
        ``steps`` more steps."""
        step_fn = self._make_step(self._resolve_latent_std(state.z.shape[2]))
        state = self._run(self._local_state(state), steps, callback,
                          callback_every, step_fn)
        state = self._whole_state(state)
        g_final = self.particle_to_g_lim(state.z)
        if return_state:
            return g_final, state.theta, state
        return g_final, state.theta

    # --- posterior wrappers ---

    def get_empirical(self, g, theta) -> ParticleDistribution:
        """Uniform weights: continuous Theta makes every particle unique."""
        n_particles = g.shape[0]
        logp = torch.full((n_particles,), -math.log(n_particles),
                          device=g.device)
        return ParticleDistribution(logp=logp, g=g, theta=theta)

    def get_mixture(self, g, theta) -> ParticleDistribution:
        """DiBS+ mixture: weights proportional to the joint posterior."""
        logp = self.log_joint_prob(g.to(torch.float32), theta, self.x,
                                   self.interv_mask, None)
        logp = logp - torch.logsumexp(logp, dim=0)
        return ParticleDistribution(logp=logp, g=g, theta=theta)
