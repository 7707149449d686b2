"""SVGD engine with the marginal and joint inference classes (PyTorch twin
of ``dibs_tpu/inference/svgd.py``).

All mutable quantities live in an :class:`SVGDState`; one SVGD step is a
``state -> state`` function built once per run and driven by a plain eager
loop. The state carries an integer ``seed`` instead of a JAX key; each step
draws its noise inside the kernels from counter-based streams of that seed:

* ``MarginalDiBS``, step ``t``: hard MC graphs from stream ``2 t``, soft
  acyclicity samples from ``2 t + 1``; ``step(state, noise)`` can instead
  take the Logistic pair ``(eps_hard [P, M, d, d], eps_soft [P, K, d, d])``.
* ``JointDiBS``, step ``t``: soft likelihood samples from stream ``3 t``,
  hard Theta samples from ``3 t + 1`` (from ``3 t`` with
  ``fused_sample_sharing='hard'``: the thresholds of the soft samples'
  noise), acyclicity samples from ``3 t + 2``; ``step(state, noise)`` can
  take ``(eps_soft [P, M, d, d], eps_hard [P, M, d, d], eps_acyc [P, K, d,
  d])``.

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
from dibs_tpu_torch.utils.tree import tree_map

__all__ = ["SVGDState", "DiBS", "MarginalDiBS", "JointDiBS"]


class SVGDState(NamedTuple):
    """Complete carry of an SVGD run (``theta`` / ``opt_state_theta`` are
    ``None`` for marginal inference)."""

    t: int  # step counter
    seed: int  # key of the counter-based noise streams
    z: torch.Tensor  # [n_particles, d, k, 2]
    theta: Any
    opt_state_z: Any
    opt_state_theta: Any
    sf_baseline: torch.Tensor  # [n_particles]


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
                 grad_estimator_z="score",
                 score_function_baseline=0.0, latent_prior_std=None,
                 acyclicity="notears", acyclicity_constraint="sampled",
                 verbose=False, device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
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
        self.est = make_estimators(
            cfg=self.cfg, log_graph_prior=log_graph_prior, x=self.x,
            interv_mask=self.interv_mask,
            batched_node_log_joint_prob=batched_node_log_joint_prob,
            log_joint_prob=log_joint_prob,
            fused_linear_model=fused_linear_model,
            fused_nonlinear_model=fused_nonlinear_model,
            fused_sample_sharing=fused_sample_sharing,
            fused_single_pass=fused_single_pass)

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
                callback(dibs=self, t=state.t, zs=state.z)
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
                 verbose=False, device=DEFAULT_DEVICE):
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
            device=device)
        self.likelihood_model = likelihood_model
        self.graph_model = graph_model
        # the per-graph marginal likelihood, as the reference's log_joint_prob
        # (the estimators keep the batched hook)
        self.log_joint_prob = getattr(likelihood_model,
                                      "interventional_log_marginal_prob", None)
        self.kernel = kernel(**kernel_param) if isinstance(kernel, type) else kernel
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
        seeded with ``seed``, plus the optimizer state."""
        gen = torch.Generator().manual_seed(seed)
        z = self._init_z(gen, n_particles, n_dim_particles or self.n_vars)
        return SVGDState(t=0, seed=seed, z=z, theta=None,
                         opt_state_z=self.opt.init(z), opt_state_theta=None,
                         sf_baseline=self._init_sf_baseline(n_particles))

    def _make_phi(self, latent_prior_std) -> Callable:
        """``phi(state, noise=None) -> (phi_z, sf_baseline)``: the transport
        of one step, before the optimizer."""
        est, kernel = self.est, self.kernel

        def phi(state: SVGDState, noise=None):
            eps_hard, eps_soft = (None, None) if noise is None else noise
            stream = 2 * state.t
            dz_lik, sf_baseline = est.eltwise_grad_z_likelihood(
                state.z, None, state.sf_baseline, state.t, state.seed, stream,
                eps=eps_hard)
            dz_prior = est.eltwise_grad_latent_prior(
                state.z, state.t, state.seed, stream + 1, latent_prior_std,
                eps=eps_soft)
            return marginal_transport(kernel, state.z, dz_prior + dz_lik), \
                sf_baseline

        return phi

    def _make_step(self, latent_prior_std) -> Callable:
        """``step(state, noise=None) -> state``."""
        phi_fn, opt = self._make_phi(latent_prior_std), self.opt

        def step(state: SVGDState, noise=None) -> SVGDState:
            _check_precision()
            with torch.no_grad():
                phi_z, sf_baseline = phi_fn(state, noise)
                updates, opt_state_z = opt.update(phi_z, state.opt_state_z)
                return SVGDState(t=state.t + 1, seed=state.seed,
                                 z=state.z + updates, theta=None,
                                 opt_state_z=opt_state_z,
                                 opt_state_theta=None,
                                 sf_baseline=sf_baseline)

        return step

    def sample(self, *, seed: int, n_particles: int, steps: int,
               n_dim_particles=None, callback=None, callback_every=None,
               return_state=False):
        """Runs SVGD and returns hard graphs ``[n_particles, d, d]`` (int32),
        plus the final :class:`SVGDState` with ``return_state=True``."""
        state = self.init_state(seed=seed, n_particles=n_particles,
                                n_dim_particles=n_dim_particles)
        return self.resume(state, steps=steps, callback=callback,
                           callback_every=callback_every,
                           return_state=return_state)

    def resume(self, state: SVGDState, *, steps, callback=None,
               callback_every=None, return_state=False):
        """Continues a run from ``state`` for ``steps`` more steps."""
        step_fn = self._make_step(self._resolve_latent_std(state.z.shape[2]))
        state = self._run(state, steps, callback, callback_every, step_fn)
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
    keeps separate streams). For ``LinearGaussian`` both likelihood
    gradients come from the fused kernels
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
                 verbose=False, fused_sample_sharing="hard",
                 fused_single_pass=True, device=DEFAULT_DEVICE):
        if grad_estimator_z != "reparam":
            raise NotImplementedError(
                "JointDiBS serves grad_estimator_z='reparam' (the joint "
                "score estimators are not ported yet)")
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
            device=device)
        self.likelihood_model = likelihood_model
        self.graph_model = graph_model
        self.fused_sample_sharing = fused_sample_sharing
        self.kernel = kernel(**kernel_param) if isinstance(kernel, type) else kernel
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
        ``torch.Generator`` seeded with ``seed``, plus the optimizer
        states."""
        gen = torch.Generator().manual_seed(seed)
        z = self._init_z(gen, n_particles, n_dim_particles or self.n_vars)
        theta = self.likelihood_model.sample_parameters(
            generator=gen, n_particles=n_particles, n_vars=self.n_vars,
            device=self.device)
        return SVGDState(t=0, seed=seed, z=z, theta=theta,
                         opt_state_z=self.opt.init(z),
                         opt_state_theta=self.opt.init(theta),
                         sf_baseline=self._init_sf_baseline(n_particles))

    def _streams(self, t):
        """``(soft, hard, acyclicity)`` noise streams of step ``t``."""
        hard = 3 * t if self.fused_sample_sharing == "hard" else 3 * t + 1
        return 3 * t, hard, 3 * t + 2

    def _make_phi(self, latent_prior_std) -> Callable:
        """``phi(state, noise=None) -> (phi_z, phi_theta)``: the transports
        of one step, before the optimizer."""
        est, kernel = self.est, self.kernel

        def phi(state: SVGDState, noise=None):
            eps_soft, eps_hard, eps_acyc = (None,) * 3 if noise is None \
                else noise
            s_soft, s_hard, s_acyc = self._streams(state.t)
            if est.fused_grad_both is not None:
                dz_lik, dtheta = est.fused_grad_both(
                    state.z, state.theta, state.t, state.seed,
                    (s_soft, s_hard),
                    eps=None if noise is None else (eps_soft, eps_hard))
            else:
                dtheta = est.eltwise_grad_theta_likelihood(
                    state.z, state.theta, state.t, state.seed, s_hard,
                    eps=eps_hard)
                dz_lik, _ = est.eltwise_grad_z_likelihood(
                    state.z, state.theta, state.sf_baseline, state.t,
                    state.seed, s_soft, eps=eps_soft)
            dz_prior = est.eltwise_grad_latent_prior(
                state.z, state.t, state.seed, s_acyc, latent_prior_std,
                eps=eps_acyc)
            return joint_transport(kernel, state.z, state.theta,
                                   dz_prior + dz_lik, dtheta)

        return phi

    def _make_step(self, latent_prior_std) -> Callable:
        """``step(state, noise=None) -> state``."""
        phi_fn, opt = self._make_phi(latent_prior_std), self.opt

        def step(state: SVGDState, noise=None) -> SVGDState:
            _check_precision()
            with torch.no_grad():
                phi_z, phi_theta = phi_fn(state, noise)
                up_z, opt_state_z = opt.update(phi_z, state.opt_state_z)
                up_t, opt_state_t = opt.update(phi_theta,
                                               state.opt_state_theta)
                return SVGDState(t=state.t + 1, seed=state.seed,
                                 z=state.z + up_z,
                                 theta=tree_map(torch.add, state.theta, up_t),
                                 opt_state_z=opt_state_z,
                                 opt_state_theta=opt_state_t,
                                 sf_baseline=state.sf_baseline)

        return step

    def sample(self, *, seed: int, n_particles: int, steps: int,
               n_dim_particles=None, callback=None, callback_every=None,
               return_state=False):
        """Runs SVGD; returns ``(g [P, d, d] int32, theta tree)``, plus
        the final :class:`SVGDState` with ``return_state=True``."""
        state = self.init_state(seed=seed, n_particles=n_particles,
                                n_dim_particles=n_dim_particles)
        return self.resume(state, steps=steps, callback=callback,
                           callback_every=callback_every,
                           return_state=return_state)

    def resume(self, state: SVGDState, *, steps, callback=None,
               callback_every=None, return_state=False):
        """Continues a run from ``state`` for ``steps`` more steps."""
        step_fn = self._make_step(self._resolve_latent_std(state.z.shape[2]))
        state = self._run(state, steps, callback, callback_every, step_fn)
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
