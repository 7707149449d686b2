"""Port parity for the joint slice: JointDiBS with LinearGaussian, the
scale-free and uniform priors, the linear-Gaussian factory, the joint kernel
and transport, against dibs_tpu on the CPU.

JointDiBS runs in both packages from the same particles, with the
reference's noise injected into the port. The reference's key schedule is
replayed: per step ``split(state.key, 4)`` gives ``(key, k_theta, k_lik,
k_prior)``. With ``fused_sample_sharing='hard'`` the reference draws one
``random.logistic(k_lik, [P, M, d, d])`` for both likelihood gradients (the
port gets it as ``eps_soft`` and ``eps_hard``); with ``None`` the soft noise
comes from ``split(k_lik, P)[0]`` and the hard noise from
``split(k_theta, P)[0]``. The acyclicity noise comes from
``split(k_prior, P)[0]``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from dibs_tpu.inference import JointDiBS as JaxJointDiBS
from dibs_tpu.inference.transport import joint_transport as jax_joint_transport
from dibs_tpu.kernel import JointAdditiveFrobeniusSEKernel as JaxJointKernel
from dibs_tpu.models import LinearGaussian as JaxLinearGaussian
from dibs_tpu.models import ScaleFreeDAGDistribution as JaxSF
from dibs_tpu.target import make_linear_gaussian_model as jax_data
from dibs_tpu_torch.inference import JointDiBS, MarginalDiBS
from dibs_tpu_torch.inference.transport import joint_transport
from dibs_tpu_torch.interop import (
    linear_gaussian_from_reference,
    state_from_reference,
    target_from_reference,
)
from dibs_tpu_torch.kernel import JointAdditiveFrobeniusSEKernel
from dibs_tpu_torch.models import (
    BGe,
    LinearGaussian,
    ScaleFreeDAGDistribution,
    UniformDAGDistributionRejection,
)
from dibs_tpu_torch.ops.acyclic import acyclic_constr
from dibs_tpu_torch.target import make_graph_model, make_linear_gaussian_model
from dibs_tpu_torch.warmup import warmup

torch.set_num_threads(1)

# N=10: the reference scores log p(Theta, D | G) uncentred in float32. At
# N=20 its early |ll| reached ~1e4 nats, rounded by ~3e-4 nats; where two
# samples nearly tie (weights 0.39 / 0.61 at t=10) that alone moved its
# d Theta 3x past the 1e-4 max|phi| bar, while the port, closer to a
# float64 evaluation by 8x, is held to the reference here.
D, P, K_LAT, M, K_ACYC, N_OBS, STEPS = 8, 4, 6, 16, 8, 10, 20
SHARING = {"hard": "hard", "separate": None}


@pytest.fixture(scope="module")
def problem():
    data, _, lm = jax_data(key=random.PRNGKey(7), n_vars=D,
                           graph_prior_str="sf", n_observations=N_OBS)
    return np.array(data.x), np.array(data.g), np.array(data.theta), lm


def _pair(x, lm, sharing):
    ref = JaxJointDiBS(x=jnp.asarray(x), graph_model=JaxSF(D),
                       likelihood_model=lm, n_grad_mc_samples=M,
                       n_acyclicity_mc_samples=K_ACYC,
                       fused_sample_sharing=sharing)
    port = JointDiBS(
        x=torch.from_numpy(x), graph_model=ScaleFreeDAGDistribution(D),
        likelihood_model=linear_gaussian_from_reference(
            n_vars=D, obs_noise=lm.obs_noise, mean_edge=lm.mean_edge,
            sig_edge=lm.sig_edge, min_edge=lm.min_edge),
        n_grad_mc_samples=M, n_acyclicity_mc_samples=K_ACYC,
        fused_sample_sharing=sharing, device="cpu")
    return ref, port


def _reference_run(ref, std, sharing):
    """Runs the reference for STEPS steps; returns per step the state, the
    pre-optimizer transports and the Logistic noise its samplers drew."""
    step = jax.jit(ref._make_step(std))

    @jax.jit
    def phi_and_noise(st):
        _, k_theta, k_lik, k_prior = random.split(st.key, 4)
        keys_prior = random.split(k_prior, P)
        if sharing == "hard":
            dz_lik, dtheta = ref.est.fused_grad_both(st.z, st.theta, st.t,
                                                     k_lik)
            eps_soft = eps_hard = random.logistic(k_lik, (P, M, D, D))
        else:
            keys_theta = random.split(k_theta, P)
            keys_lik = random.split(k_lik, P)
            dtheta = ref.est.eltwise_grad_theta_likelihood(
                st.z, st.theta, st.t, keys_theta)
            dz_lik, _ = ref.est.eltwise_grad_z_likelihood(
                st.z, st.theta, st.sf_baseline, st.t, keys_lik)
            eps_soft = random.logistic(keys_lik[0], (P, M, D, D))
            eps_hard = random.logistic(keys_theta[0], (P, M, D, D))
        dz_prior = ref.est.eltwise_grad_latent_prior(st.z, keys_prior, st.t,
                                                     std)
        phi = jax_joint_transport(ref.kernel, st.z, st.theta,
                                  dz_prior + dz_lik, dtheta)
        eps_acyc = random.logistic(keys_prior[0], (P, K_ACYC, D, D))
        return phi, (eps_soft, eps_hard, eps_acyc)

    state = ref.init_state(key=random.PRNGKey(3), n_particles=P,
                           n_dim_particles=K_LAT)
    out = []
    for _ in range(STEPS):
        phi, noise = phi_and_noise(state)
        out.append((state, tuple(np.asarray(a) for a in phi),
                    tuple(torch.from_numpy(np.array(e)) for e in noise)))
        state = step(state)
    return out, state


def _to_port(st):
    return state_from_reference(
        z=st.z, nu=st.opt_state_z[0].nu, sf_baseline=st.sf_baseline, t=st.t,
        seed=0, theta=st.theta, nu_theta=st.opt_state_theta[0].nu,
        device="cpu")


def _fraction_rule(ours, ref, name):
    diff = np.abs(ours - np.asarray(ref))
    frac, mx = float((diff > 5e-5).mean()), float(diff.max())
    assert frac < 5e-3 and mx < 5e-3, (name, frac, mx)


@pytest.mark.parametrize("sharing", list(SHARING))
def test_joint_dibs_matches_reference_for_20_steps(problem, sharing):
    x, _, _, lm = problem
    ref, port = _pair(x, lm, SHARING[sharing])
    std = 1.0 / np.sqrt(K_LAT)
    run, ref_final = _reference_run(ref, std, SHARING[sharing])

    # the port takes the fused path (its plain version on the CPU)
    assert port.est.fused_grad_both is not None
    # teacher-forced: the port's transports from every reference state
    phi_fn = port._make_phi(port._resolve_latent_std(K_LAT))
    for st, phi_ref, noise in run:
        with torch.no_grad():
            phi = phi_fn(_to_port(st), noise)
        for got, want, name in zip(phi, phi_ref, ("z", "theta")):
            tol = 1e-4 * np.abs(want).max()
            err = np.abs(got.numpy() - want).max()
            assert err <= tol, (sharing, name, int(st.t), err, tol)

    # free-running: the port's own 20 steps with the same noise
    state = _to_port(run[0][0])
    step = port._make_step(port._resolve_latent_std(K_LAT))
    for _, _, noise in run:
        state = step(state, noise)
    assert state.t == STEPS
    _fraction_rule(state.z.numpy(), ref_final.z, "z")
    _fraction_rule(state.theta.numpy(), ref_final.theta, "theta")

    # posterior wrappers on the same final particles
    g = np.asarray(ref.particle_to_g_lim(ref_final.z))
    theta = np.asarray(ref_final.theta)
    g_t, th_t = torch.from_numpy(g), torch.from_numpy(theta)
    emp, emp_ref = port.get_empirical(g_t, th_t), ref.get_empirical(
        jnp.asarray(g), jnp.asarray(theta))
    np.testing.assert_allclose(emp.logp.numpy(), emp_ref.logp, rtol=1e-6)
    assert emp.theta is th_t
    mix, mix_ref = port.get_mixture(g_t, th_t), ref.get_mixture(
        jnp.asarray(g), jnp.asarray(theta))
    np.testing.assert_allclose(mix.logp.numpy(), mix_ref.logp, atol=1e-3)


def test_two_pass_route_gives_the_one_pass_transport(problem):
    """``fused_single_pass=False`` (kernels #6 + #7 on the card, their plain
    versions here) gives the same transports as the one-pass route."""
    x, _, _, lm = problem
    _, one = _pair(x, lm, "hard")
    two = JointDiBS(x=torch.from_numpy(x),
                    graph_model=ScaleFreeDAGDistribution(D),
                    likelihood_model=one.likelihood_model,
                    n_grad_mc_samples=M, n_acyclicity_mc_samples=K_ACYC,
                    fused_single_pass=False, device="cpu")
    std = one._resolve_latent_std(K_LAT)
    state = one.init_state(seed=4, n_particles=P, n_dim_particles=K_LAT)
    state = one._make_step(std)(state)
    with torch.no_grad():
        for a, b in zip(one._make_phi(std)(state), two._make_phi(std)(state)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-5 * float(b.abs().max()))


@pytest.mark.parametrize("sharing", [None, "hard"])
def test_past_the_kernel_gate_the_generic_estimators_run(sharing):
    """Past the fused kernels' shape gate (the wide tier's shared memory:
    d <= 602 for any N, d <= 622 at N = 5) the engine warns and takes the
    generic estimators: shared-noise for 'hard', separate otherwise."""
    d = 640
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(5, d)).astype(np.float32))
    with pytest.warns(UserWarning, match="fused linear-Gaussian kernels"):
        dibs = JointDiBS(x=x, graph_model=ScaleFreeDAGDistribution(d),
                         likelihood_model=LinearGaussian(n_vars=d),
                         n_grad_mc_samples=4, n_acyclicity_mc_samples=2,
                         fused_sample_sharing=sharing, device="cpu")
    assert (dibs.est.fused_grad_both is None) == (sharing is None)
    g, theta = dibs.sample(seed=1, n_particles=2, steps=2, n_dim_particles=3)
    assert g.shape == (2, d, d) and torch.isfinite(theta).all()


def test_joint_sample_resume_and_held_out_likelihoods(problem):
    x, _, _, lm = problem
    _, port = _pair(x, lm, "hard")
    seen = []
    g, theta, state = port.sample(seed=5, n_particles=P, steps=4,
                                  n_dim_particles=K_LAT,
                                  callback=lambda **kw: seen.append(kw["t"]),
                                  callback_every=2, return_state=True)
    assert seen == [2, 4] and state.t == 4
    assert g.dtype == torch.int32 and theta.shape == (P, D, D)
    g2, theta2 = port.resume(state, steps=2)
    assert g2.shape == g.shape and torch.isfinite(theta2).all()
    x_ho = torch.from_numpy(x[:7])
    ll_obs = port.eltwise_log_likelihood_observ(g.float(), theta, x_ho)
    mask = torch.zeros_like(x_ho, dtype=torch.int32)
    mask[:, 0] = 1
    ll_int = port.eltwise_log_likelihood_interv(g.float(), theta, x_ho, mask)
    ref = JaxLinearGaussian(n_vars=D)
    for b in range(P):
        want = ref.interventional_log_joint_prob(
            jnp.asarray(g[b].numpy()), jnp.asarray(theta[b].numpy()),
            jnp.asarray(x[:7]), jnp.asarray(mask.numpy()), None)
        np.testing.assert_allclose(ll_int[b].item(), want, rtol=1e-5)
    assert ll_obs.shape == (P,) and torch.isfinite(ll_obs).all()


# ---------------------------------------------------------------------------
# models, factory, kernel, transport
# ---------------------------------------------------------------------------


def test_linear_gaussian_joint_prob_matches_reference():
    d, n, b = 6, 15, 5
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, d)).astype(np.float32)
    interv = (rng.uniform(size=(n, d)) < 0.2).astype(np.int32)
    gs = (rng.uniform(size=(b, d, d)) < 0.4).astype(np.float32)
    gs *= 1.0 - np.eye(d, dtype=np.float32)
    thetas = rng.normal(size=(b, d, d)).astype(np.float32)
    ours = LinearGaussian(n_vars=d, obs_noise=0.2, mean_edge=0.3,
                          sig_edge=1.5)
    ref = JaxLinearGaussian(n_vars=d, obs_noise=0.2, mean_edge=0.3,
                            sig_edge=1.5)
    args = [torch.from_numpy(a) for a in (x, interv)]
    batched = ours.interventional_log_joint_prob(
        torch.from_numpy(gs), torch.from_numpy(thetas), *args, None)
    assert batched.shape == (b,)
    for k in range(b):
        want = ref.interventional_log_joint_prob(
            jnp.asarray(gs[k]), jnp.asarray(thetas[k]), jnp.asarray(x),
            jnp.asarray(interv), None)
        single = ours.interventional_log_joint_prob(
            torch.from_numpy(gs[k]), torch.from_numpy(thetas[k]), *args,
            None)
        np.testing.assert_allclose(single.item(), want, rtol=2e-6)
        np.testing.assert_allclose(batched[k].item(), want, rtol=2e-6)
    assert ours.get_theta_shape(n_vars=d) == (d, d)
    with pytest.raises(ValueError):  # x and the mask must match
        ours.interventional_log_joint_prob(
            torch.from_numpy(gs), torch.from_numpy(thetas), args[0],
            args[1][:3], None)


def test_scale_free_prior_samples_and_soft_prob():
    d, m = 12, 2
    model = ScaleFreeDAGDistribution(d, n_edges_per_node=m)
    gen = torch.Generator().manual_seed(0)
    for _ in range(5):
        g = model.sample_G(gen, device="cpu")
        assert g.dtype == torch.int32 and g.shape == (d, d)
        assert float(acyclic_constr(g.float())) == 0.0
        assert int(g.sum()) == sum(min(m, v) for v in range(d))
    rng = np.random.default_rng(1)
    soft = rng.uniform(size=(3, d, d)).astype(np.float32)
    ours = model.unnormalized_log_prob_soft(soft_g=torch.from_numpy(soft))
    ref = JaxSF(d, n_edges_per_node=m)
    for k in range(3):
        np.testing.assert_allclose(
            ours[k].item(),
            ref.unnormalized_log_prob_soft(soft_g=jnp.asarray(soft[k])),
            rtol=1e-6)


def test_uniform_prior_and_graph_model_dispatch():
    gen = torch.Generator().manual_seed(2)
    model = make_graph_model(n_vars=4, graph_prior_str="uniform")
    assert isinstance(model, UniformDAGDistributionRejection)
    for _ in range(5):
        g = model.sample_G(gen, device="cpu")
        assert float(acyclic_constr(g.float())) == 0.0
        assert int(torch.diagonal(g).abs().sum()) == 0
    assert model.unnormalized_log_prob_soft(
        soft_g=torch.ones(3, 4, 4)).shape == (3,)
    with pytest.raises(ValueError):
        make_graph_model(n_vars=6, graph_prior_str="uniform")


def test_linear_gaussian_factory_builds_a_valid_problem():
    gen = torch.Generator().manual_seed(4)
    data, gm, lm = make_linear_gaussian_model(
        generator=gen, n_vars=10, n_observations=30, n_ho_observations=20,
        device="cpu")
    assert isinstance(gm, ScaleFreeDAGDistribution)
    assert isinstance(lm, LinearGaussian)
    assert data.x.shape == (30, 10) and data.x_ho.shape == (20, 10)
    assert float(acyclic_constr(data.g.float())) == 0.0
    assert (data.theta.abs() >= 0.5).all() and torch.isfinite(data.x).all()
    ref_data, _, _ = jax_data(key=random.PRNGKey(0), n_vars=10,
                              n_observations=30, n_ho_observations=20)
    g_t, th_t = target_from_reference(g=ref_data.g, theta=ref_data.theta,
                                      device="cpu")
    assert g_t.dtype == torch.int32 and g_t.shape == data.g.shape
    assert th_t.dtype == torch.float32 and th_t.shape == data.theta.shape


class _EvalOnlyJoint:
    """A joint kernel with only the reference ``eval`` signature."""

    def __init__(self, h_z, h_t):
        self.h_z, self.h_t = h_z, h_t

    def eval(self, *, x_latent, x_theta, y_latent, y_theta):
        lib = torch if torch.is_tensor(x_latent) else jnp
        return (lib.exp(-lib.sum((x_latent - y_latent) ** 2) / self.h_z)
                + lib.exp(-lib.sum((x_theta - y_theta) ** 2) / self.h_t))


@pytest.mark.parametrize("kind", ["fixed", "median", "eval_only"])
def test_joint_transport_matches_reference(kind):
    rng = np.random.default_rng(11)
    z = (rng.normal(size=(P, D, K_LAT, 2)) / 2).astype(np.float32)
    theta = rng.normal(size=(P, D, D)).astype(np.float32)
    dz = rng.normal(size=z.shape).astype(np.float32)
    dtheta = rng.normal(size=theta.shape).astype(np.float32)
    if kind == "eval_only":
        ours_k, ref_k = _EvalOnlyJoint(5.0, 50.0), _EvalOnlyJoint(5.0, 50.0)
    else:
        h = dict(h_latent=5.0, h_theta=50.0) if kind == "fixed" else dict(
            h_latent="median", h_theta="median")
        ours_k, ref_k = JointAdditiveFrobeniusSEKernel(**h), JaxJointKernel(**h)
    phi = joint_transport(ours_k, *[torch.from_numpy(a)
                                    for a in (z, theta, dz, dtheta)])
    phi_ref = jax_joint_transport(ref_k, *[jnp.asarray(a)
                                           for a in (z, theta, dz, dtheta)])
    for got, want in zip(phi, phi_ref):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# device policy
# ---------------------------------------------------------------------------


def test_entry_points_default_to_the_card(problem):
    """Without ``device`` every entry point takes CUDA; where CUDA is absent
    it raises instead of running on the CPU."""
    x, _, _, _ = problem
    x_t = torch.from_numpy(x)
    gen = torch.Generator().manual_seed(0)
    builds = [
        lambda: JointDiBS(x=x_t, graph_model=ScaleFreeDAGDistribution(D),
                          likelihood_model=LinearGaussian(n_vars=D)),
        lambda: MarginalDiBS(x=x_t, graph_model=ScaleFreeDAGDistribution(D),
                             likelihood_model=BGe(n_vars=D, device="cpu")),
        lambda: BGe(n_vars=D),
        lambda: LinearGaussian(n_vars=D).sample_parameters(generator=gen,
                                                           n_vars=D),
        lambda: ScaleFreeDAGDistribution(D).sample_G(gen),
        lambda: make_linear_gaussian_model(generator=gen, n_vars=D),
        lambda: warmup(D, verbose=False),
    ]
    if torch.cuda.is_available():
        assert JointDiBS(x=x_t, graph_model=ScaleFreeDAGDistribution(D),
                         likelihood_model=LinearGaussian(n_vars=D)
                         ).device.type == "cuda"
        return
    for build in builds:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
