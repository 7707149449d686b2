"""Port parity for joint ``score``: JointDiBS with LinearGaussian and
``grad_estimator_z='score'`` (REINFORCE, without and with the signed EMA
baseline) against dibs_tpu on the CPU, with the harness and bars of
``tests/test_torch_joint.py``.

The reference's key schedule is replayed: per step ``split(state.key, 4)``
gives ``(key, k_theta, k_lik, k_prior)``. On the CPU the reference's Z
estimator draws each particle's hard graphs as ``bernoulli(k_g, p)``, i.e.
``uniform(k_g) < p``, with ``k_g = split(split(k_lik, P)[p])[1]``; the port
draws ``1[l + alpha s > 0]``. With ``l = log(1 - u) - log(u)`` from the
same uniforms the two are the same graphs, and the test asserts that they
are before it compares any gradient. The Theta estimator's hard noise is
``logistic(split(k_theta, P)[0], [P, M, d, d])`` and the acyclicity noise
``logistic(split(k_prior, P)[0], [P, K, d, d])``.

Tolerances: teacher-forced transports within ``1e-4 max|phi|`` and the
baseline within 1e-5 relative; free-running ``z`` and ``theta`` by the
fraction rule of ``tests/test_torch_joint.py``; hard graphs exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random
from test_torch_joint import D, K_ACYC, K_LAT, M, N_OBS, P, STEPS
from test_torch_joint import _fraction_rule, _to_port

from dibs_tpu.inference import JointDiBS as JaxJointDiBS
from dibs_tpu.inference.transport import joint_transport as jax_joint_transport
from dibs_tpu.models import ScaleFreeDAGDistribution as JaxSF
from dibs_tpu.ops.edges import edge_probs as jax_edge_probs
from dibs_tpu.ops.edges import sample_g as jax_sample_g
from dibs_tpu.target import make_linear_gaussian_model as jax_data
from dibs_tpu_torch.inference import JointDiBS
from dibs_tpu_torch.inference import estimators as port_estimators
from dibs_tpu_torch.interop import linear_gaussian_from_reference
from dibs_tpu_torch.models import ScaleFreeDAGDistribution
from dibs_tpu_torch.ops.edges import grad_latent_log_prob_batch

torch.set_num_threads(1)

BASELINES = [0.0, 0.5]


@pytest.fixture(scope="module")
def problem():
    data, _, lm = jax_data(key=random.PRNGKey(7), n_vars=D,
                           graph_prior_str="sf", n_observations=N_OBS)
    return np.array(data.x), lm


def _pair(x, lm, baseline, estimator="score"):
    kw = dict(n_grad_mc_samples=M, n_acyclicity_mc_samples=K_ACYC,
              grad_estimator_z=estimator,
              score_function_baseline=baseline)
    ref = JaxJointDiBS(x=jnp.asarray(x), graph_model=JaxSF(D),
                       likelihood_model=lm, **kw)
    port = JointDiBS(
        x=torch.from_numpy(x), graph_model=ScaleFreeDAGDistribution(D),
        likelihood_model=linear_gaussian_from_reference(
            n_vars=D, obs_noise=lm.obs_noise, mean_edge=lm.mean_edge,
            sig_edge=lm.sig_edge, min_edge=lm.min_edge),
        device="cpu", **kw)
    return ref, port


def _reference_run(ref, std):
    """Runs the reference for STEPS steps; returns per step the state, the
    pre-optimizer transports, the new baseline, the Z estimator's hard
    graphs and the noise to inject into the port."""
    step = jax.jit(ref._make_step(std))

    @jax.jit
    def phi_and_noise(st):
        _, k_theta, k_lik, k_prior = random.split(st.key, 4)
        keys_theta = random.split(k_theta, P)
        keys_lik = random.split(k_lik, P)
        keys_prior = random.split(k_prior, P)
        dtheta = ref.est.eltwise_grad_theta_likelihood(
            st.z, st.theta, st.t, keys_theta)
        dz_lik, baseline = ref.est.eltwise_grad_z_likelihood(
            st.z, st.theta, st.sf_baseline, st.t, keys_lik)
        dz_prior = ref.est.eltwise_grad_latent_prior(st.z, keys_prior, st.t,
                                                     std)
        phi = jax_joint_transport(ref.kernel, st.z, st.theta,
                                  dz_prior + dz_lik, dtheta)
        # the reference's per-particle draw: key, k_g = split(key)
        k_g = jax.vmap(lambda k: random.split(k)[1])(keys_lik)
        u = jax.vmap(lambda k: random.uniform(k, (M, D, D)))(k_g)
        probs = jax.vmap(lambda z: jax_edge_probs(z, ref.alpha(st.t)))(st.z)
        g_ref = jax.vmap(lambda p, k: jax_sample_g(p, k, M))(probs, k_g)
        eps_score = jnp.log(1.0 - u) - jnp.log(u)
        eps_hard = random.logistic(keys_theta[0], (P, M, D, D))
        eps_acyc = random.logistic(keys_prior[0], (P, K_ACYC, D, D))
        return phi, baseline, g_ref, (eps_score, eps_hard, eps_acyc)

    state = ref.init_state(key=random.PRNGKey(3), n_particles=P,
                           n_dim_particles=K_LAT)
    out = []
    for _ in range(STEPS):
        phi, baseline, g_ref, noise = phi_and_noise(state)
        out.append((state, tuple(np.asarray(a) for a in phi),
                    np.asarray(baseline), np.asarray(g_ref),
                    tuple(torch.from_numpy(np.array(e)) for e in noise)))
        state = step(state)
    return out, state


@pytest.fixture
def hard_graphs(monkeypatch):
    """Records the hard graphs the port's Z estimator scores (the Theta
    estimator draws through the same function: the first call of a step
    is the Theta estimator's, the second the Z estimator's)."""
    seen = []
    sampler = port_estimators.sample_hard_graphs

    def recording(*args, **kwargs):
        out = sampler(*args, **kwargs)
        seen.append(out)
        return out

    monkeypatch.setattr(port_estimators, "sample_hard_graphs", recording)
    return seen


@pytest.mark.parametrize("baseline", BASELINES)
def test_joint_score_matches_reference_for_20_steps(problem, hard_graphs,
                                                    baseline):
    x, lm = problem
    ref, port = _pair(x, lm, baseline)
    std = 1.0 / np.sqrt(K_LAT)
    run, ref_final = _reference_run(ref, std)

    # the REINFORCE route: no fused kernels, separate Theta noise
    assert port.est.fused_grad_both is None
    assert port._streams(4) == (12, 13, 14)
    transport = port._make_transport(port._resolve_latent_std(K_LAT))
    for st, phi_ref, baseline_ref, g_ref, noise in run:
        hard_graphs.clear()
        with torch.no_grad():
            phi_z, phi_t, new_baseline = transport(_to_port(st), noise)
        # the Z estimator scored exactly the reference's graphs
        assert len(hard_graphs) == 2
        g_port = hard_graphs[1].to(torch.int32).numpy()
        assert np.array_equal(g_port, g_ref), (baseline, int(st.t))
        for got, want, name in zip((phi_z, phi_t), phi_ref, ("z", "theta")):
            tol = 1e-4 * np.abs(want).max()
            err = np.abs(got.numpy() - want).max()
            assert err <= tol, (baseline, name, int(st.t), err, tol)
        np.testing.assert_allclose(new_baseline.numpy(), baseline_ref,
                                   rtol=1e-5)

    # free-running: the port's own 20 steps with the same noise
    state = _to_port(run[0][0])
    step = port._make_step(port._resolve_latent_std(K_LAT))
    for *_, noise in run:
        state = step(state, noise)
    assert state.t == STEPS
    _fraction_rule(state.z.numpy(), ref_final.z, "z")
    _fraction_rule(state.theta.numpy(), ref_final.theta, "theta")
    np.testing.assert_allclose(state.sf_baseline.numpy(),
                               ref_final.sf_baseline, rtol=1e-4)


def test_joint_score_rb_raises_the_reference_error(problem):
    x, lm = problem
    match = "per-node likelihood decomposition"
    ref_rb = JaxJointDiBS(x=jnp.asarray(x), graph_model=JaxSF(D),
                          likelihood_model=lm, n_grad_mc_samples=M,
                          n_acyclicity_mc_samples=K_ACYC,
                          grad_estimator_z="score_rb")
    with pytest.raises(ValueError, match=match):
        ref_rb.sample(key=random.PRNGKey(0), n_particles=2, steps=1,
                      n_dim_particles=K_LAT)
    with pytest.raises(ValueError, match=match):
        _pair(x, lm, 0.0, estimator="score_rb")


@pytest.mark.parametrize("baseline", BASELINES)
def test_joint_score_sample_end_to_end(problem, baseline):
    """``sample()`` with its own in-kernel noise (the plain sampler here):
    finite particles, the baseline moved only with ``c > 0``, and a
    mixture over the final particles."""
    x, lm = problem
    _, port = _pair(x, lm, baseline)
    g, theta, state = port.sample(seed=5, n_particles=P, steps=6,
                                  n_dim_particles=K_LAT, return_state=True)
    assert g.shape == (P, D, D) and g.dtype == torch.int32
    assert torch.isfinite(theta).all() and torch.isfinite(state.z).all()
    assert torch.isfinite(state.sf_baseline).all()
    assert bool((state.sf_baseline == 0).all()) == (baseline == 0)
    mix = port.get_mixture(g, theta)
    assert torch.isfinite(mix.logp).all()
    assert float(torch.logsumexp(mix.logp, 0)) == pytest.approx(0.0,
                                                                abs=1e-5)


def _score_ratio_float64(port, zs, theta, b, g, x, alpha):
    """The REINFORCE ratio with the signed baseline ``b``, evaluated in
    float64 (numpy) from the same inputs: ``sum_m w_m grad log p(G_m | Z)
    / sum_m p_m`` with ``w_m = p_m - exp(b)``, every exponent taken
    relative to the particle's largest log-probability."""
    logp = port.likelihood_model.interventional_log_joint_prob(
        g.double(), theta.double()[:, None], x.double(),
        torch.zeros_like(x).double(), None).numpy()
    grads = grad_latent_log_prob_batch(g.double(), zs.double(),
                                       alpha).numpy()
    shift = logp.max(1, keepdims=True)
    num_w = np.exp(logp - shift) - np.exp(b.double().numpy()[:, None]
                                          - shift)
    den = np.exp(logp - shift).sum(1)
    return np.einsum("pm,pm...->p...", num_w, grads) / den[:, None, None,
                                                          None]


@pytest.mark.parametrize("offset", [-5.0, 200.0])
def test_baseline_far_above_the_samples_overflows_as_in_the_reference(
        problem, offset):
    """The signed EMA baseline scales the ratio by ``exp(b - logsumexp(log
    p))``: with ``b`` 5 nats below the samples' largest log-probability
    both packages give a finite gradient, and the port's is held to the
    float64 value of the same formula on the same inputs; 200 nats above
    it, both overflow (the reference's formula, kept as it is).

    The log-probabilities here run from -13880 to -1663 nats. The
    reference evaluates the ratio's log-space sums at that magnitude in
    float32, which puts it 1.65 times the bar off the float64 value
    (6.29e-5 against 3.82e-5); the port centres the log-weights first and
    is 2.3e-6 off. The port is therefore held to the float64 value, not to
    the reference's rounding."""
    x, lm = problem
    ref, port = _pair(x, lm, 0.5)
    st = ref.init_state(key=random.PRNGKey(3), n_particles=P,
                        n_dim_particles=K_LAT)
    t = 5  # alpha(t) > 0
    keys_lik = random.split(random.PRNGKey(11), P)
    k_g = jax.vmap(lambda k: random.split(k)[1])(keys_lik)
    probs = jax.vmap(lambda z: jax_edge_probs(z, ref.alpha(t)))(st.z)
    g_ref = np.array(jax.vmap(lambda p, k: jax_sample_g(p, k, M))(probs,
                                                                  k_g))
    u = np.array(jax.vmap(lambda k: random.uniform(k, (M, D, D)))(k_g))
    eps = torch.from_numpy(np.log(1.0 - u) - np.log(u))
    theta = torch.from_numpy(np.array(st.theta))
    zs = torch.from_numpy(np.array(st.z))
    x_t = torch.from_numpy(x)
    g_t = torch.from_numpy(g_ref).float()
    logp = port.likelihood_model.interventional_log_joint_prob(
        g_t, theta[:, None], x_t, torch.zeros_like(x_t), None)
    b = (logp.max(1).values + offset).float()
    want, _ = ref.est.eltwise_grad_z_likelihood(
        st.z, st.theta, jnp.asarray(b.numpy()), t, keys_lik)
    want = np.asarray(want)
    got, _ = port.est.eltwise_grad_z_likelihood(zs, theta, b, t, 0, 0,
                                                eps=eps)
    got = got.numpy()
    finite = np.isfinite(want).all(axis=(1, 2, 3))
    assert np.array_equal(np.isfinite(got).all(axis=(1, 2, 3)), finite)
    assert finite.all() == (offset < 0) and finite.any() == (offset < 0)
    if offset < 0:
        exact = _score_ratio_float64(port, zs, theta, b, g_t, x_t,
                                     ref.alpha(t))
        assert np.abs(got - exact).max() <= 1e-4 * np.abs(want).max()
