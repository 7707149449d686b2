"""Port parity for JointDiBS with the MLP likelihood (DenseNonlinearGaussian,
one hidden layer) against dibs_tpu on the CPU, teacher-forced and
free-running for 20 steps under both sample-sharing settings.

On the CPU the reference takes its generic estimators (its Pallas kernel is
TPU-only); the port takes kernel #8's plain version, which computes the same
estimator. Both step from the same particles with the reference's noise
injected into the port, the reference's key schedule replayed as in
``tests/test_torch_joint.py``: per step ``split(state.key, 4)`` gives
``(key, k_theta, k_lik, k_prior)``; with ``'hard'`` sharing one
``random.logistic(k_lik, [P, M, d, d])`` serves both likelihood gradients,
with ``None`` the soft noise comes from ``split(k_lik, P)[0]`` and the hard
noise from ``split(k_theta, P)[0]``; the acyclicity noise from
``split(k_prior, P)[0]``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from dibs_tpu.inference import JointDiBS as JaxJointDiBS
from dibs_tpu.inference.transport import joint_transport as jax_joint_transport
from dibs_tpu.models import ScaleFreeDAGDistribution as JaxSF
from dibs_tpu.target import make_nonlinear_gaussian_model as jax_data
from dibs_tpu_torch.inference import JointDiBS
from dibs_tpu_torch.inference.estimators import make_estimators
from dibs_tpu_torch.interop import (
    nonlinear_gaussian_from_reference,
    state_from_reference,
)
from dibs_tpu_torch.models import ScaleFreeDAGDistribution
from dibs_tpu_torch.utils.tree import tree_leaves, tree_map

torch.set_num_threads(1)

# Small N and d: the reference scores log p(Theta, D | G) uncentred in
# float32, and MLP data puts |ll| far above the linear model's (its own
# note has ~1e6 per sample at d=20, N=100); its rounding then sets the
# limit of the comparison, as in tests/test_torch_joint.py (N=10 there).
D, H1, P, K_LAT, M, K_ACYC, N_OBS, STEPS = 6, 3, 4, 5, 16, 8, 8, 20
SHARING = {"hard": "hard", "separate": None}


@pytest.fixture(scope="module")
def problem():
    data, _, lm = jax_data(key=random.PRNGKey(7), n_vars=D,
                           hidden_layers=(H1,), n_observations=N_OBS)
    return np.array(data.x), lm


def _pair(x, lm, sharing, d=D):
    ref = JaxJointDiBS(x=jnp.asarray(x), graph_model=JaxSF(d),
                       likelihood_model=lm, n_grad_mc_samples=M,
                       n_acyclicity_mc_samples=K_ACYC,
                       fused_sample_sharing=sharing)
    port = JointDiBS(
        x=torch.from_numpy(x), graph_model=ScaleFreeDAGDistribution(d),
        likelihood_model=nonlinear_gaussian_from_reference(
            n_vars=d, hidden_layers=lm.hidden_layers,
            obs_noise=lm.obs_noise, sig_param=lm.sig_param,
            activation=lm.activation, bias=lm.bias),
        n_grad_mc_samples=M, n_acyclicity_mc_samples=K_ACYC,
        fused_sample_sharing=sharing, device="cpu")
    return ref, port


def _reference_run(ref, std, sharing, d=D):
    """The reference's STEPS steps: per step the state, the pre-optimizer
    transports and the Logistic noise its samplers drew."""
    step = jax.jit(ref._make_step(std))

    @jax.jit
    def phi_and_noise(st):
        _, k_theta, k_lik, k_prior = random.split(st.key, 4)
        keys_prior = random.split(k_prior, P)
        if sharing == "hard":
            dz_lik, dtheta = ref.est.fused_grad_both(st.z, st.theta, st.t,
                                                     k_lik)
            eps_soft = eps_hard = random.logistic(k_lik, (P, M, d, d))
        else:
            keys_theta = random.split(k_theta, P)
            keys_lik = random.split(k_lik, P)
            dtheta = ref.est.eltwise_grad_theta_likelihood(
                st.z, st.theta, st.t, keys_theta)
            dz_lik, _ = ref.est.eltwise_grad_z_likelihood(
                st.z, st.theta, st.sf_baseline, st.t, keys_lik)
            eps_soft = random.logistic(keys_lik[0], (P, M, d, d))
            eps_hard = random.logistic(keys_theta[0], (P, M, d, d))
        dz_prior = ref.est.eltwise_grad_latent_prior(st.z, keys_prior, st.t,
                                                     std)
        phi = jax_joint_transport(ref.kernel, st.z, st.theta,
                                  dz_prior + dz_lik, dtheta)
        eps_acyc = random.logistic(keys_prior[0], (P, K_ACYC, d, d))
        return phi, (eps_soft, eps_hard, eps_acyc)

    state = ref.init_state(key=random.PRNGKey(3), n_particles=P,
                           n_dim_particles=K_LAT)
    out = []
    for _ in range(STEPS):
        (phi_z, phi_t), noise = phi_and_noise(state)
        phi = [np.asarray(phi_z)] + [np.asarray(a) for a in
                                     jax.tree_util.tree_leaves(phi_t)]
        out.append((state, phi,
                    tuple(torch.from_numpy(np.array(e)) for e in noise)))
        state = step(state)
    return out, state


def _to_port(st):
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return state_from_reference(
        z=st.z, nu=st.opt_state_z[0].nu, sf_baseline=st.sf_baseline, t=st.t,
        seed=0, theta=tree(st.theta), nu_theta=tree(st.opt_state_theta[0].nu),
        device="cpu")


def _fraction_rule(ours, ref, name):
    diff = np.abs(ours - np.asarray(ref))
    frac, mx = float((diff > 5e-5).mean()), float(diff.max())
    assert frac < 5e-3 and mx < 5e-3, (name, frac, mx)


@pytest.mark.parametrize("sharing", list(SHARING))
def test_nonlinear_joint_dibs_matches_reference_for_20_steps(problem,
                                                             sharing):
    """Teacher-forced ``phi`` within 1e-4 max|phi| per component (Z and each
    parameter leaf) at every step; free-running, the fraction rule."""
    x, lm = problem
    ref, port = _pair(x, lm, SHARING[sharing])
    # the port takes kernel #8 (its plain version on the CPU)
    assert port.est.fused_grad_both is not None
    std = 1.0 / np.sqrt(K_LAT)
    run, ref_final = _reference_run(ref, std, SHARING[sharing])

    phi_fn = port._make_phi(port._resolve_latent_std(K_LAT))
    for st, phi_ref, noise in run:
        with torch.no_grad():
            phi_z, phi_t = phi_fn(_to_port(st), noise)
        got = [phi_z] + tree_leaves(phi_t)
        assert len(got) == len(phi_ref) == 5
        for k, (a, want) in enumerate(zip(got, phi_ref)):
            tol = 1e-4 * np.abs(want).max()
            err = np.abs(a.numpy() - want).max()
            assert err <= tol, (sharing, k, int(st.t), err, tol)

    state = _to_port(run[0][0])
    step = port._make_step(port._resolve_latent_std(K_LAT))
    for _, _, noise in run:
        state = step(state, noise)
    assert state.t == STEPS
    _fraction_rule(state.z.numpy(), ref_final.z, "z")
    for k, (a, want) in enumerate(zip(
            tree_leaves(state.theta),
            jax.tree_util.tree_leaves(ref_final.theta))):
        _fraction_rule(a.numpy(), want, f"theta leaf {k}")

    # the mixture on the same final particles
    g = np.asarray(ref.particle_to_g_lim(ref_final.z))
    mix = port.get_mixture(torch.from_numpy(g.copy()),
                           _to_port(ref_final).theta)
    mix_ref = ref.get_mixture(jnp.asarray(g), ref_final.theta)
    np.testing.assert_allclose(mix.logp.numpy(), mix_ref.logp, atol=1e-3)


@pytest.mark.slow
@pytest.mark.skipif(os.environ.get("DIBS_RUN_SLOW") != "1",
                    reason="slow probe of the reference's rounding; set "
                           "DIBS_RUN_SLOW=1")
def test_reference_float32_rounding_limits_parity_at_d8_n20():
    """Why the parity test above runs at d=6, N=8. At d=8, N=20 with
    separate noise streams, the reference's uncentred float32 scoring moves
    its d Theta further from a float64 evaluation of the same estimator (the
    port's generic estimator in float64, same noise) than the port's fused
    path is; prints the worst step."""
    data, _, lm = jax_data(key=random.PRNGKey(7), n_vars=8,
                           hidden_layers=(H1,), n_observations=20)
    x = np.array(data.x)
    ref, port = _pair(x, lm, None, d=8)
    run, _ = _reference_run(ref, 1.0 / np.sqrt(K_LAT), None, d=8)
    est64 = make_estimators(
        cfg=port.cfg, log_graph_prior=port.log_graph_prior,
        x=torch.from_numpy(x).double(),
        interv_mask=torch.zeros(x.shape, dtype=torch.float64),
        log_joint_prob=port.likelihood_model.interventional_log_joint_prob)
    worst, worst_phi = (0.0, None), 0.0
    phi_fn = port._make_phi(port._resolve_latent_std(K_LAT))
    for st, phi_ref, noise in run:
        sp = _to_port(st)
        with torch.no_grad():
            phi_z, phi_t = phi_fn(sp, noise)
        for a, want in zip([phi_z] + tree_leaves(phi_t), phi_ref):
            worst_phi = max(worst_phi, float(np.abs(a.numpy() - want).max())
                            / (1e-4 * float(np.abs(want).max())))
        k_theta = random.split(st.key, 4)[1]
        d_ref = ref.est.eltwise_grad_theta_likelihood(
            st.z, st.theta, st.t, random.split(k_theta, P))
        _, d_port = port.est.fused_grad_both(sp.z, sp.theta, sp.t, 0,
                                             (0, 1), eps=noise[:2])
        d_64 = est64.eltwise_grad_theta_likelihood(
            sp.z.double(), tree_map(lambda a: a.double(), sp.theta),
            sp.t, 0, 1, eps=noise[1].double())
        for k, (a, b, c) in enumerate(zip(
                jax.tree_util.tree_leaves(d_ref), tree_leaves(d_port),
                tree_leaves(d_64))):
            c = c.numpy()
            e_ref = float(np.abs(np.asarray(a) - c).max())
            e_port = float(np.abs(b.double().numpy() - c).max())
            scale = float(np.abs(c).max())
            if e_ref / scale > worst[0]:
                worst = (e_ref / scale, (int(st.t), k, e_ref, e_port,
                                         scale))
    print("teacher-forced phi, port vs reference: worst", worst_phi,
          "of the 1e-4 max|phi| bar; worst reference |d Theta - float64| "
          "(t, leaf, reference, port, max|float64|):", worst[1])
    assert worst[1][3] < worst[1][2]


@pytest.mark.slow
@pytest.mark.skipif(os.environ.get("DIBS_RUN_SLOW") != "1",
                    reason="slow end-to-end quality run; set DIBS_RUN_SLOW=1")
def test_port_quality_matches_reference_reduced():
    """Both packages on the reference's own nonlinear data (d=10, N=100,
    P=10, 400 steps, defaults otherwise), seeds 0-2, each with its own
    noise: the port's mean AUROCs are no worse than the reference's by more
    than 0.1. Prints every run."""
    from dibs_tpu.metrics import threshold_metrics as jax_metrics
    from dibs_tpu_torch.metrics import threshold_metrics

    d, p, steps = 10, 10, 400
    ref_auc, port_auc = [], []
    for seed in range(3):
        data, gm, lm = jax_data(key=random.PRNGKey(seed), n_vars=d)
        ref = JaxJointDiBS(x=data.x, graph_model=gm, likelihood_model=lm)
        gs, th = ref.sample(key=random.PRNGKey(seed + 10), n_particles=p,
                            steps=steps)
        ref_auc.append([jax_metrics(dist=dist, g=data.g)["roc_auc"]
                        for dist in (ref.get_empirical(gs, th),
                                     ref.get_mixture(gs, th))])
        port = JointDiBS(
            x=torch.from_numpy(np.array(data.x)),
            graph_model=ScaleFreeDAGDistribution(d),
            likelihood_model=nonlinear_gaussian_from_reference(
                n_vars=d, hidden_layers=lm.hidden_layers,
                obs_noise=lm.obs_noise, sig_param=lm.sig_param),
            device="cpu")
        g, theta = port.sample(seed=seed + 10, n_particles=p, steps=steps)
        g_true = torch.from_numpy(np.array(data.g))
        port_auc.append([threshold_metrics(dist=dist, g=g_true)["roc_auc"]
                         for dist in (port.get_empirical(g, theta),
                                      port.get_mixture(g, theta))])
        print(f"seed {seed}: AUROC empirical / mixture, reference "
              f"{ref_auc[-1]}, port {port_auc[-1]}")
    ref_mean, port_mean = np.mean(ref_auc, 0), np.mean(port_auc, 0)
    print("means (empirical, mixture): reference", ref_mean, "port",
          port_mean)
    assert np.all(port_mean >= ref_mean - 0.1)
