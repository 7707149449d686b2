"""The ``'spectral'`` acyclicity option against dibs_tpu on the CPU: the
penalty ``acyclic_constr_spectral`` (forward and Perron backward), the
latent-prior score that routes to it in both constraint modes, and 20
teacher-forced ``MarginalDiBS`` steps with the reference's noise injected
(the harness of ``tests/test_torch_svgd.py``).

Tolerances: the penalty and its gradient within 1e-5 (relative to the
largest entry, at least 1); ``phi`` within 1e-4 max|phi| per step, as the
other engine parity tests.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from dibs_tpu.inference import JointDiBS as JaxJointDiBS
from dibs_tpu.inference import MarginalDiBS as JaxMarginalDiBS
from dibs_tpu.inference.transport import marginal_transport as jax_transport
from dibs_tpu.models import BGe as JaxBGe
from dibs_tpu.models import ErdosReniDAGDistribution as JaxER
from dibs_tpu.models import ScaleFreeDAGDistribution as JaxSF
from dibs_tpu.ops.acyclic import acyclic_constr_spectral as jax_spectral
from dibs_tpu.target import make_linear_gaussian_equivalent_model as jax_data
from dibs_tpu.target import make_linear_gaussian_model as jax_joint_data
from dibs_tpu_torch.inference import JointDiBS, MarginalDiBS
from dibs_tpu_torch.interop import (
    bge_from_reference,
    linear_gaussian_from_reference,
    state_from_reference,
)
from dibs_tpu_torch.models import (
    ErdosReniDAGDistribution,
    ScaleFreeDAGDistribution,
)
from dibs_tpu_torch.ops.acyclic import acyclic_constr_spectral

torch.set_num_threads(1)

D, P, K_LAT, M, K_ACYC, N_OBS, STEPS = 8, 4, 6, 16, 8, 15, 20
MODES = ["sampled", "mean"]


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    bar = rel * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(np.asarray(got) - want).max()) <= bar


@pytest.mark.parametrize("d", [3, 8, 17])
def test_penalty_and_gradient_match_reference(d):
    rng = np.random.default_rng(d)
    gs = rng.uniform(size=(5, d, d)).astype(np.float32)
    gs *= 1 - np.eye(d, dtype=np.float32)
    g_t = torch.from_numpy(gs).requires_grad_(True)
    h = acyclic_constr_spectral(g_t)
    h_bar = torch.from_numpy(rng.normal(size=5).astype(np.float32))
    (grad,) = torch.autograd.grad(h, g_t, h_bar)

    ref_h = jax.vmap(jax_spectral)(jnp.asarray(gs))
    ref_grad = jax.vmap(
        lambda g, b: jax.grad(lambda m: b * jax_spectral(m))(g))(
            jnp.asarray(gs), jnp.asarray(h_bar.numpy()))
    _close(h.detach().numpy(), ref_h)
    _close(grad.numpy(), ref_grad)
    assert float(h.detach().min()) > 0.1  # dense positive graphs are cyclic


def test_dag_gives_zero_penalty():
    rng = np.random.default_rng(0)
    d = 10
    dag = np.triu(rng.uniform(size=(d, d)), 1).astype(np.float32)
    perm = rng.permutation(d)
    dag = dag[perm][:, perm]  # a DAG in another node order
    h = float(acyclic_constr_spectral(torch.from_numpy(dag)))
    assert abs(h) < 1e-4
    assert abs(h - float(jax_spectral(jnp.asarray(dag)))) < 1e-5
    cyc = dag.copy()
    cyc[perm[-1], perm[0]] = 1.0  # close a cycle through the order
    assert float(acyclic_constr_spectral(torch.from_numpy(cyc))) > 1e-3


@pytest.fixture(scope="module")
def problem():
    data, _, _ = jax_data(key=random.PRNGKey(7), n_vars=D,
                          graph_prior_str="er", n_observations=N_OBS)
    return np.array(data.x)


def _pair(x, mode):
    cfg = dict(acyclicity="spectral", acyclicity_constraint=mode,
               n_grad_mc_samples=M, n_acyclicity_mc_samples=K_ACYC)
    ref_model = JaxBGe(n_vars=D)
    ref = JaxMarginalDiBS(x=jnp.asarray(x), graph_model=JaxER(D),
                          likelihood_model=ref_model, **cfg)
    port = MarginalDiBS(
        x=torch.from_numpy(x), graph_model=ErdosReniDAGDistribution(D),
        likelihood_model=bge_from_reference(
            n_vars=D, mean_obs=np.asarray(ref_model.mean_obs),
            alpha_mu=ref_model.alpha_mu, alpha_lambd=ref_model.alpha_lambd,
            device="cpu"),
        device="cpu", **cfg)
    return ref, port


def _reference_run(ref, std):
    """The reference's states, pre-optimizer transports and Logistic noise
    for STEPS steps (its key schedule replayed as in test_torch_svgd)."""
    step = jax.jit(ref._make_step(std))

    @jax.jit
    def phi_and_noise(st):
        _, k_lik, k_prior = random.split(st.key, 3)
        keys_lik = random.split(k_lik, P)
        keys_prior = random.split(k_prior, P)
        dz_lik, _ = ref.est.eltwise_grad_z_likelihood(
            st.z, None, st.sf_baseline, st.t, keys_lik, x=ref.x,
            interv_mask=ref.interv_mask)
        dz_prior = ref.est.eltwise_grad_latent_prior(st.z, keys_prior, st.t,
                                                     std)
        phi = jax_transport(ref.kernel, st.z, dz_prior + dz_lik)
        noise = (random.logistic(keys_lik[0], (P, M, D, D)),
                 random.logistic(keys_prior[0], (P, K_ACYC, D, D)))
        return phi, noise

    state = ref.init_state(key=random.PRNGKey(3), n_particles=P,
                           n_dim_particles=K_LAT)
    out = []
    for _ in range(STEPS):
        phi, noise = phi_and_noise(state)
        out.append((state, np.asarray(phi),
                    tuple(torch.from_numpy(np.array(e)) for e in noise)))
        state = step(state)
    return out, state


def _to_port(st):
    return state_from_reference(z=st.z, nu=st.opt_state_z[0].nu,
                                sf_baseline=st.sf_baseline, t=st.t, seed=0,
                                device="cpu")


@pytest.mark.parametrize("mode", MODES)
def test_marginal_dibs_matches_reference_for_20_steps(problem, mode):
    ref, port = _pair(problem, mode)
    std = 1.0 / np.sqrt(K_LAT)
    run, ref_final = _reference_run(ref, std)

    phi_fn = port._make_phi(port._resolve_latent_std(K_LAT))
    for st, phi_ref, noise in run:
        with torch.no_grad():
            phi, _ = phi_fn(_to_port(st), noise)
        tol = 1e-4 * np.abs(phi_ref).max()
        err = np.abs(phi.numpy() - phi_ref).max()
        assert err <= tol, (mode, int(st.t), err, tol)

    state = _to_port(run[0][0])
    step = port._make_step(port._resolve_latent_std(K_LAT))
    for _, _, noise in run:
        state = step(state, noise)
    diff = np.abs(state.z.numpy() - np.asarray(ref_final.z))
    frac, mx = float((diff > 5e-5).mean()), float(diff.max())
    assert frac < 5e-3 and mx < 5e-3, (mode, frac, mx)


@pytest.mark.parametrize("mode", MODES)
def test_joint_prior_score_matches_reference(mode):
    """``JointDiBS``'s latent-prior score with the spectral penalty at a few
    steps of the annealing, from the same particles and soft-sample
    noise."""
    data, _, lm = jax_joint_data(key=random.PRNGKey(5), n_vars=D,
                                 graph_prior_str="sf", n_observations=10)
    cfg = dict(acyclicity="spectral", acyclicity_constraint=mode,
               n_grad_mc_samples=M, n_acyclicity_mc_samples=K_ACYC)
    ref = JaxJointDiBS(x=data.x, graph_model=JaxSF(D), likelihood_model=lm,
                       **cfg)
    port = JointDiBS(
        x=torch.from_numpy(np.array(data.x)),
        graph_model=ScaleFreeDAGDistribution(D),
        likelihood_model=linear_gaussian_from_reference(
            n_vars=D, obs_noise=lm.obs_noise, mean_edge=lm.mean_edge,
            sig_edge=lm.sig_edge, min_edge=lm.min_edge),
        device="cpu", **cfg)
    std = 1.0 / np.sqrt(K_LAT)
    z = np.array(random.normal(random.PRNGKey(1), (P, D, K_LAT, 2))) * std
    for t in (0, 5, 40):
        keys = random.split(random.PRNGKey(t), P)
        want = ref.est.eltwise_grad_latent_prior(jnp.asarray(z), keys, t, std)
        eps = torch.from_numpy(np.array(random.logistic(
            keys[0], (P, K_ACYC, D, D))))
        got = port.est.eltwise_grad_latent_prior(
            torch.from_numpy(z), t, 0, 0, std, eps=eps)
        _close(got.numpy(), want, rel=1e-4)


@pytest.mark.parametrize("mode", MODES)
def test_joint_dibs_runs_with_spectral(mode):
    data, _, lm = jax_joint_data(key=random.PRNGKey(5), n_vars=D,
                                 graph_prior_str="sf", n_observations=10)
    port = JointDiBS(
        x=torch.from_numpy(np.array(data.x)),
        graph_model=ScaleFreeDAGDistribution(D),
        likelihood_model=linear_gaussian_from_reference(
            n_vars=D, obs_noise=lm.obs_noise, mean_edge=lm.mean_edge,
            sig_edge=lm.sig_edge, min_edge=lm.min_edge),
        n_grad_mc_samples=M, n_acyclicity_mc_samples=K_ACYC,
        acyclicity="spectral", acyclicity_constraint=mode, device="cpu")
    g, theta, state = port.sample(seed=2, n_particles=P, steps=8,
                                  n_dim_particles=K_LAT, return_state=True)
    assert state.t == 8 and bool(torch.isfinite(state.z).all())
    assert g.shape == (P, D, D) and bool(torch.isfinite(theta).all())


def test_unknown_acyclicity_raises(problem):
    with pytest.raises(ValueError, match="'notears' or 'spectral'"):
        MarginalDiBS(x=torch.from_numpy(problem),
                     graph_model=ErdosReniDAGDistribution(D),
                     likelihood_model=bge_from_reference(
                         n_vars=D, mean_obs=np.zeros(D), alpha_mu=1.0,
                         alpha_lambd=D + 2, device="cpu"),
                     acyclicity="trace", device="cpu")
