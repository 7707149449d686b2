"""Port parity: the BGe marginal likelihood, the data factory and the
reference-state carry-over, against dibs_tpu on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import vmap

from dibs_tpu.models.linear_gaussian import BGe as JaxBGe
from dibs_tpu_torch.interop import bge_from_reference
from dibs_tpu_torch.models.linear_gaussian import BGe, LinearGaussian
from dibs_tpu_torch.ops.acyclic import elwise_acyclic_constr
from dibs_tpu_torch.target import make_linear_gaussian_equivalent_model

torch.set_num_threads(1)


def _case(d, n, b, interventional, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    interv = ((rng.uniform(size=x.shape) < 0.2) if interventional
              else np.zeros(x.shape, bool)).astype(np.int32)
    if interventional:
        interv[:, 0] = 1  # a node with no rows left scores 0
    gs = (rng.uniform(size=(b, d, d)) < 0.35).astype(np.float32)
    gs *= 1.0 - np.eye(d, dtype=np.float32)
    return x, interv, gs


@pytest.mark.parametrize("interventional", [False, True])
def test_posterior_r_mats_match_reference(interventional):
    x, interv, _ = _case(7, 25, 1, interventional, seed=1)
    r, n = BGe(n_vars=7)._posterior_r_mats(torch.from_numpy(x),
                                           torch.from_numpy(interv))
    r_ref, n_ref = JaxBGe(n_vars=7)._posterior_r_mats(jnp.asarray(x),
                                                      jnp.asarray(interv))
    np.testing.assert_allclose(r.numpy(), r_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(n.numpy(), n_ref)


@pytest.mark.parametrize("interventional", [False, True])
def test_batched_node_scores_match_reference(interventional):
    d = 9
    x, interv, gs = _case(d, 30, 14, interventional, seed=2)
    ours = BGe(n_vars=d).batched_interventional_node_log_marginal_probs(
        torch.from_numpy(gs), None, torch.from_numpy(x),
        torch.from_numpy(interv), None)
    model = JaxBGe(n_vars=d)
    ref = vmap(lambda g: model.node_log_marginal_likelihoods(
        g=g, x=jnp.asarray(x), interv_targets=jnp.asarray(interv)))(
        jnp.asarray(gs))
    assert ours.shape == (14, d) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-4, atol=1e-4)
    if interventional:
        assert torch.equal(ours[:, 0], torch.zeros(14))
    single = BGe(n_vars=d).interventional_log_marginal_prob(
        torch.from_numpy(gs[3]), None, torch.from_numpy(x),
        torch.from_numpy(interv), None)
    np.testing.assert_allclose(float(single), float(ref[3].sum()), rtol=1e-4)


@pytest.mark.parametrize("interventional", [False, True])
def test_per_graph_path_matches_batched_path(interventional):
    d = 7
    x, interv, gs = _case(d, 25, 4, interventional, seed=6)
    model = BGe(n_vars=d)
    x_t, i_t = torch.from_numpy(x), torch.from_numpy(interv)
    batched = model.batched_node_log_marginal_likelihoods(
        gs=torch.from_numpy(gs), x=x_t, interv_targets=i_t)
    for b in range(4):
        single = model.interventional_node_log_marginal_probs(
            torch.from_numpy(gs[b]), None, x_t, i_t, None)
        np.testing.assert_allclose(single.numpy(), batched[b].numpy(),
                                   rtol=1e-4, atol=1e-4)


def test_hyperparameters_carry_over_from_reference():
    d = 6
    x, interv, gs = _case(d, 20, 5, False, seed=3)
    mean_obs = np.linspace(-0.5, 0.5, d).astype(np.float32)
    ref_model = JaxBGe(n_vars=d, mean_obs=jnp.asarray(mean_obs), alpha_mu=2.0,
                       alpha_lambd=d + 5.0)
    model = bge_from_reference(n_vars=d, mean_obs=mean_obs,
                               alpha_mu=ref_model.alpha_mu,
                               alpha_lambd=ref_model.alpha_lambd)
    ours = model.batched_node_log_marginal_likelihoods(
        gs=torch.from_numpy(gs), x=torch.from_numpy(x),
        interv_targets=torch.from_numpy(interv))
    ref = ref_model.batched_node_log_marginal_likelihoods(
        gs=jnp.asarray(gs), x=jnp.asarray(x),
        interv_targets=jnp.asarray(interv))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError):
        BGe(n_vars=d, alpha_lambd=d + 1)


def test_data_factory_builds_a_valid_problem():
    gen = torch.Generator().manual_seed(4)
    data, gm, lm = make_linear_gaussian_equivalent_model(
        generator=gen, n_vars=10, graph_prior_str="er", n_observations=30,
        n_ho_observations=20)
    assert data.x.shape == (30, 10) and data.x_ho.shape == (20, 10)
    assert data.g.dtype == torch.int32
    assert float(elwise_acyclic_constr(data.g[None].float(), 10)[0]) == 0.0
    assert (data.theta.abs() >= 0.5).all()
    assert torch.isfinite(data.x).all()
    assert len(data.x_interv) == 10
    interv, x_i = data.x_interv[0]
    assert len(interv) == 1 and (x_i[:, list(interv)[0]] == 0).all()
    assert isinstance(lm, BGe) and gm.n_vars == 10
    with pytest.raises(NotImplementedError):
        make_linear_gaussian_equivalent_model(generator=gen, n_vars=5,
                                              graph_prior_str="sf")


def test_ancestral_sampling_solves_the_sem():
    d, n = 6, 40
    g = torch.triu(torch.ones(d, d, dtype=torch.int32), diagonal=1)
    gen = torch.Generator().manual_seed(5)
    model = LinearGaussian(n_vars=d)
    theta = model.sample_parameters(generator=gen, n_vars=d)
    state = gen.get_state()
    x = model.sample_obs(generator=gen, n_samples=n, g=g, theta=theta)
    gen.set_state(state)
    z = np.sqrt(0.1) * torch.randn((n, d), generator=gen)
    np.testing.assert_allclose(x.numpy(), (x @ (g * theta) + z).numpy(),
                               atol=1e-4)
