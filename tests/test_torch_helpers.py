"""The public helpers of the port's ``DiBS`` (latent -> graph maps,
``log p(G | Z)`` and its gradient, the joint log-probabilities, Bernoulli
graph sampling, the plotting callback) against dibs_tpu on the CPU.

Tolerances: graphs exactly; log-probabilities and gradients within 1e-5
relative (float32, summed in another order); ``sample_g`` by its sample
means, within 5 standard errors of ``p``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from dibs_tpu.inference import JointDiBS as JaxJointDiBS
from dibs_tpu.inference import MarginalDiBS as JaxMarginalDiBS
from dibs_tpu.models import BGe as JaxBGe
from dibs_tpu.models import ErdosReniDAGDistribution as JaxER
from dibs_tpu.target import make_linear_gaussian_model
from dibs_tpu_torch.inference import JointDiBS, MarginalDiBS
from dibs_tpu_torch.interop import (
    bge_from_reference,
    linear_gaussian_from_reference,
)
from dibs_tpu_torch.models import (
    ErdosReniDAGDistribution,
    ScaleFreeDAGDistribution,
)

torch.set_num_threads(1)

D, K_LAT, M = 6, 4, 5


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape
    bar = rel * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= bar


@pytest.fixture(scope="module")
def joint_pair():
    data, gm, lm = make_linear_gaussian_model(
        key=random.PRNGKey(2), n_vars=D, graph_prior_str="sf",
        n_observations=10)
    ref = JaxJointDiBS(x=data.x, graph_model=gm, likelihood_model=lm)
    port = JointDiBS(
        x=torch.from_numpy(np.array(data.x)),
        graph_model=ScaleFreeDAGDistribution(D),
        likelihood_model=linear_gaussian_from_reference(
            n_vars=D, obs_noise=lm.obs_noise, mean_edge=lm.mean_edge,
            sig_edge=lm.sig_edge, min_edge=lm.min_edge), device="cpu")
    return ref, port, lm


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    z = rng.normal(size=(D, K_LAT, 2)).astype(np.float32)
    eps = rng.logistic(size=(M, D, D)).astype(np.float32)
    gs = (rng.uniform(size=(M, D, D)) < 0.4).astype(np.float32)
    gs *= 1 - np.eye(D, dtype=np.float32)
    return z, eps, gs


@pytest.mark.parametrize("t", [1, 40])
def test_latent_graph_maps_match_reference(joint_pair, inputs, t):
    ref, port, _ = joint_pair
    z, eps, gs = inputs
    zt, et, gt = (torch.from_numpy(a) for a in (z, eps, gs))
    _close(port.particle_to_soft_graph(zt, et, t),
           ref.particle_to_soft_graph(jnp.asarray(z), jnp.asarray(eps), t))
    np.testing.assert_array_equal(
        port.particle_to_hard_graph(zt, et, t).numpy(),
        ref.particle_to_hard_graph(jnp.asarray(z), jnp.asarray(eps), t))
    _close(port.latent_log_prob(gt[0], zt, t),
           ref.latent_log_prob(jnp.asarray(gs[0]), jnp.asarray(z), t))
    _close(port.eltwise_grad_latent_log_prob(gt, zt, t),
           ref.eltwise_grad_latent_log_prob(jnp.asarray(gs), jnp.asarray(z),
                                            t))


def test_joint_log_probabilities_match_reference(joint_pair, inputs):
    ref, port, lm = joint_pair
    z, eps, gs = inputs
    theta = np.array(lm.sample_parameters(key=random.PRNGKey(1), n_vars=D))
    _close(port.eltwise_log_joint_prob(torch.from_numpy(gs),
                                       torch.from_numpy(theta), None),
           ref.eltwise_log_joint_prob(jnp.asarray(gs), jnp.asarray(theta),
                                      None))
    _close(port.log_joint_prob_soft(torch.from_numpy(z),
                                    torch.from_numpy(theta),
                                    torch.from_numpy(eps[0]), 7, None),
           ref.log_joint_prob_soft(jnp.asarray(z), jnp.asarray(theta),
                                   jnp.asarray(eps[0]), 7, None))


def test_marginal_log_probabilities_match_reference(inputs):
    _, _, gs = inputs
    data, _, _ = make_linear_gaussian_model(
        key=random.PRNGKey(3), n_vars=D, graph_prior_str="er",
        n_observations=12)
    ref_model = JaxBGe(n_vars=D)
    ref = JaxMarginalDiBS(x=data.x, graph_model=JaxER(D),
                          likelihood_model=ref_model)
    port = MarginalDiBS(
        x=torch.from_numpy(np.array(data.x)),
        graph_model=ErdosReniDAGDistribution(D),
        likelihood_model=bge_from_reference(
            n_vars=D, mean_obs=np.asarray(ref_model.mean_obs),
            alpha_mu=ref_model.alpha_mu, alpha_lambd=ref_model.alpha_lambd,
            device="cpu"), device="cpu")
    want = ref.eltwise_log_joint_prob(jnp.asarray(gs), None, None)
    _close(port.eltwise_log_joint_prob(torch.from_numpy(gs), None, None),
           want, rel=1e-4)
    _close(port.log_joint_prob(torch.from_numpy(gs[0]), None, port.x,
                               port.interv_mask, None), want[0], rel=1e-4)


def test_sample_g_draws_bernoulli_graphs(joint_pair):
    _, port, _ = joint_pair
    rng = np.random.default_rng(5)
    p = torch.from_numpy(rng.uniform(size=(D, D)).astype(np.float32))
    n = 4000
    g = port.sample_g(p, torch.Generator().manual_seed(0), n)
    assert g.shape == (n, D, D) and g.dtype == torch.int32
    assert int(g.diagonal(dim1=-2, dim2=-1).abs().sum()) == 0
    off = ~torch.eye(D, dtype=torch.bool)
    se = torch.sqrt(p * (1 - p) / n).clamp(min=1e-6)
    z = ((g.float().mean(0) - p).abs() / se)[off]
    assert float(z.max()) < 5.0


def test_visualize_callback_runs_in_sample(joint_pair, tmp_path, capsys):
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    _, port, _ = joint_pair
    cb = port.visualize_callback(ipython=False, save_path=str(tmp_path))
    port.sample(seed=1, n_particles=3, steps=4, n_dim_particles=K_LAT,
                callback=cb, callback_every=2)
    printed = capsys.readouterr().out
    assert printed.count("iteration") == 2 and "#cyclic" in printed
    assert (tmp_path / "img2.png").exists() and (tmp_path / "img4.png").exists()
