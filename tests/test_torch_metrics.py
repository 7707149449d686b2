"""The port's evaluation surface against dibs_tpu on the CPU: CPDAGs and
PDAG-SHD (``ops/cpdag.py``), expected CPDAG-SHD and expected edges, both
held-out likelihoods (marginal BGe; joint linear and nonlinear, whose
parameters are trees), every cyclic-particle fallback, ``adjmat_to_str``
and ``visualize``.

Tolerances: the CPDAGs, SHDs and edge counts exactly; the metrics within
1e-5 relative (float32 weights, summed in another order); the held-out
likelihoods within 1e-4 relative (float32 scores of ~1e2-1e4 nats).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from dibs_tpu import metrics as jax_metrics
from dibs_tpu.inference import JointDiBS as JaxJointDiBS
from dibs_tpu.inference import MarginalDiBS as JaxMarginalDiBS
from dibs_tpu.models import BGe as JaxBGe
from dibs_tpu.models import ErdosReniDAGDistribution as JaxER
from dibs_tpu.ops import cpdag as jax_cpdag
from dibs_tpu.target import (
    make_linear_gaussian_equivalent_model,
    make_linear_gaussian_model,
    make_nonlinear_gaussian_model,
)
from dibs_tpu.utils.viz_text import adjmat_to_str as jax_adjmat_to_str
from dibs_tpu_torch import metrics
from dibs_tpu_torch.inference import JointDiBS, MarginalDiBS
from dibs_tpu_torch.interop import (
    bge_from_reference,
    linear_gaussian_from_reference,
    nonlinear_gaussian_from_reference,
    params_from_reference,
)
from dibs_tpu_torch.models import (
    ErdosReniDAGDistribution,
    ScaleFreeDAGDistribution,
)
from dibs_tpu_torch.ops import cpdag
from dibs_tpu_torch.utils.viz_text import adjmat_to_str

torch.set_num_threads(1)

D = 6


def _random_dag(rng, d, p_edge=0.4):
    a = np.triu(rng.uniform(size=(d, d)) < p_edge, 1).astype(np.int32)
    perm = rng.permutation(d)
    return a[perm][:, perm]


def _cyclic(rng, d):
    a = _random_dag(rng, d)
    i, j = rng.choice(d, size=2, replace=False)
    a[i, j] = a[j, i] = 1
    return a


def _particles(seed, n=7, n_cyclic=2, d=D):
    rng = np.random.default_rng(seed)
    gs = [_random_dag(rng, d) for _ in range(n - n_cyclic)]
    gs += [_cyclic(rng, d) for _ in range(n_cyclic)]
    g = np.stack(gs)[rng.permutation(n)]
    logp = rng.normal(size=n).astype(np.float32)
    return g, logp


def _dists(g, logp, theta_ref=None, theta_port=None):
    ref = jax_metrics.ParticleDistribution(
        logp=jnp.asarray(logp), g=jnp.asarray(g), theta=theta_ref)
    port = metrics.ParticleDistribution(
        logp=torch.from_numpy(logp), g=torch.from_numpy(g), theta=theta_port)
    return ref, port


def _rel_close(got, want, rel):
    assert abs(float(got) - float(want)) <= rel * max(1.0, abs(float(want)))


@pytest.mark.parametrize("seed", range(6))
def test_cpdag_and_pdag_shd_match_reference(seed):
    rng = np.random.default_rng(100 + seed)
    d = 4 + seed
    gs = np.stack([_random_dag(rng, d) for _ in range(5)])
    np.testing.assert_array_equal(cpdag.eltwise_dag_to_cpdag(gs),
                                  jax_cpdag.eltwise_dag_to_cpdag(gs))
    truth = _random_dag(rng, d)
    got = cpdag.dag_to_cpdag(torch.from_numpy(truth))
    np.testing.assert_array_equal(got, jax_cpdag.dag_to_cpdag(truth))
    pd = cpdag.eltwise_dag_to_cpdag(gs)
    np.testing.assert_array_equal(
        cpdag.pdag_shd(pd, got[None]),
        jax_cpdag.pdag_shd(pd, jax_cpdag.dag_to_cpdag(truth)[None]))
    with pytest.raises(ValueError, match="cyclic"):
        cpdag.dag_to_cpdag(_cyclic(rng, d))


@pytest.mark.parametrize("n_cyclic", [0, 3, 7])
def test_expected_cpdag_shd_and_edges_match_reference(n_cyclic):
    g, logp = _particles(seed=n_cyclic, n_cyclic=n_cyclic)
    truth = _random_dag(np.random.default_rng(9), D)
    ref, port = _dists(g, logp)
    _rel_close(metrics.expected_cpdag_shd(dist=port,
                                          g=torch.from_numpy(truth)),
               jax_metrics.expected_cpdag_shd(dist=ref,
                                              g=jnp.asarray(truth)), 1e-5)
    _rel_close(metrics.expected_edges(dist=port),
               jax_metrics.expected_edges(dist=ref), 1e-5)
    _rel_close(metrics.expected_shd(dist=port, g=torch.from_numpy(truth)),
               jax_metrics.expected_shd(dist=ref, g=jnp.asarray(truth)),
               1e-5)
    if n_cyclic == 7:  # every particle cyclic: the reference's fallbacks
        assert metrics.expected_cpdag_shd(
            dist=port, g=torch.from_numpy(truth)) == D * (D - 1) / 2


@pytest.fixture(scope="module")
def marginal_problem():
    data, _, _ = make_linear_gaussian_equivalent_model(
        key=random.PRNGKey(3), n_vars=D, graph_prior_str="er",
        n_observations=20, n_ho_observations=15)
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
    return np.array(data.x_ho), ref, port


@pytest.mark.parametrize("n_cyclic", [0, 2, 7])
def test_neg_ave_log_marginal_likelihood_matches_reference(marginal_problem,
                                                           n_cyclic):
    x_ho, ref, port = marginal_problem
    g, logp = _particles(seed=10 + n_cyclic, n_cyclic=n_cyclic)
    dist_ref, dist_port = _dists(g, logp)
    want = jax_metrics.neg_ave_log_marginal_likelihood(
        dist=dist_ref,
        eltwise_log_marginal_likelihood=ref.eltwise_log_marginal_likelihood_observ,
        x=jnp.asarray(x_ho))
    got = metrics.neg_ave_log_marginal_likelihood(
        dist=dist_port,
        eltwise_log_marginal_likelihood=port.eltwise_log_marginal_likelihood_observ,
        x=torch.from_numpy(x_ho))
    _rel_close(got, want, 1e-4)
    # the interventional closure with an empty mask is the observational one
    gs = torch.from_numpy(g)
    x_t = torch.from_numpy(x_ho)
    np.testing.assert_allclose(
        port.eltwise_log_marginal_likelihood_interv(
            gs, x_t, torch.zeros_like(x_t)).numpy(),
        port.eltwise_log_marginal_likelihood_observ(gs, x_t).numpy())


def _joint_pair(kind):
    factory = {"linear": make_linear_gaussian_model,
               "nonlinear": make_nonlinear_gaussian_model}[kind]
    kw = dict(hidden_layers=(3,)) if kind == "nonlinear" else {}
    data, gm, lm = factory(key=random.PRNGKey(4), n_vars=D,
                           graph_prior_str="sf", n_observations=12,
                           n_ho_observations=9, **kw)
    ref = JaxJointDiBS(x=data.x, graph_model=gm, likelihood_model=lm)
    if kind == "linear":
        port_lm = linear_gaussian_from_reference(
            n_vars=D, obs_noise=lm.obs_noise, mean_edge=lm.mean_edge,
            sig_edge=lm.sig_edge, min_edge=lm.min_edge)
    else:
        port_lm = nonlinear_gaussian_from_reference(
            n_vars=D, hidden_layers=lm.hidden_layers, obs_noise=lm.obs_noise,
            sig_param=lm.sig_param, activation=lm.activation, bias=lm.bias)
    port = JointDiBS(x=torch.from_numpy(np.array(data.x)),
                     graph_model=ScaleFreeDAGDistribution(D),
                     likelihood_model=port_lm, device="cpu")
    return np.array(data.x_ho), lm, ref, port


@pytest.mark.parametrize("n_cyclic", [0, 2, 7])
@pytest.mark.parametrize("kind", ["linear", "nonlinear"])
def test_neg_ave_log_likelihood_matches_reference(kind, n_cyclic):
    x_ho, lm, ref, port = _joint_pair(kind)
    g, logp = _particles(seed=20 + n_cyclic, n_cyclic=n_cyclic)
    theta = lm.sample_parameters(key=random.PRNGKey(6), n_particles=len(g),
                                 n_vars=D)
    dist_ref, dist_port = _dists(g, logp, theta_ref=theta,
                                 theta_port=params_from_reference(
                                     theta, device="cpu"))
    want = jax_metrics.neg_ave_log_likelihood(
        dist=dist_ref, eltwise_log_likelihood=ref.eltwise_log_likelihood_observ,
        x=jnp.asarray(x_ho))
    got = metrics.neg_ave_log_likelihood(
        dist=dist_port,
        eltwise_log_likelihood=port.eltwise_log_likelihood_observ,
        x=torch.from_numpy(x_ho))
    _rel_close(got, want, 1e-4)


def test_neg_ave_log_likelihood_needs_parameters():
    g, logp = _particles(seed=1)
    _, dist = _dists(g, logp)
    with pytest.raises(ValueError, match="theta"):
        metrics.neg_ave_log_likelihood(dist=dist,
                                       eltwise_log_likelihood=None,
                                       x=torch.zeros(3, D))


@pytest.mark.parametrize("seed", range(3))
def test_adjmat_to_str_matches_reference(seed):
    rng = np.random.default_rng(seed)
    mats = [_random_dag(rng, 7), _cyclic(rng, 7), np.zeros((4, 4), np.int32)]
    for mat in mats:
        for max_len in (10, 40, 400):
            assert (adjmat_to_str(torch.from_numpy(mat), max_len=max_len)
                    == jax_adjmat_to_str(mat, max_len=max_len))


def test_visualize_saves_and_returns_frames(tmp_path):
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    from dibs_tpu_torch.utils.visualize import visualize

    mats = torch.rand(9, 5, 5, generator=torch.Generator().manual_seed(0))
    img = visualize(mats, t=3, save_path=str(tmp_path))
    assert os.path.exists(tmp_path / "img3.png")
    assert img is not None and img.ndim == 3 and img.shape[-1] in (3, 4)
    assert visualize(mats[:3], t=1) is None
