"""The public helpers of the port's ``DiBS`` (latent -> graph maps,
``log p(G | Z)`` and its gradient, the joint log-probabilities, Bernoulli
graph sampling, the plotting callback, the keyword arguments ``sample``
hands its callback, the constructors' defaults) against dibs_tpu on the CPU.

Tolerances: graphs exactly; log-probabilities and gradients within 1e-5
relative (float32, summed in another order); ``sample_g`` by its sample
means, within 5 standard errors of ``p``.
"""
import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from dibs_tpu import target as jax_target
from dibs_tpu.inference import JointDiBS as JaxJointDiBS
from dibs_tpu.inference import MarginalDiBS as JaxMarginalDiBS
from dibs_tpu.inference.estimators import EstimatorConfig as JaxEstimatorConfig
from dibs_tpu.inference.svgd import DiBS as JaxDiBS
from dibs_tpu.models import BGe as JaxBGe
from dibs_tpu.models import ErdosReniDAGDistribution as JaxER
from dibs_tpu.target import make_linear_gaussian_model
from dibs_tpu_torch import target as port_target
from dibs_tpu_torch.inference import EstimatorConfig, JointDiBS, MarginalDiBS
from dibs_tpu_torch.inference.svgd import DiBS
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


def _callback_keys(joint, port):
    """The keyword sets each ``sample`` callback receives at n_vars=5,
    N=20, P=3, 2 steps, a callback every step, and the type of ``t``."""
    seen = []

    def callback(**kwargs):
        seen.append((tuple(sorted(kwargs)), type(kwargs["t"])))

    kw = dict(n_vars=5, n_observations=20)
    make = ("make_linear_gaussian_model" if joint
            else "make_linear_gaussian_equivalent_model")
    if port:
        data, gm, lm = getattr(port_target, make)(
            generator=torch.Generator().manual_seed(0), device="cpu", **kw)
        cls, extra, run = (JointDiBS if joint else MarginalDiBS,
                           dict(device="cpu"), dict(seed=1))
    else:
        data, gm, lm = getattr(jax_target, make)(key=random.PRNGKey(0), **kw)
        cls, extra, run = (JaxJointDiBS if joint else JaxMarginalDiBS, {},
                           dict(key=random.PRNGKey(1)))
    dibs = cls(x=data.x, graph_model=gm, likelihood_model=lm,
               n_grad_mc_samples=4, n_acyclicity_mc_samples=2, **extra)
    dibs.sample(n_particles=3, steps=2, callback=callback, callback_every=1,
                **run)
    return seen


@pytest.mark.parametrize("joint", [False, True])
def test_sample_callback_gets_the_reference_keywords(joint):
    """The joint engine hands its callback ``thetas`` beside ``zs``, and
    ``t`` is a Python int, as in the reference."""
    want = sorted({"dibs", "t", "zs"} | ({"thetas"} if joint else set()))
    ref = _callback_keys(joint, port=False)
    assert ref == [(tuple(want), int)] * 2
    assert _callback_keys(joint, port=True) == ref


def _defaults(fn):
    """Keyword defaults of ``fn``; a class default (the SVGD kernel) by its
    name, as each package has its own class."""
    return {name: (par.default.__name__ if inspect.isclass(par.default)
                   else par.default)
            for name, par in inspect.signature(fn).parameters.items()
            if par.default is not inspect.Parameter.empty}


@pytest.mark.parametrize("port_cls, ref_cls", [
    (DiBS, JaxDiBS), (MarginalDiBS, JaxMarginalDiBS),
    (JointDiBS, JaxJointDiBS)], ids=["DiBS", "MarginalDiBS", "JointDiBS"])
def test_constructor_defaults_match_reference(port_cls, ref_cls):
    """Every keyword both constructors take has the reference's default
    (the port's ``device`` and the reference's sharding options are their
    own; the kernel class is compared by name)."""
    port, ref = _defaults(port_cls.__init__), _defaults(ref_cls.__init__)
    shared = sorted(set(port) & set(ref))
    assert "grad_estimator_z" in shared
    assert {k: port[k] for k in shared} == {k: ref[k] for k in shared}


def test_estimator_config_defaults_match_reference():
    def fields(cls):
        return {f.name: f.default for f in dataclasses.fields(cls)}

    port, ref = fields(EstimatorConfig), fields(JaxEstimatorConfig)
    assert port["grad_estimator_z"] == "reparam"
    shared = sorted(set(port) & set(ref))
    assert {k: port[k] for k in shared} == {k: ref[k] for k in shared}
