"""Port parity for kernel #8's plain version (the fused MLP sample-and-score
estimators): against dibs_tpu's fused_nonlinear_estimators (Pallas interpret
mode with injected uniforms), against the port's generic autograd
estimators, its shape gate and its CPU dispatch.

Noise mapping (as ``tests/test_torch_fused_linear.py``): the reference
kernel draws soft samples from uniforms ``u0`` and hard samples as ``u1 <
sigmoid(alpha s)``; the port gets ``eps_soft = logit(u0)`` and ``eps_hard =
logit(1 - u1)``. The uniforms of sample ``m`` sit in the reference's wide
layout at group ``m // bm``, lane block ``m % bm``, with ``d`` padded to
``dp`` (d=10 -> dp=16 here).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from dibs_tpu.inference.fused_nonlinear import _pad_plan_nl
from dibs_tpu.inference.fused_nonlinear import (
    fused_nonlinear_estimators as jax_fused_nonlinear,
)
from dibs_tpu.models import DenseNonlinearGaussian as JaxMLP
from dibs_tpu_torch.inference import fused_nonlinear as fnl
from dibs_tpu_torch.inference.estimators import EstimatorConfig, make_estimators
from dibs_tpu_torch.interop import (
    nonlinear_gaussian_from_reference,
    params_from_reference,
)
from dibs_tpu_torch.models import DenseNonlinearGaussian, ErdosReniDAGDistribution
from dibs_tpu_torch.ops import gpu_kernels as gk
from dibs_tpu_torch.ops.edges import edge_scores
from dibs_tpu_torch.utils.tree import tree_leaves, tree_map

torch.set_num_threads(1)

D, H1, P, M, ALPHA, N_OBS = 10, 3, 2, 20, 1.7, 12


def _inputs(seed, activation="relu"):
    kw = dict(n_vars=D, hidden_layers=(H1,), obs_noise=0.3, sig_param=1.2,
              activation=activation)
    ref_model = JaxMLP(**kw)
    theta = ref_model.sample_parameters(key=random.PRNGKey(seed), n_vars=D,
                                        n_particles=P)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N_OBS, D)).astype(np.float32)
    interv = (rng.uniform(size=x.shape) < 0.2).astype(np.int32)
    zs = (0.7 * rng.normal(size=(P, D, D, 2))).astype(np.float32)
    return (rng, ref_model, nonlinear_gaussian_from_reference(**kw), theta,
            x, interv, zs)


def _port_kwargs(model, theta, x, interv, zs):
    return dict(zs=torch.from_numpy(zs),
                thetas=params_from_reference(
                    jax.tree_util.tree_map(np.asarray, theta), device="cpu"),
                x=torch.from_numpy(x), interv_mask=torch.from_numpy(interv),
                model=model)


@pytest.mark.parametrize("tau", [1.0, 0.7])
@pytest.mark.parametrize("activation", ["relu", "tanh", "sigmoid",
                                        "leakyrelu"])
def test_plain_fused_matches_reference_kernel(activation, tau):
    """Bar 1e-4 max(1, max|ref|) per output leaf; measured worst 0.026 of
    it (sigmoid)."""
    rng, ref_model, model, theta, x, interv, zs = _inputs(0, activation)
    dp, bm, m_total = _pad_plan_nl(D, M)
    uniforms = rng.uniform(1e-4, 1.0 - 1e-4, size=(
        P, 2, (m_total // bm) * dp, bm * dp)).astype(np.float32)
    ref = jax_fused_nonlinear(
        zs=jnp.asarray(zs), thetas=theta, x=jnp.asarray(x),
        interv_mask=jnp.asarray(interv), key=random.PRNGKey(7), alpha=ALPHA,
        tau=tau, n_samples=M, model=ref_model, interpret=True,
        debug_noise=jnp.asarray(uniforms))

    def blocks(which):
        out = np.empty((P, M, D, D), np.float32)
        for m in range(M):
            grp, loc = divmod(m, bm)
            out[:, m] = uniforms[:, which, grp * dp:(grp + 1) * dp,
                                 loc * dp:(loc + 1) * dp][:, :D, :D]
        return out

    u0, u1 = blocks(0), blocks(1)
    eps = (torch.from_numpy(np.log(u0) - np.log1p(-u0)),
           torch.from_numpy(np.log1p(-u1) - np.log(u1)))
    dscores, dtheta = fnl.fused_nonlinear_estimators(
        **_port_kwargs(model, theta, x, interv, zs), seed=0, streams=(0, 1),
        alpha=ALPHA, tau=tau, n_samples=M, eps=eps)
    got = [dscores] + tree_leaves(dtheta)
    want = [ref[0]] + jax.tree_util.tree_leaves(ref[1])
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.shape == b.shape
        tol = 1e-4 * max(1.0, float(np.abs(b).max()))
        assert np.abs(a.numpy() - b).max() < tol


@pytest.mark.parametrize("activation,sharing", [
    ("relu", None), ("relu", "hard"), ("tanh", "hard"), ("leakyrelu", None)])
def test_fused_path_matches_generic_autograd_estimators(activation, sharing):
    """``fused_grad_both`` (the plain #8) against the generic reparam and
    Theta estimators (autograd through the model) on the same Philox noise,
    bar 1e-4 max(1, max|ref|); with 'hard' sharing the Theta samples are the
    thresholds of the soft samples' noise."""
    _, _, model, theta, x, interv, zs = _inputs(3, activation)
    kw = _port_kwargs(model, theta, x, interv, zs)
    common = dict(cfg=EstimatorConfig(grad_estimator_z="reparam",
                                      n_grad_mc_samples=M, tau=0.8),
                  log_graph_prior=ErdosReniDAGDistribution(
                      D, 1).unnormalized_log_prob_soft,
                  x=kw["x"], interv_mask=kw["interv_mask"],
                  log_joint_prob=model.interventional_log_joint_prob)
    fused = make_estimators(**common, fused_nonlinear_model=model,
                            fused_sample_sharing=sharing)
    generic = make_estimators(**common, fused_sample_sharing=sharing)
    z_t, th_t = kw["zs"], kw["thetas"]
    t, streams = 30, (6, 6 if sharing == "hard" else 7)
    dz, dtheta = fused.fused_grad_both(z_t, th_t, t, 13, streams)
    if sharing == "hard":
        dz_g, dtheta_g = generic.fused_grad_both(z_t, th_t, t, 13, streams)
    else:
        assert generic.fused_grad_both is None
        dz_g, _ = generic.eltwise_grad_z_likelihood(z_t, th_t, None, t, 13,
                                                     streams[0])
        dtheta_g = generic.eltwise_grad_theta_likelihood(z_t, th_t, t, 13,
                                                         streams[1])
    for got, want in zip([dz] + tree_leaves(dtheta),
                         [dz_g] + tree_leaves(dtheta_g)):
        tol = 1e-4 * max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) < tol


def test_philox_noise_is_the_injected_noise_of_the_kernels_streams():
    _, _, model, theta, x, interv, zs = _inputs(2)
    kw = dict(**_port_kwargs(model, theta, x, interv, zs), alpha=0.9,
              tau=1.0, n_samples=M)
    eps = []
    for stream in (5, 6):
        u = gk.philox_uniform((P, M, D, D), 21, stream, "cpu")
        eps.append(torch.log(u) - torch.log1p(-u))
    drawn = fnl.fused_nonlinear_estimators(**kw, seed=21, streams=(5, 6))
    injected = fnl.fused_nonlinear_estimators(**kw, seed=0, streams=(0, 0),
                                              eps=tuple(eps))
    for a, b in zip(tree_leaves(list(drawn)), tree_leaves(list(injected))):
        assert torch.equal(a, b)


def test_kernel_layout_round_trips_the_parameter_tree():
    _, _, model, theta, _, _, _ = _inputs(4)
    th = params_from_reference(jax.tree_util.tree_map(np.asarray, theta),
                               device="cpu")
    w1t, l1, b1t, w2t = fnl.kernel_layout(th, model)
    (w1, b1), (w2, b2) = th
    assert w1t.shape == (P, H1, D, D) and l1.shape == (P, D, D)
    assert torch.equal(w1t[1, 2, 3, 4], w1[1, 4, 3, 2])
    assert torch.equal(b1t[1, 2], b1[1, :, 2])
    assert torch.equal(w2t[0, H1], b2[0, :, 0])
    assert torch.equal(w2t[0, 1], w2[0, :, 1, 0])
    lp = -0.5 * (w1[1, 4, 3] / 1.2) ** 2 - np.log(1.2) - 0.5 * np.log(2 * np.pi)
    np.testing.assert_allclose(l1[1, 3, 4].item(), lp.sum().item(), rtol=1e-6)


def test_gate_follows_the_kernel_footprint_and_names_its_reason():
    cfg3 = DenseNonlinearGaussian(n_vars=20, hidden_layers=(5,))
    assert fnl.fused_nonlinear_available(cfg3, 100)
    # config 3: 25-row tiles let two blocks share an SM
    assert fnl.fused_nonlinear_tile_rows(20, 5, 100) == 25
    assert fnl.fused_nonlinear_smem_bytes(20, 5, 25) <= 115712
    # d=30, N=600: one block per SM, 32-row tiles
    assert fnl.fused_nonlinear_tile_rows(30, 5, 600) == 32
    assert 115712 < fnl.fused_nonlinear_smem_bytes(30, 5, 32) <= 232448
    assert fnl.fused_nonlinear_smem_bytes(20, 5, 25) == 144 + 4 * (
        32 * 400 + 16 * 20 + 8 * 500 + max(10 * 500, 11 * 12 * 20))
    wide = DenseNonlinearGaussian(n_vars=60, hidden_layers=(5,))
    assert fnl.fused_nonlinear_tile_rows(60, 5, 100) is None
    cases = [
        (wide, "shared memory"),
        (DenseNonlinearGaussian(n_vars=8, hidden_layers=(4, 3)),
         "one hidden layer"),
        (DenseNonlinearGaussian(n_vars=8, hidden_layers=(5,), bias=False),
         "bias=False"),
        (DenseNonlinearGaussian(n_vars=8, hidden_layers=(17,)),
         "register arrays"),
    ]
    for model, reason in cases:
        assert not fnl.fused_nonlinear_available(model, 100)
        assert reason in fnl.fused_nonlinear_decline_reason(model, 100)
        x = torch.zeros((4, model.n_vars))
        with pytest.warns(UserWarning, match=reason):
            est = make_estimators(
                cfg=EstimatorConfig(grad_estimator_z="reparam"),
                log_graph_prior=ErdosReniDAGDistribution(
                    model.n_vars, 1).unnormalized_log_prob_soft,
                x=x, interv_mask=torch.zeros_like(x),
                log_joint_prob=model.interventional_log_joint_prob,
                fused_nonlinear_model=model)
        assert est.fused_grad_both is None


def test_data_scale_advice_warns_only_and_changes_no_path():
    model = DenseNonlinearGaussian(n_vars=4, hidden_layers=(3,))
    common = dict(cfg=EstimatorConfig(grad_estimator_z="reparam"),
                  log_graph_prior=ErdosReniDAGDistribution(
                      4, 1).unnormalized_log_prob_soft,
                  log_joint_prob=model.interventional_log_joint_prob,
                  fused_nonlinear_model=model)
    x = torch.full((100, 4), 40.0)  # 100 * 4 * 1600 / 0.2 = 3.2e6
    with pytest.warns(UserWarning, match="data scale"):
        est = make_estimators(**common, x=x, interv_mask=torch.zeros_like(x))
    assert est.fused_grad_both is not None


def test_wrapper_takes_the_plain_version_on_the_cpu():
    _, _, model, theta, x, interv, zs = _inputs(5, "tanh")
    kw = _port_kwargs(model, theta, x, interv, zs)
    scores = edge_scores(kw["zs"]).contiguous()
    w = 1.0 - kw["interv_mask"].float()
    args = (scores, *fnl.kernel_layout(kw["thetas"], model), kw["x"], w)
    opts = dict(seed=3, streams=(1, 2), alpha=0.5, tau=1.0, n_samples=M,
                model=model)
    before = dict(gk.LAUNCHES)
    got = fnl.fused_nonlinear(*args, **opts)
    want = fnl.fused_nonlinear_plain(*args, **opts)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[0].shape == (P, D, D) and got[1].shape == (P, H1, D, D)
    assert got[2].shape == (P, 2 * H1 + 1, D)
    assert gk.LAUNCHES == before
    routed = fnl.fused_nonlinear_estimators(**kw, seed=3, streams=(1, 2),
                                            alpha=0.5, tau=1.0, n_samples=M)
    assert torch.equal(routed[0], want[0])
    assert gk.LAUNCHES == before
    assert tree_map(lambda a: a.shape, routed[1]) == tree_map(
        lambda a: a.shape, kw["thetas"])
