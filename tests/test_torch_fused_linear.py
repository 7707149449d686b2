"""Port parity for the fused linear-Gaussian estimators: the plain versions of
kernels #5-#7 against dibs_tpu's fused_linear_estimators (Pallas interpret
mode with injected uniforms), against each other, and against the port's
generic autograd estimators.

Noise mapping: the reference kernel draws soft samples from uniforms ``u0``
(``sigmoid(logit(u0) + alpha s)``) and hard samples as ``u1 < sigmoid(alpha
s)``; the port's convention is ``hard = 1[eps + alpha s > 0]``, so it gets
``eps_soft = logit(u0)`` and ``eps_hard = logit(1 - u1)``. The uniforms of
sample ``m`` sit in the reference's wide layout at group ``m // bm``, lane
block ``m % bm`` (``tests/test_fused_linear.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from dibs_tpu.inference.fused_linear import _pad_plan
from dibs_tpu.inference.fused_linear import (
    fused_linear_estimators as jax_fused_linear,
)
from dibs_tpu.models import LinearGaussian as JaxLinearGaussian
from dibs_tpu_torch.inference import fused_linear as fl
from dibs_tpu_torch.inference.estimators import EstimatorConfig, make_estimators
from dibs_tpu_torch.models import ErdosReniDAGDistribution, LinearGaussian
from dibs_tpu_torch.ops import gpu_kernels as gk

torch.set_num_threads(1)

D, P, M, ALPHA, N_OBS = 6, 2, 20, 1.7, 12


def _inputs(seed, scale):
    rng = np.random.default_rng(seed)
    thetas = rng.normal(size=(P, D, D)).astype(np.float32)
    x = (rng.normal(size=(N_OBS, D)) * scale).astype(np.float32)
    interv = (rng.uniform(size=x.shape) < 0.2).astype(np.int32)
    zs = (0.7 * rng.normal(size=(P, D, D, 2))).astype(np.float32)
    return rng, thetas, x, interv, zs


def _port_kwargs(thetas, x, interv, zs):
    return dict(zs=torch.from_numpy(zs), thetas=torch.from_numpy(thetas),
                x=torch.from_numpy(x), interv_mask=torch.from_numpy(interv),
                model=LinearGaussian(n_vars=D, obs_noise=0.1))


@pytest.mark.parametrize("single_pass", [True, False])
@pytest.mark.parametrize("tau,scale", [(1.0, 1.0), (1.0, 10.0), (0.7, 1.0)])
def test_plain_fused_matches_reference_kernel(tau, scale, single_pass):
    rng, thetas, x, interv, zs = _inputs(0, scale)
    dp, bm, m_total = _pad_plan(D, M)
    uniforms = rng.uniform(1e-4, 1.0 - 1e-4, size=(
        P, 2, (m_total // bm) * dp, bm * dp)).astype(np.float32)
    ref = jax_fused_linear(
        zs=jnp.asarray(zs), thetas=jnp.asarray(thetas), x=jnp.asarray(x),
        interv_mask=jnp.asarray(interv), key=random.PRNGKey(7), alpha=ALPHA,
        tau=tau, n_samples=M, model=JaxLinearGaussian(n_vars=D,
                                                      obs_noise=0.1),
        interpret=True, debug_noise=jnp.asarray(uniforms),
        single_pass=single_pass)

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
    ours = fl.fused_linear_estimators(
        **_port_kwargs(thetas, x, interv, zs), seed=0, streams=(0, 1),
        alpha=ALPHA, tau=tau, n_samples=M, eps=eps, single_pass=single_pass)
    for got, want in zip(ours, ref):
        want = np.asarray(want)
        tol = 1e-4 * max(1.0, float(np.abs(want).max()))
        assert np.abs(got.numpy() - want).max() < tol


@pytest.mark.parametrize("streams", [(3, 4), (3, 3)])
def test_single_and_two_pass_plain_versions_agree(streams):
    _, thetas, x, interv, zs = _inputs(1, 1.0)
    kw = dict(**_port_kwargs(thetas, x, interv, zs), seed=11,
              streams=streams, alpha=0.9, tau=1.0, n_samples=40)
    single = fl.fused_linear_estimators_plain(**kw, single_pass=True)
    two = fl.fused_linear_estimators_plain(**kw, single_pass=False)
    for a, b in zip(single, two):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()))


def test_philox_noise_is_the_injected_noise_of_the_kernels_streams():
    _, thetas, x, interv, zs = _inputs(2, 1.0)
    kw = dict(**_port_kwargs(thetas, x, interv, zs), alpha=0.9, tau=1.0,
              n_samples=M)
    eps = []
    for stream in (5, 6):
        u = gk.philox_uniform((P, M, D, D), 21, stream, "cpu")
        eps.append(torch.log(u) - torch.log1p(-u))
    drawn = fl.fused_linear_estimators(**kw, seed=21, streams=(5, 6))
    injected = fl.fused_linear_estimators(**kw, seed=0, streams=(0, 0),
                                          eps=tuple(eps))
    for a, b in zip(drawn, injected):
        assert torch.equal(a, b)


@pytest.mark.parametrize("sharing", [None, "hard"])
def test_fused_path_matches_generic_autograd_estimators(sharing):
    """``fused_grad_both`` (fused plain version) against the generic
    reparam and Theta estimators on the same noise; with 'hard' sharing the
    Theta samples are the thresholds of the soft samples' noise."""
    _, thetas, x, interv, zs = _inputs(3, 1.0)
    model = LinearGaussian(n_vars=D, obs_noise=0.1)
    x_t, i_t = torch.from_numpy(x), torch.from_numpy(interv)
    common = dict(cfg=EstimatorConfig(grad_estimator_z="reparam",
                                      n_grad_mc_samples=M),
                  log_graph_prior=ErdosReniDAGDistribution(
                      D, 1).unnormalized_log_prob_soft,
                  x=x_t, interv_mask=i_t,
                  log_joint_prob=model.interventional_log_joint_prob)
    fused = make_estimators(**common, fused_linear_model=model,
                            fused_sample_sharing=sharing)
    generic = make_estimators(**common, fused_sample_sharing=sharing)
    z_t, th_t = torch.from_numpy(zs), torch.from_numpy(thetas)
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
    for got, want in ((dz, dz_g), (dtheta, dtheta_g)):
        tol = 1e-4 * max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) < tol


def test_kernel_gate_follows_the_shared_memory_footprint():
    # headline: all 100 rows resident; config 4: 128-row tiles over N=600
    assert fl.fused_linear_tile_rows(20, 100) == 100
    assert fl.fused_linear_tile_rows(30, 600) == 128
    assert fl.fused_linear_smem_bytes(20, 100) == 144 + 4 * (4400 + 10000)
    assert fl.fused_linear_available(70, 10_000)
    assert fl.fused_linear_smem_bytes(70, fl.fused_linear_tile_rows(
        70, 10_000)) <= 232448
    # past d = 70 the row tier does not fit; the wide tier serves d <= 602
    assert fl.fused_linear_tile_rows(71, 10_000) is None
    assert fl.fused_linear_available(71, 10_000)
    assert fl.fused_linear_wide_tile_rows(128, 100) == 100
    assert fl.fused_linear_wide_smem_bytes(128, 100) == \
        144 + 4 * (11 * 128 * 8 + 4 * 100 * 8 + 100 * 129)
    assert fl.fused_linear_available(602, 10_000)
    assert fl.fused_linear_wide_smem_bytes(602, fl.fused_linear_wide_tile_rows(
        602, 10_000)) <= 232448
    assert not fl.fused_linear_available(603, 10_000)
    assert fl.fused_linear_wide_tile_rows(603, 10_000) is None


def test_wrappers_take_the_plain_versions_on_the_cpu():
    _, thetas, x, interv, zs = _inputs(4, 1.0)
    scores = torch.from_numpy(zs[..., 0] @ zs[..., 1].transpose(0, 2, 1))
    w = 1.0 - torch.from_numpy(interv).float()
    args = (scores, torch.from_numpy(thetas), torch.from_numpy(x), w)
    kw = dict(seed=3, streams=(1, 2), alpha=0.5, tau=1.0, n_samples=M,
              model=LinearGaussian(n_vars=D))
    before = dict(gk.LAUNCHES)
    lls = fl.fused_linear_pass1(*args, **kw)
    weights = tuple(torch.softmax(ll, dim=1) for ll in lls)
    pairs = [(fl.fused_linear_single(*args, **kw),
              fl.fused_linear_single_plain(*args, **kw)),
             (lls, fl.fused_linear_pass1_plain(*args, **kw)),
             (fl.fused_linear_pass2(*args, weights, **kw),
              fl.fused_linear_pass2_plain(*args, weights, **kw))]
    for got, want in pairs:
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert lls[0].shape == (P, M)
    assert gk.LAUNCHES == before
