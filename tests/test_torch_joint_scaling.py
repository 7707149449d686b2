"""Port parity for config 5's slice (``benchmarks/run_benchmarks.py:171-185``:
JointDiBS + LinearGaussian, scale-free d=128, N=100, P=1000, k=128, M=32,
K=8) at sizes the CPU can run, against dibs_tpu.

* The gate: the fused linear kernels serve d=128 (the wide tier past the row
  tier's d <= 70), so JointDiBS takes the fused route there without the
  "kernels disabled" warning, which still fires past the wide tier's limit.
* Config 5's recipe (M=32, K=8, 'hard' sharing, the joint defaults) at P=8,
  d=10, k=10, N=10, teacher-forced for 10 steps from the reference's states
  (carried by ``interop.py``) with the reference's noise injected.
* The plain versions the wide tier is held to (two passes with the softmax
  between), against dibs_tpu's fused_linear_estimators in Pallas interpret
  mode at a shape past the old limit: d=72, P=2, M=8, N=16.
* A JAX config-5 state (Z, Theta and both rmsprop states, P=1000, d=k=128)
  carried into the port.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from dibs_tpu.inference import JointDiBS as JaxJointDiBS
from dibs_tpu.inference.fused_linear import _pad_plan
from dibs_tpu.inference.fused_linear import (
    fused_linear_estimators as jax_fused_linear,
)
from dibs_tpu.inference.transport import joint_transport as jax_joint_transport
from dibs_tpu.models import LinearGaussian as JaxLinearGaussian
from dibs_tpu.models import ScaleFreeDAGDistribution as JaxSF
from dibs_tpu.target import make_linear_gaussian_model as jax_data
from dibs_tpu_torch.inference import JointDiBS
from dibs_tpu_torch.inference import fused_linear as fl
from dibs_tpu_torch.interop import (
    linear_gaussian_from_reference,
    state_from_reference,
)
from dibs_tpu_torch.models import LinearGaussian, ScaleFreeDAGDistribution

torch.set_num_threads(1)

# config 5's estimator recipe at a CPU size
D, P, K_LAT, M, K_ACYC, N_OBS, STEPS = 10, 8, 10, 32, 8, 10, 10


def _joint(d, n_obs, **kw):
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(n_obs, d)).astype(np.float32))
    return JointDiBS(x=x, graph_model=ScaleFreeDAGDistribution(d),
                     likelihood_model=LinearGaussian(n_vars=d),
                     n_grad_mc_samples=M, n_acyclicity_mc_samples=K_ACYC,
                     device="cpu", **kw)


@pytest.mark.parametrize("single_pass", [True, False])
def test_config5_shape_takes_the_fused_route(single_pass):
    assert fl.fused_linear_available(128, 100)
    assert fl.fused_linear_tile_rows(128, 100) is None  # past the row tier
    assert fl.fused_linear_wide_tile_rows(128, 100) == 100  # rows resident
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no "kernels disabled" warning
        dibs = _joint(128, 100, fused_single_pass=single_pass)
    assert dibs.est.fused_grad_both.__name__ == "fused_linear"


def test_past_the_wide_tier_the_engine_still_warns():
    assert not fl.fused_linear_available(603, 100)
    with pytest.warns(UserWarning, match="fused linear-Gaussian kernels "
                                         "disabled for d=603"):
        dibs = _joint(603, 100)
    assert dibs.est.fused_grad_both.__name__ == "fused_shared"


def test_config5_recipe_matches_reference_for_10_teacher_forced_steps():
    # the data seed of tests/test_torch_joint.py. As there, the reference's
    # float32 uncentred log-likelihood limits parity at near ties: with
    # PRNGKey(5) data (|ll| ~ 1.2e4) two soft samples of one particle sit
    # 0.64 nats apart at t=7, and the two packages' phi_z differ by 1.7x
    # the bar there (the port sums centred terms in float64)
    data, _, lm = jax_data(key=random.PRNGKey(7), n_vars=D,
                           graph_prior_str="sf", n_observations=N_OBS)
    x = np.array(data.x)
    ref = JaxJointDiBS(x=jnp.asarray(x), graph_model=JaxSF(D),
                       likelihood_model=lm, n_grad_mc_samples=M,
                       n_acyclicity_mc_samples=K_ACYC)
    port = JointDiBS(
        x=torch.from_numpy(x), graph_model=ScaleFreeDAGDistribution(D),
        likelihood_model=linear_gaussian_from_reference(
            n_vars=D, obs_noise=lm.obs_noise, mean_edge=lm.mean_edge,
            sig_edge=lm.sig_edge, min_edge=lm.min_edge),
        n_grad_mc_samples=M, n_acyclicity_mc_samples=K_ACYC, device="cpu")
    assert port.fused_sample_sharing == "hard"  # both packages' default
    assert port.est.fused_grad_both.__name__ == "fused_linear"
    std = 1.0 / np.sqrt(K_LAT)
    step = jax.jit(ref._make_step(std))

    @jax.jit
    def phi_and_noise(st):
        # the reference's key schedule: split(key, 4) -> (key, k_theta,
        # k_lik, k_prior); 'hard' draws one logistic batch from k_lik
        _, _, k_lik, k_prior = random.split(st.key, 4)
        keys_prior = random.split(k_prior, P)
        dz_lik, dtheta = ref.est.fused_grad_both(st.z, st.theta, st.t, k_lik)
        dz_prior = ref.est.eltwise_grad_latent_prior(st.z, keys_prior, st.t,
                                                     std)
        phi = jax_joint_transport(ref.kernel, st.z, st.theta,
                                  dz_prior + dz_lik, dtheta)
        eps = random.logistic(k_lik, (P, M, D, D))
        return phi, (eps, eps, random.logistic(keys_prior[0],
                                               (P, K_ACYC, D, D)))

    phi_fn = port._make_phi(port._resolve_latent_std(K_LAT))
    state = ref.init_state(key=random.PRNGKey(3), n_particles=P,
                           n_dim_particles=K_LAT)
    for _ in range(STEPS):
        phi_ref, noise = phi_and_noise(state)
        st = state_from_reference(
            z=state.z, nu=state.opt_state_z[0].nu,
            sf_baseline=state.sf_baseline, t=state.t, seed=0,
            theta=state.theta, nu_theta=state.opt_state_theta[0].nu,
            device="cpu")
        with torch.no_grad():
            phi = phi_fn(st, tuple(torch.from_numpy(np.array(e))
                                   for e in noise))
        for got, want, name in zip(phi, phi_ref, ("z", "theta")):
            want = np.asarray(want)
            tol = 1e-4 * np.abs(want).max()
            err = np.abs(got.numpy() - want).max()
            assert err <= tol, (name, int(state.t), err, tol)
        state = step(state)
    assert int(state.t) == STEPS


def test_wide_tier_plain_versions_match_reference_kernel_past_the_old_limit(
        monkeypatch):
    """d=72, P=2, M=8, N=16: with ``single_pass=True`` the port's estimator
    takes the wide tier's route (two passes with the softmax between; their
    plain versions on the CPU) and is
    held to dibs_tpu's one-pass kernel in Pallas interpret mode, with the
    reference's uniforms injected (noise mapping as in
    ``tests/test_torch_fused_linear.py``)."""
    d, p, m, n_obs, alpha, tau = 72, 2, 8, 16, 1.3, 1.0
    rng = np.random.default_rng(8)
    thetas = rng.normal(size=(p, d, d)).astype(np.float32)
    x = rng.normal(size=(n_obs, d)).astype(np.float32)
    interv = (rng.uniform(size=x.shape) < 0.2).astype(np.int32)
    zs = (0.7 * rng.normal(size=(p, d, d, 2)) / np.sqrt(d)).astype(np.float32)
    dp, bm, m_total = _pad_plan(d, m)
    uniforms = rng.uniform(1e-4, 1.0 - 1e-4, size=(
        p, 2, (m_total // bm) * dp, bm * dp)).astype(np.float32)
    ref = jax_fused_linear(
        zs=jnp.asarray(zs), thetas=jnp.asarray(thetas), x=jnp.asarray(x),
        interv_mask=jnp.asarray(interv), key=random.PRNGKey(7), alpha=alpha,
        tau=tau, n_samples=m, model=JaxLinearGaussian(n_vars=d,
                                                      obs_noise=0.1),
        interpret=True, debug_noise=jnp.asarray(uniforms), single_pass=True)

    def blocks(which):
        out = np.empty((p, m, d, d), np.float32)
        for k in range(m):
            grp, loc = divmod(k, bm)
            out[:, k] = uniforms[:, which, grp * dp:(grp + 1) * dp,
                                 loc * dp:(loc + 1) * dp][:, :d, :d]
        return out

    u0, u1 = blocks(0), blocks(1)
    eps = (torch.from_numpy(np.log(u0) - np.log1p(-u0)),
           torch.from_numpy(np.log1p(-u1) - np.log(u1)))
    calls = []
    for name in ("fused_linear_single", "fused_linear_pass1",
                 "fused_linear_pass2"):
        def counted(*args, _orig=getattr(fl, name), _name=name, **kw):
            calls.append(_name)
            return _orig(*args, **kw)

        monkeypatch.setattr(fl, name, counted)
    ours = fl.fused_linear_estimators(
        zs=torch.from_numpy(zs), thetas=torch.from_numpy(thetas),
        x=torch.from_numpy(x), interv_mask=torch.from_numpy(interv),
        model=LinearGaussian(n_vars=d, obs_noise=0.1), seed=0,
        streams=(0, 1), alpha=alpha, tau=tau, n_samples=m, eps=eps,
        single_pass=True)
    assert calls == ["fused_linear_pass1", "fused_linear_pass2"]
    for got, want in zip(ours, ref):
        want = np.asarray(want)
        tol = 1e-4 * max(1.0, float(np.abs(want).max()))
        assert np.abs(got.numpy() - want).max() < tol


def test_a_jax_config5_state_carries_into_the_port():
    """Z [1000, 128, 128, 2], Theta [1000, 128, 128] and both rmsprop states
    of a reference config-5 state, exactly."""
    d, p = 128, 1000
    data, _, lm = jax_data(key=random.PRNGKey(123), n_vars=d,
                           graph_prior_str="sf")
    ref = JaxJointDiBS(x=data.x, graph_model=JaxSF(d), likelihood_model=lm,
                       n_grad_mc_samples=32, n_acyclicity_mc_samples=8)
    st = ref.init_state(key=random.PRNGKey(1), n_particles=p)
    nu_z = np.abs(np.asarray(st.z)) + 0.5  # a non-trivial optimizer state
    nu_t = np.abs(np.asarray(st.theta)) + 0.25
    ours = state_from_reference(z=st.z, nu=nu_z, sf_baseline=st.sf_baseline,
                                t=7, seed=3, theta=st.theta, nu_theta=nu_t,
                                device="cpu")
    assert ours.t == 7 and ours.seed == 3
    pairs = [(ours.z, st.z), (ours.theta, st.theta),
             (ours.opt_state_z[0].nu, nu_z),
             (ours.opt_state_theta[0].nu, nu_t),
             (ours.sf_baseline, st.sf_baseline)]
    assert tuple(ours.z.shape) == (p, d, d, 2)
    assert tuple(ours.theta.shape) == (p, d, d)
    for got, want in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
