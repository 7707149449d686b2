"""Port parity for the slice as a whole: MarginalDiBS with BGe and the
``score`` / ``score_rb`` estimators, stepped in both packages from the same
particles with the reference's noise injected into the port.

The noise is rebuilt by replaying the reference's key schedule: per step
``split(state.key, 3)`` gives the likelihood and prior keys, each split per
particle, and the samplers draw ``random.logistic(keys[0], [P, M|K, d, d])``.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from dibs_tpu.inference import MarginalDiBS as JaxMarginalDiBS
from dibs_tpu.inference.transport import marginal_transport as jax_transport
from dibs_tpu.kernel import AdditiveFrobeniusSEKernel as JaxSEKernel
from dibs_tpu.models import BGe as JaxBGe
from dibs_tpu.target import make_linear_gaussian_equivalent_model as jax_data
from dibs_tpu_torch.inference import MarginalDiBS
from dibs_tpu_torch.inference.transport import marginal_transport
from dibs_tpu_torch.interop import bge_from_reference, state_from_reference
from dibs_tpu_torch.kernel import AdditiveFrobeniusSEKernel
from dibs_tpu_torch.models import ErdosReniDAGDistribution

torch.set_num_threads(1)

# N=15: the reference scores BGe in float32, and its node scores carry
# ~(N/2) ulp(logdet) of rounding. The baseline estimator multiplies phi by
# exp(b - logsumexp(log p)), and at N=30 that reached phi ~ 1e9 with the
# reference's own rounding at ~2e-4 of it, above the 1e-4 bar held here.
D, P, K_LAT, M, K_ACYC, N_OBS, STEPS = 8, 4, 6, 16, 8, 15, 20
CONFIGS = {
    "score": dict(grad_estimator_z="score"),
    "score_baseline": dict(grad_estimator_z="score",
                           score_function_baseline=0.5),
    "score_rb": dict(grad_estimator_z="score_rb"),
}


@pytest.fixture(scope="module")
def problem():
    data, _, _ = jax_data(key=random.PRNGKey(7), n_vars=D,
                          graph_prior_str="er", n_observations=N_OBS)
    return np.array(data.x), np.array(data.g)


def _pair(x, cfg):
    ref_model = JaxBGe(n_vars=D)
    ref = JaxMarginalDiBS(
        x=jnp.asarray(x), graph_model=_jax_er(), likelihood_model=ref_model,
        n_grad_mc_samples=M, n_acyclicity_mc_samples=K_ACYC, **cfg)
    port = MarginalDiBS(
        x=torch.from_numpy(x), graph_model=ErdosReniDAGDistribution(D),
        likelihood_model=bge_from_reference(
            n_vars=D, mean_obs=np.asarray(ref_model.mean_obs),
            alpha_mu=ref_model.alpha_mu, alpha_lambd=ref_model.alpha_lambd,
            device="cpu"),
        n_grad_mc_samples=M, n_acyclicity_mc_samples=K_ACYC, device="cpu",
        **cfg)
    return ref, port


def _jax_er():
    from dibs_tpu.models import ErdosReniDAGDistribution as JaxER

    return JaxER(D)


def _reference_run(ref, std):
    """Runs the reference for STEPS steps; returns per step the state, the
    pre-optimizer transport and the Logistic noise its samplers drew."""
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


@pytest.mark.parametrize("name", list(CONFIGS))
def test_marginal_dibs_matches_reference_for_20_steps(problem, name):
    x, _ = problem
    ref, port = _pair(x, CONFIGS[name])
    std = 1.0 / np.sqrt(K_LAT)
    run, ref_final = _reference_run(ref, std)

    # teacher-forced: the port's transport from every reference state
    phi_fn = port._make_phi(port._resolve_latent_std(K_LAT))
    for st, phi_ref, noise in run:
        with torch.no_grad():
            phi, sf = phi_fn(_to_port(st), noise)
        tol = 1e-4 * np.abs(phi_ref).max()
        err = np.abs(phi.numpy() - phi_ref).max()
        assert err <= tol, (name, int(st.t), err, tol)

    # free-running: the port's own 20 steps with the same noise
    state = _to_port(run[0][0])
    step = port._make_step(port._resolve_latent_std(K_LAT))
    for _, _, noise in run:
        state = step(state, noise)
    assert state.t == STEPS
    diff = np.abs(state.z.numpy() - np.asarray(ref_final.z))
    frac, mx = float((diff > 5e-5).mean()), float(diff.max())
    assert frac < 5e-3 and mx < 5e-3, (name, frac, mx)
    np.testing.assert_allclose(state.sf_baseline.numpy(),
                               np.asarray(ref_final.sf_baseline), rtol=1e-4)

    # posterior wrappers on the same final graphs
    g = np.asarray(ref.particle_to_g_lim(ref_final.z))
    g_t = torch.from_numpy(g)
    emp, emp_ref = port.get_empirical(g_t), ref.get_empirical(jnp.asarray(g))
    order = np.lexsort(np.asarray(emp_ref.g).reshape(len(emp_ref.g), -1).T)
    order_t = np.lexsort(emp.g.numpy().reshape(len(emp.g), -1).T)
    np.testing.assert_array_equal(emp.g.numpy()[order_t],
                                  np.asarray(emp_ref.g)[order])
    np.testing.assert_allclose(emp.logp.numpy()[order_t],
                               np.asarray(emp_ref.logp)[order], atol=1e-6)
    mix, mix_ref = port.get_mixture(g_t), ref.get_mixture(jnp.asarray(g))
    # normalized log-weights of ~-300 nat scores: float32 noise ~1e-4
    np.testing.assert_allclose(mix.logp.numpy(), mix_ref.logp, atol=1e-3)


class _EvalOnlySE:
    """A kernel with only the reference ``eval`` signature (autodiff path)."""

    def __init__(self, h):
        self.h = h

    def eval(self, *, x, y):
        lib = torch if torch.is_tensor(x) else jnp
        return lib.exp(-lib.sum((x - y) ** 2) / self.h)


@pytest.mark.parametrize("kind", ["fixed", "median", "eval_only"])
def test_transport_matches_reference(kind):
    rng = np.random.default_rng(11)
    z = (rng.normal(size=(P, D, K_LAT, 2)) / 2).astype(np.float32)
    dz = rng.normal(size=z.shape).astype(np.float32)
    if kind == "eval_only":
        ours_k, ref_k = _EvalOnlySE(5.0), _EvalOnlySE(5.0)
    else:
        h = 5.0 if kind == "fixed" else "median"
        ours_k, ref_k = AdditiveFrobeniusSEKernel(h=h), JaxSEKernel(h=h)
    phi = marginal_transport(ours_k, torch.from_numpy(z), torch.from_numpy(dz))
    phi_ref = jax_transport(ref_k, jnp.asarray(z), jnp.asarray(dz))
    np.testing.assert_allclose(phi.numpy(), phi_ref, atol=1e-5, rtol=1e-5)


def test_sample_runs_end_to_end_on_cpu(problem):
    x, g_true = problem
    port = MarginalDiBS(x=torch.from_numpy(x),
                        graph_model=ErdosReniDAGDistribution(D),
                        likelihood_model=bge_from_reference(
                            n_vars=D, mean_obs=np.zeros(D), alpha_mu=1.0,
                            alpha_lambd=D + 2, device="cpu"),
                        n_grad_mc_samples=M, n_acyclicity_mc_samples=K_ACYC,
                        device="cpu")
    seen = []
    g, state = port.sample(seed=5, n_particles=P, steps=6, n_dim_particles=K_LAT,
                           callback=lambda **kw: seen.append(kw["t"]),
                           callback_every=3, return_state=True)
    assert seen == [3, 6] and state.t == 6
    assert g.shape == (P, D, D) and g.dtype == torch.int32
    g2 = port.resume(state, steps=2)
    assert g2.shape == g.shape


def test_port_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; import dibs_tpu_torch, "
            "dibs_tpu_torch.interop, dibs_tpu_torch.ops.logdet, "
            "dibs_tpu_torch.config, dibs_tpu_torch.inference.fused_linear, "
            "dibs_tpu_torch.inference.fused_nonlinear, "
            "dibs_tpu_torch.models.nonlinear_gaussian, "
            "dibs_tpu_torch.utils.tree, dibs_tpu_torch.target, "
            "dibs_tpu_torch.models.graph, dibs_tpu_torch.accounting, "
            "dibs_tpu_torch.warmup, chip_smoke; "
            "assert not any(m == 'dibs_tpu' or m.startswith('dibs_tpu.') "
            "for m in sys.modules)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.slow
@pytest.mark.skipif(os.environ.get("DIBS_RUN_SLOW") != "1",
                    reason="slow end-to-end quality run; set DIBS_RUN_SLOW=1")
def test_port_marginal_bge_quality_reduced():
    """The reference's reduced config-1 quality run (d=12, 800 steps) on the
    port, with the port's own data factory and noise streams."""
    from dibs_tpu_torch.metrics import expected_shd, threshold_metrics
    from dibs_tpu_torch.models import BGe
    from dibs_tpu_torch.target import make_linear_gaussian_equivalent_model

    gen = torch.Generator().manual_seed(123)
    data, gm, _ = make_linear_gaussian_equivalent_model(
        generator=gen, n_vars=12, graph_prior_str="er", device="cpu")
    dibs = MarginalDiBS(x=data.x, graph_model=gm,
                        likelihood_model=BGe(n_vars=12, device="cpu"),
                        device="cpu")
    gs = dibs.sample(seed=123, n_particles=12, steps=800)
    n_gt_edges = int(data.g.sum())
    for dist in (dibs.get_empirical(gs), dibs.get_mixture(gs)):
        eshd = expected_shd(dist=dist, g=data.g)
        auroc = threshold_metrics(dist=dist, g=data.g)["roc_auc"]
        assert auroc > 0.55, (eshd, auroc)
        assert eshd < 2.0 * n_gt_edges, (eshd, n_gt_edges)
