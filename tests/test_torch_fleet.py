"""The fleet (``dibs_tpu_torch.fleet``) against ``dibs_tpu.fleet`` and
against single port runs, on the CPU.

The reference fleet vmaps ``MarginalDiBS``'s step over the datasets with one
key a dataset. Its noise is rebuilt by replaying each dataset's key
schedule as ``tests/test_torch_svgd.py`` does for one run: per step
``split(state.key, 3)`` gives the likelihood and prior keys, each split per
particle, and the samplers draw ``random.logistic(keys[0], [P, M|K, d, d])``.
Also: the seed derivation, the reference's rejects, the plain twins with a
dataset axis held bitwise to their unbatched twins on each dataset, and BGe
in a fleet outside the kernel's ``2 <= d <= 128``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random, vmap

from dibs_tpu.fleet import fleet_sample as jax_fleet_sample
from dibs_tpu.inference import MarginalDiBS as JaxMarginalDiBS
from dibs_tpu.inference.transport import marginal_transport as jax_transport
from dibs_tpu.models import BGe as JaxBGe
from dibs_tpu.models import ErdosReniDAGDistribution as JaxER
from dibs_tpu.target import make_linear_gaussian_equivalent_model as jax_data
from dibs_tpu_torch.fleet import (
    fleet_init_state,
    fleet_sample,
    fleet_seeds,
)
from dibs_tpu_torch.inference import MarginalDiBS
from dibs_tpu_torch.interop import bge_from_reference, fleet_state_from_reference
from dibs_tpu_torch.models import BGe, ErdosReniDAGDistribution
from dibs_tpu_torch.ops import gpu_kernels as gk
from dibs_tpu_torch.ops import transport_kernel as tk
from dibs_tpu_torch.ops.bge_kernel import bge_logdet_pairs_plain

torch.set_num_threads(1)

# N=15 as tests/test_torch_svgd.py, which keeps the reference's float32 BGe
# rounding inside the 1e-4 max|phi| bar (but see the baseline note below)
B, D, P, M, K_ACYC, N_OBS, STEPS, FREE = 3, 6, 4, 8, 4, 15, 20, 6
CONFIGS = {
    "score": dict(grad_estimator_z="score"),
    "score_baseline": dict(grad_estimator_z="score",
                           score_function_baseline=0.5),
    "score_rb": dict(grad_estimator_z="score_rb"),
}


@pytest.fixture(scope="module")
def datasets():
    xs = [np.array(jax_data(key=random.PRNGKey(b), n_vars=D,
                            graph_prior_str="er",
                            n_observations=N_OBS)[0].x)
          for b in range(B)]
    return np.stack(xs)


def _ref_engine(x, cfg):
    return JaxMarginalDiBS(
        x=jnp.asarray(x), graph_model=JaxER(D),
        likelihood_model=JaxBGe(n_vars=D), n_grad_mc_samples=M,
        n_acyclicity_mc_samples=K_ACYC, **cfg)


def _port_engine(x, cfg, device="cpu"):
    ref_model = JaxBGe(n_vars=D)
    return MarginalDiBS(
        x=torch.as_tensor(x), graph_model=ErdosReniDAGDistribution(D),
        likelihood_model=bge_from_reference(
            n_vars=D, mean_obs=np.asarray(ref_model.mean_obs),
            alpha_mu=ref_model.alpha_mu, alpha_lambd=ref_model.alpha_lambd,
            device=device),
        n_grad_mc_samples=M, n_acyclicity_mc_samples=K_ACYC, device=device,
        **cfg)


def _reference_fleet_run(xs, cfg, key):
    """The reference fleet stepped as ``fleet_sample`` steps it (the engine's
    step vmapped over the datasets); per step the stacked state, each
    dataset's pre-optimizer transport and the noise its samplers drew."""
    ref = _ref_engine(xs[0], cfg)
    std = ref._resolve_latent_std(D)
    bstep = jax.jit(vmap(ref._make_step(std), in_axes=(0, 0, 0)))

    def phi_and_noise(st, x, interv):
        _, k_lik, k_prior = random.split(st.key, 3)
        keys_lik = random.split(k_lik, P)
        keys_prior = random.split(k_prior, P)
        dz_lik, _ = ref.est.eltwise_grad_z_likelihood(
            st.z, None, st.sf_baseline, st.t, keys_lik, x=x,
            interv_mask=interv)
        dz_prior = ref.est.eltwise_grad_latent_prior(st.z, keys_prior, st.t,
                                                     std)
        phi = jax_transport(ref.kernel, st.z, dz_prior + dz_lik)
        return phi, (random.logistic(keys_lik[0], (P, M, D, D)),
                     random.logistic(keys_prior[0], (P, K_ACYC, D, D)))

    bphi = jax.jit(vmap(phi_and_noise))
    x_b = jnp.asarray(xs)
    interv = jnp.zeros(x_b.shape, jnp.int32)
    states = vmap(lambda k: ref.init_state(key=k, n_particles=P))(
        random.split(key, B))
    out = []
    for _ in range(STEPS):
        phi, noise = bphi(states, x_b, interv)
        out.append((jax.device_get(states), np.asarray(phi),
                    tuple(torch.from_numpy(np.array(e)) for e in noise)))
        states = bstep(states, x_b, interv)
    return out


def _port_fleet_phi(port, xs):
    x_t = torch.from_numpy(xs)
    std = port._resolve_latent_std(D)
    phi = port._make_fleet_phi(x_t, torch.zeros(x_t.shape, dtype=torch.int32),
                               std)
    return phi, port._make_step(std, phi_fn=phi)


# The baseline estimator is held to single port runs only: it scales phi by
# exp(b - logsumexp(log p)), which carries the reference's float32 BGe
# rounding to 1.03x the bar here (dataset 1, step 11), as ROADMAP.md queue
# 3 records for one run at N=30; the fleet equals single port runs.
@pytest.mark.parametrize("name", ["score", "score_rb"])
def test_fleet_matches_reference_fleet(datasets, name):
    """Teacher-forced ``phi`` of every dataset within 1e-4 max|phi| of the
    reference fleet's over 20 steps; a free run on the reference's noise
    ends where ``dibs_tpu.fleet.fleet_sample`` ends."""
    key = random.PRNGKey(5)
    run = _reference_fleet_run(datasets, CONFIGS[name], key)
    port = _port_engine(datasets[0], CONFIGS[name])
    phi_fn, step = _port_fleet_phi(port, datasets)
    seeds = [0] * B  # the noise is injected: the keys draw nothing
    for st, phi_ref, noise in run:
        state = fleet_state_from_reference(st, seeds=seeds, device="cpu")
        with torch.no_grad():
            phi, _ = phi_fn(state, noise)
        for b in range(B):
            tol = 1e-4 * np.abs(phi_ref[b]).max()
            err = np.abs(phi[b].numpy() - phi_ref[b]).max()
            assert err <= tol, (name, b, int(state.t), err, tol)

    state = fleet_state_from_reference(run[0][0], seeds=seeds, device="cpu")
    for _, _, noise in run[:FREE]:
        state = step(state, noise)
    gs_ref, st_ref = jax_fleet_sample(
        _ref_engine(datasets[0], CONFIGS[name]), xs=jnp.asarray(datasets),
        key=key, n_particles=P, steps=FREE, return_states=True)
    diff = np.abs(state.z.numpy() - np.asarray(st_ref.z))
    assert float((diff > 5e-5).mean()) < 5e-3 and diff.max() < 5e-3, name
    gs = port.particle_to_g_lim(state.z).numpy()
    assert gs.shape == (B, P, D, D)
    np.testing.assert_array_equal(gs, np.asarray(gs_ref))
    np.testing.assert_allclose(state.sf_baseline.numpy(),
                               np.asarray(st_ref.sf_baseline), rtol=1e-4)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_fleet_matches_single_port_runs(datasets, name):
    """Dataset b of the fleet is a single engine on ``xs[b]`` seeded
    ``fleet_seeds(seed, B)[b]``: the same initial particles, the same
    Philox noise (``phi`` at the bar every step) and the same final graphs."""
    port = _port_engine(datasets[0], CONFIGS[name])
    phi_fn, step = _port_fleet_phi(port, datasets)
    seeds = fleet_seeds(9, B)
    singles = [_port_engine(x, CONFIGS[name]) for x in datasets]
    state = fleet_init_state(port, seeds, P)
    ones = [e.init_state(seed=int(s), n_particles=P)
            for e, s in zip(singles, seeds.tolist())]
    for b in range(B):
        assert torch.equal(state.z[b], ones[b].z)
    for _ in range(5):
        with torch.no_grad():
            phi, _ = phi_fn(state)
        for b, (e, one) in enumerate(zip(singles, ones)):
            std = e._resolve_latent_std(D)
            with torch.no_grad():
                want, _ = e._make_phi(std)(one)
            tol = 1e-4 * float(want.abs().max())
            assert float((phi[b] - want).abs().max()) <= tol
            ones[b] = e._make_step(std)(one)
        state = step(state)
    gs, final = fleet_sample(port, xs=datasets, seed=9, n_particles=P,
                             steps=5, return_states=True)
    assert gs.dtype == torch.int32 and final.t == 5
    for b, (e, one) in enumerate(zip(singles, ones)):
        assert torch.equal(gs[b], e.particle_to_g_lim(one.z))
        torch.testing.assert_close(final.sf_baseline[b], one.sf_baseline,
                                   rtol=1e-5, atol=1e-6)


def test_fleet_seeds_are_pinned():
    seeds = fleet_seeds(0, 4)
    assert seeds.dtype == torch.int64 and seeds.shape == (4,)
    assert torch.equal(seeds, torch.randint(
        0, 2 ** 63 - 1, (4,), generator=torch.Generator().manual_seed(0),
        dtype=torch.int64))
    assert torch.equal(fleet_seeds(0, 2), seeds[:2])
    assert bool((seeds >= 0).all()) and len(set(seeds.tolist())) == 4
    assert not torch.equal(fleet_seeds(1, 4), seeds)


def test_fleet_rejects_what_the_reference_rejects(datasets):
    port = _port_engine(datasets[0], CONFIGS["score"])
    with pytest.raises(ValueError, match=r"\[B, N, d\]"):
        fleet_sample(port, xs=datasets[0], seed=0, n_particles=2, steps=1)
    with pytest.raises(ValueError, match=r"\[B, N, d\]"):
        fleet_sample(port, xs=datasets[:, :5], seed=0, n_particles=2,
                     steps=1)
    with pytest.raises(ValueError, match="interv_masks"):
        fleet_sample(port, xs=datasets, seed=0, n_particles=2, steps=1,
                     interv_masks=np.zeros((1, 2, 3), np.int32))
    with pytest.raises(ValueError, match="has no axis 'datasets'"):
        fleet_sample(port, xs=datasets, seed=0, n_particles=2, steps=1,
                     mesh=object())
    with pytest.raises(ValueError, match="not a DiBS engine"):
        fleet_sample(object(), xs=datasets, seed=0, n_particles=2, steps=1)


def test_sampler_twin_keys_each_dataset():
    rng = np.random.default_rng(1)
    keys = fleet_seeds(3, B)
    scores = torch.from_numpy(rng.normal(size=(B * P, D, D))
                              .astype(np.float32))
    for hard in (True, False):
        out = gk.gumbel_graphs(scores, keys, 4, 1.5, 0.8, M, hard)
        for b, key in enumerate(keys.tolist()):
            one = gk.gumbel_graphs(scores[b * P:(b + 1) * P], key, 4, 1.5,
                                   0.8, M, hard)
            assert torch.equal(out[b * P:(b + 1) * P], one)
    with pytest.raises(ValueError, match="split"):
        gk.philox_uniform((B * P + 1, 2, D, D), keys, 0, "cpu")


@pytest.mark.parametrize("d", [2, 6, 33])
def test_bge_twin_reads_each_datasets_matrices(d):
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.normal(size=(B, N_OBS, d)).astype(np.float32))
    r_mats, _ = BGe(n_vars=d, device="cpu")._posterior_r_mats(
        x, torch.zeros_like(x, dtype=torch.int32))
    gs = torch.from_numpy((rng.uniform(size=(B * 5, d, d)) < 0.3)
                          .astype(np.float32)) * (1.0 - torch.eye(d))
    pa, full = bge_logdet_pairs_plain(r_mats, gs)
    for b in range(B):
        one_r, _ = BGe(n_vars=d, device="cpu")._posterior_r_mats(
            x[b], torch.zeros_like(x[b], dtype=torch.int32))
        one = bge_logdet_pairs_plain(one_r, gs[5 * b:5 * (b + 1)])
        assert torch.equal(one[0], pa[5 * b:5 * (b + 1)])
        assert torch.equal(one[1], full[5 * b:5 * (b + 1)])


def test_se_and_transport_twins_per_dataset():
    rng = np.random.default_rng(2)
    z = torch.from_numpy(rng.normal(size=(B, P, 72)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(B, P, 72)).astype(np.float32))
    k_mat = gk.se_matrix(z, z, 5.0, 1.0)
    mu = z.mean(dim=1, keepdim=True)
    k_other = gk.se_matrix(g, g, 50.0, 1.0)
    for other in (None, k_other):
        phi = tk.transport_phi(k_mat, other, g, z, c=-0.4, mu=mu)
        for b in range(B):
            assert torch.equal(k_mat[b], gk.se_matrix(z[b], z[b], 5.0, 1.0))
            one = tk.transport_phi(k_mat[b], None if other is None
                                   else other[b], g[b], z[b], c=-0.4,
                                   mu=mu[b])
            assert torch.equal(phi[b], one)
    with pytest.raises(ValueError, match="kernel matrix"):
        tk.transport_phi(k_mat[0], None, g, z, c=-0.4)


@pytest.mark.parametrize("d", [1, 130])
def test_bge_fleet_outside_the_kernels_range(d):
    """BGe in a fleet where the determinant path replaces the kernel: each
    dataset's scores are those of a BGe call on its data alone."""
    n_obs, n_g = (8, 4) if d == 1 else (40, 2)
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.normal(size=(B, n_obs, d)).astype(np.float32))
    masks = torch.zeros(x.shape, dtype=torch.int32)
    masks[1, :3, 0] = 1
    gs = torch.from_numpy((rng.uniform(size=(B, n_g, d, d)) < 0.05)
                          .astype(np.float32)) * (1.0 - torch.eye(d))
    bge = BGe(n_vars=d, device="cpu")
    got = bge.batched_node_log_marginal_likelihoods(gs=gs, x=x,
                                                    interv_targets=masks)
    assert got.shape == (B, n_g, d)
    for b in range(B):
        want = bge.batched_node_log_marginal_likelihoods(
            gs=gs[b], x=x[b], interv_targets=masks[b])
        torch.testing.assert_close(got[b], want, rtol=1e-6, atol=1e-4)


def test_fleet_state_from_reference_takes_the_stacked_state(datasets):
    ref = _ref_engine(datasets[0], CONFIGS["score"])
    _, st = jax_fleet_sample(ref, xs=jnp.asarray(datasets),
                             key=random.PRNGKey(1), n_particles=P, steps=2,
                             return_states=True)
    st = jax.device_get(st)
    state = fleet_state_from_reference(st, seeds=[4, 5, 6], device="cpu")
    assert state.t == 2 and state.seed.tolist() == [4, 5, 6]
    assert state.z.shape == (B, P, D, D, 2)
    np.testing.assert_array_equal(state.z.numpy(), np.asarray(st.z))
    np.testing.assert_array_equal(state.opt_state_z[0].nu.numpy(),
                                  np.asarray(st.opt_state_z[0].nu))
    with pytest.raises(ValueError, match="step counter"):
        fleet_state_from_reference(st._replace(t=np.array([1, 2, 2])),
                                   seeds=[0] * B, device="cpu")


def test_fleet_transport_kernels():
    """The fleets' transports serve every kernel, each dataset's that of a
    single run on its particles: the marginal fleet's median bandwidth (its
    own a dataset) and a kernel with only the ``eval`` signature (the
    autodiff transport, vmapped over the datasets); the joint fleet's
    median bandwidths."""
    from dibs_tpu_torch.inference.transport import (
        fleet_joint_transport,
        fleet_marginal_transport,
        joint_transport,
        marginal_transport,
    )
    from dibs_tpu_torch.kernel import (
        AdditiveFrobeniusSEKernel,
        JointAdditiveFrobeniusSEKernel,
    )

    rng = np.random.default_rng(4)
    z = torch.from_numpy(rng.normal(size=(B, P, D, 3, 2)).astype(np.float32))
    dz = torch.from_numpy(rng.normal(size=z.shape).astype(np.float32))

    class EvalOnly:
        def eval(self, *, x, y):
            return torch.exp(-torch.sum((x - y) ** 2))

    for kernel in (AdditiveFrobeniusSEKernel(h="median"), EvalOnly()):
        phi = fleet_marginal_transport(kernel, z, dz)
        for b in range(B):
            torch.testing.assert_close(phi[b], marginal_transport(
                kernel, z[b], dz[b]), rtol=1e-5, atol=1e-6)
    theta = torch.from_numpy(rng.normal(size=(B, P, D, D)).astype(
        np.float32))
    dtheta = torch.from_numpy(rng.normal(size=theta.shape).astype(
        np.float32))
    kernel = JointAdditiveFrobeniusSEKernel(h_latent="median")
    phi_z, phi_t = fleet_joint_transport(kernel, z, theta, dz, dtheta)
    for b in range(B):
        want_z, want_t = joint_transport(kernel, z[b], theta[b], dz[b],
                                         dtheta[b])
        torch.testing.assert_close(phi_z[b], want_z, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(phi_t[b], want_t, rtol=1e-5, atol=1e-6)
