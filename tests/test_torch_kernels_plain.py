"""Port parity for the plain PyTorch twins of the three CUDA kernels, held to
the JAX reference on the CPU (the Pallas kernels in interpret mode, the
samplers on their XLA path with the same Logistic draw injected).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random, vmap

from dibs_tpu.models.linear_gaussian import BGe as JaxBGe
from dibs_tpu.ops import logdet as jax_logdet
from dibs_tpu.ops.bge_kernel import bge_logdet_pairs as jax_bge_pairs
from dibs_tpu.ops.pallas_kernels import fused_se_matrix
from dibs_tpu.ops.soft_graphs import sample_hard_graphs as jax_hard
from dibs_tpu.ops.soft_graphs import sample_soft_graphs as jax_soft
from dibs_tpu_torch.ops import gpu_kernels as gk
from dibs_tpu_torch.ops.bge_kernel import bge_logdet_pairs
from dibs_tpu_torch.ops.logdet import masked_logdet_pd_pair
from dibs_tpu_torch.ops.soft_graphs import sample_hard_graphs, sample_soft_graphs

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


# --- Gumbel sampler ------------------------------------------------------


@pytest.mark.parametrize("b,m,d", [(3, 8, 6), (2, 16, 11)])
def test_gumbel_twin_matches_reference_with_injected_noise(b, m, d):
    key = random.PRNGKey(b * 100 + d)
    scores = np.random.default_rng(d).normal(size=(b, d, d)).astype(np.float32)
    alpha, tau = 1.7, 1.3
    eps = random.logistic(key, shape=(b, m, d, d))  # the XLA path's draw

    hard = sample_hard_graphs(_t(scores), 0, 0, alpha, m, eps=_t(eps))
    ref_hard = jax_hard(jnp.asarray(scores), key, alpha, m, use_pallas=False)
    np.testing.assert_array_equal(hard.numpy(), np.asarray(ref_hard))

    s_t = _t(scores).requires_grad_(True)
    soft = sample_soft_graphs(s_t, 0, 0, alpha, tau, m, eps=_t(eps))
    ref_soft, vjp = jax.vjp(
        lambda s: jax_soft(s, key, alpha, tau, m, use_pallas=False),
        jnp.asarray(scores))
    np.testing.assert_allclose(soft.detach().numpy(), ref_soft, atol=1e-6)

    cot = np.random.default_rng(1).normal(size=(b, m, d, d)).astype(np.float32)
    (grad,) = torch.autograd.grad(soft, s_t, _t(cot))
    (ref_grad,) = vjp(jnp.asarray(cot))
    np.testing.assert_allclose(grad.numpy(), ref_grad, atol=1e-5)


def test_philox_matches_random123_known_answers():
    # Random123 kat_vectors for philox4x32-10: (counter, key) -> output
    cases = [
        ((0, 0, 0, 0), (0, 0),
         (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
         (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
         (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, key, want in cases:
        words = gk.philox4x32(*[torch.tensor([c]) for c in ctr], *key)
        assert tuple(int(w) for w in words) == want


def test_in_kernel_noise_is_a_valid_sampler():
    d, m = 7, 4000
    scores = _t(np.random.default_rng(2).uniform(-1.5, 1.5, size=(2, d, d)))
    u = gk.philox_uniform((2, m, d, d), seed=99, stream=4, device="cpu")
    assert 0.0 < float(u.min()) and float(u.max()) <= 1.0 - 2.0 ** -23
    hard = sample_hard_graphs(scores, 99, 4, 1.0, m)
    p = torch.sigmoid(scores)
    se = torch.sqrt(p * (1 - p) / m)
    off = ~torch.eye(d, dtype=torch.bool)
    z = ((hard.mean(1) - p).abs() / se)[:, off]
    assert float(z.max()) < 5.0
    assert torch.equal(torch.diagonal(hard, dim1=-2, dim2=-1),
                       torch.zeros(2, m, d))
    # same (seed, stream) -> same draw; another stream -> another draw
    assert torch.equal(hard, sample_hard_graphs(scores, 99, 4, 1.0, m))
    assert not torch.equal(hard, sample_hard_graphs(scores, 99, 5, 1.0, m))


# --- BGe determinant pairs -----------------------------------------------


def _bge_case(d, b, seed, interventional=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3 * d, d)).astype(np.float32)
    interv = ((rng.uniform(size=x.shape) < 0.2) if interventional
              else np.zeros(x.shape, bool)).astype(np.int32)
    r_mats, _ = JaxBGe(n_vars=d)._posterior_r_mats(jnp.asarray(x),
                                                    jnp.asarray(interv))
    gs = (rng.uniform(size=(b, d, d)) < 0.3).astype(np.float32)
    gs *= 1.0 - np.eye(d, dtype=np.float32)
    gs[0] = 0.0  # an all-zero mask
    return np.asarray(r_mats), gs


@pytest.mark.parametrize("d,b,interventional", [
    (2, 9, False), (8, 20, True), (20, 12, False)])
def test_bge_twin_matches_reference_kernel_and_elimination(d, b,
                                                           interventional):
    r_mats, gs = _bge_case(d, b, seed=d, interventional=interventional)
    pa, full = bge_logdet_pairs(_t(r_mats), _t(gs))  # CPU -> plain twin
    assert pa.shape == (b, d) and full.shape == (b, d)
    assert torch.equal(pa[0], torch.zeros(d))

    k_pa, k_full = jax_bge_pairs(jnp.asarray(r_mats), jnp.asarray(gs),
                                 interpret=True)
    eye = jnp.eye(d)
    e_pa, e_full = vmap(lambda g: vmap(
        lambda j: jax_logdet.masked_logdet_pd_pair(
            jnp.asarray(r_mats)[j], g[:, j], eye[:, j]))(jnp.arange(d)))(
        jnp.asarray(gs))
    for ours, ref in ((pa, k_pa), (full, k_full), (pa, e_pa), (full, e_full)):
        np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_bge_twin_rejects_unsupported_d():
    for d in (1, 129):
        with pytest.raises(ValueError):
            bge_logdet_pairs(torch.ones(d, d, d), torch.zeros(3, d, d))


@pytest.mark.parametrize("d", [8, 40, 70])
def test_masked_logdet_pd_pair_matches_reference_tiers(d):
    r_mats, gs = _bge_case(d, 4, seed=100 + d)
    j = np.arange(d)
    m = r_mats[j][None].repeat(4, 0)  # [4, d, d, d]
    parents = gs.transpose(0, 2, 1)  # [4, j, r]
    e_j = np.broadcast_to(np.eye(d, dtype=np.float32), (4, d, d))
    pa, full = masked_logdet_pd_pair(_t(m), _t(parents), _t(e_j))
    ref_pa, ref_full = vmap(vmap(jax_logdet.masked_logdet_pd_pair))(
        jnp.asarray(m), jnp.asarray(parents), jnp.asarray(e_j))
    np.testing.assert_allclose(pa.numpy(), ref_pa, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(full.numpy(), ref_full, rtol=1e-4, atol=1e-4)


# --- SE kernel matrix -----------------------------------------------------


@pytest.mark.parametrize("a,b,n", [(5, 7, 40), (6, 6, 600)])
def test_se_twin_matches_reference_kernel(a, b, n):
    rng = np.random.default_rng(a + n)
    x = (rng.normal(size=(a, n)) / 4).astype(np.float32)
    y = (rng.normal(size=(b, n)) / 4).astype(np.float32)
    h, scale = float(n) / 8, 1.3
    out = gk.se_matrix(_t(x), _t(y), h, scale)
    ref = fused_se_matrix(jnp.asarray(x), jnp.asarray(y), h, scale,
                          interpret=True)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    xt = _t(x)
    self_k = gk.se_matrix(xt, xt, h, scale)
    assert torch.equal(torch.diagonal(self_k), torch.full((a,), scale))
