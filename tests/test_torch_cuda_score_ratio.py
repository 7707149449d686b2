"""Kernel #10 (``csrc/score_ratio.cu``, the REINFORCE ratio's weighted
residual) against its plain twin on the card, and the ``score``
estimator's route through it against the per-sample route.

Marked ``cuda``; every test skips where ``torch.cuda.is_available()`` is
false. Imports no JAX::

    python -m pytest tests/test_torch_cuda_score_ratio.py -m cuda -q --noconftest
"""
import numpy as np
import pytest
import torch

from dibs_tpu_torch.ops import gpu_kernels as gk
from dibs_tpu_torch.ops.edges import edge_probs, grad_latent_log_prob_batch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.set_float32_matmul_precision("highest")
    gk.build()
    return torch.device("cuda:0")


def inputs(seed, p, m, d, dev, k=8):
    """Hard graphs of density ~0.4 with a zero diagonal, signed weights of
    the ratio's size (a softmax less a share, as with a baseline), the
    edge probabilities of random particles, and the particles."""
    rng = np.random.default_rng(seed)
    g = (rng.uniform(size=(p, m, d, d)) < 0.4).astype(np.float32)
    g *= 1 - np.eye(d, dtype=np.float32)
    logits = rng.normal(scale=3.0, size=(p, m))
    w = np.exp(logits - logits.max(1, keepdims=True))
    w = w / w.sum(1, keepdims=True) - 0.5 / m
    zs = torch.from_numpy(rng.normal(size=(p, d, k, 2)).astype(np.float32))
    zs = zs.to(dev)
    alpha = 3.0
    return (torch.from_numpy(g).to(dev),
            torch.from_numpy(w.astype(np.float32)).to(dev),
            edge_probs(zs, alpha).contiguous(), alpha, zs)


SHAPES = {"config6": (100, 64, 128), "d20": (30, 64, 20),
          "ragged_d130_m300": (3, 300, 130), "scalar_d7_m13": (5, 13, 7)}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_kernel_matches_the_plain_twin_and_repeats_bitwise(cuda, name):
    p, m, d = SHAPES[name]
    g, w, prob, alpha, _ = inputs(sorted(SHAPES).index(name), p, m, d, cuda)
    before = gk.LAUNCHES["score_ratio"]
    got = gk.score_ratio(g, w, prob, alpha)
    again = gk.score_ratio(g, w, prob, alpha)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["score_ratio"] == before + 2
    want = gk.score_ratio_plain(g, w, prob, alpha)
    assert torch.equal(got, again)
    err = float((got - want).abs().max())
    assert err <= 1e-6 * float(want.abs().max()), err
    assert torch.equal(torch.diagonal(got, dim1=-2, dim2=-1),
                       torch.zeros(p, d, device=cuda))


def test_unaligned_inputs_take_the_scalar_build(cuda):
    p, m, d = 4, 9, 16
    g, w, prob, alpha, _ = inputs(5, p, m, d, cuda)
    flat = torch.empty(g.numel() + 1, device=cuda)
    flat[1:] = g.reshape(-1)
    g_off = flat[1:].view(p, m, d, d)  # 4 bytes past a 16-byte boundary
    got = gk.score_ratio(g_off, w, prob, alpha)
    want = gk.score_ratio_plain(g, w, prob, alpha)
    err = float((got - want).abs().max())
    assert err <= 1e-6 * float(want.abs().max()), err


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    g, w, prob, alpha, _ = inputs(6, 3, 8, 10, cuda)
    with pytest.raises(ValueError, match="CUDA"):
        gk.score_ratio(g, w.cpu(), prob, alpha)
    with pytest.raises(ValueError, match="float32"):
        gk.score_ratio(g, w.double(), prob, alpha)
    with pytest.raises(ValueError, match="w must be"):
        gk.score_ratio(g, w[:, 1:], prob, alpha)
    with pytest.raises(ValueError, match="prob must be"):
        gk.score_ratio(g, w, prob[:, :, 1:], alpha)
    with pytest.raises(ValueError, match="contiguous"):
        gk.score_ratio(g.transpose(-1, -2), w, prob, alpha)
    with pytest.raises(ValueError, match="contiguous"):
        gk.score_ratio(g, w, prob.transpose(-1, -2), alpha)


def test_ratio_route_matches_the_per_sample_gradients_on_the_card(cuda):
    """``R @ V`` and ``R^T @ U`` against ``sum_m w_m grad_Z log p(G_m |
    Z)`` from the per-sample gradients, at d = 128."""
    g, w, prob, alpha, zs = inputs(7, 20, 64, 128, cuda, k=128)
    resid = gk.score_ratio(g, w, prob, alpha)
    got = torch.stack([resid @ zs[..., 1],
                       resid.transpose(-1, -2) @ zs[..., 0]], dim=-1)
    per_sample = grad_latent_log_prob_batch(g, zs, alpha)
    want = (w.double()[:, :, None, None, None] * per_sample.double()).sum(1)
    err = float((got.double() - want).abs().max())
    assert err <= 1e-5 * max(1.0, float(want.abs().max())), err
