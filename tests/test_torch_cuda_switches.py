"""The kill switch and the precision policy on the card: (a) with
``set_pallas_enabled(False)`` a marginal and a joint ``score`` step launch
no kernel and give the kernels' transport, and after
``set_pallas_enabled(None)`` the launches resume; (b) the default precision
leaves joint ``score``'s transport bitwise unchanged; (c) the acyclicity
chain at ``'high'`` (TF32) stays near ``'highest'`` and gives the caller's
global precision back. Small shapes; ``chip_smoke.py`` phase 12 runs the
same checks at config 2 and times (c) at config 5's soft shape.

Marked ``cuda``; every test skips where ``torch.cuda.is_available()`` is
false. Imports no JAX::

    python -m pytest tests/test_torch_cuda_switches.py -m cuda -q --noconftest
"""
import contextlib

import pytest
import torch

from dibs_tpu_torch import config
from dibs_tpu_torch.inference import JointDiBS, MarginalDiBS, transport
from dibs_tpu_torch.models import (
    BGe,
    LinearGaussian,
    ScaleFreeDAGDistribution,
    linear_gaussian,
    nonlinear_gaussian,
)
from dibs_tpu_torch.ops import acyclic
from dibs_tpu_torch.ops import gpu_kernels as gk

pytestmark = pytest.mark.cuda

D, N, P, M, K = 8, 30, 6, 16, 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.set_float32_matmul_precision("highest")
    gk.build()
    yield torch.device("cuda:0")
    config.set_pallas_enabled(None)
    config.set_likelihood_matmul_precision("highest")


def _engines(dev):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(N, D, generator=gen).to(dev)
    kw = dict(n_grad_mc_samples=M, n_acyclicity_mc_samples=K, device=dev)
    marginal = MarginalDiBS(x=x, graph_model=ScaleFreeDAGDistribution(D),
                            likelihood_model=BGe(n_vars=D, device=dev), **kw)
    joint = JointDiBS(x=x, graph_model=ScaleFreeDAGDistribution(D),
                      likelihood_model=LinearGaussian(n_vars=D),
                      grad_estimator_z="score", **kw)
    return marginal, joint


def _noise(dev, shapes):
    gen = torch.Generator(device=dev).manual_seed(1)
    out = []
    for shape in shapes:
        u = torch.rand(shape, generator=gen, device=dev).clamp(1e-7, 1 - 1e-7)
        out.append(torch.log(u) - torch.log1p(-u))
    return tuple(out)


def test_kill_switch_sends_the_card_to_the_plain_versions(cuda):
    marginal, joint = _engines(cuda)
    for dibs, shapes, n_phi in (
            (marginal, ((P, M, D, D), (P, K, D, D)), 1),
            (joint, ((P, M, D, D), (P, M, D, D), (P, K, D, D)), 2)):
        std = dibs._resolve_latent_std(D)
        phi, step = dibs._make_phi(std), dibs._make_step(std)
        state = step(dibs.init_state(seed=2, n_particles=P))
        noise = _noise(cuda, shapes)
        with torch.no_grad():
            want = phi(state, noise)
        before = dict(gk.LAUNCHES)
        config.set_pallas_enabled(False)
        with torch.no_grad():
            got = phi(state, noise)
        step(state)
        assert gk.LAUNCHES == before
        config.set_pallas_enabled(None)
        for a, b in zip(got[:n_phi], want[:n_phi]):
            assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
        step(state)
        assert gk.LAUNCHES["gumbel_graphs"] > before["gumbel_graphs"]
        assert gk.LAUNCHES["transport_phi"] > before["transport_phi"]


def test_default_precision_leaves_joint_score_bitwise(cuda):
    _, joint = _engines(cuda)
    std = joint._resolve_latent_std(D)
    phi = joint._make_phi(std)
    state = joint._make_step(std)(joint.init_state(seed=3, n_particles=P))
    noise = _noise(cuda, ((P, M, D, D), (P, M, D, D), (P, K, D, D)))
    with torch.no_grad():
        first = phi(state, noise)
    holders = (linear_gaussian, nonlinear_gaussian, transport, acyclic)
    saved = [mod.matmul_precision for mod in holders]
    for mod in holders:
        mod.matmul_precision = lambda p: contextlib.nullcontext()
    try:
        with torch.no_grad():
            bare = phi(state, noise)
    finally:
        for mod, ctx in zip(holders, saved):
            mod.matmul_precision = ctx
    for a, b in zip(first, bare):
        assert torch.equal(a, b)


def test_acyclicity_tf32_stays_near_ieee_and_restores(cuda):
    gen = torch.Generator(device=cuda).manual_seed(4)
    g = torch.sigmoid(torch.randn((64, 64, 64), generator=gen, device=cuda))
    g = g * (1 - torch.eye(64, device=cuda))
    out = {}
    for precision in ("highest", "high", "default"):
        g_req = g.clone().requires_grad_(True)
        h = acyclic.acyclic_constr(g_req, precision=precision)
        (grad,) = torch.autograd.grad(h, g_req, torch.ones_like(h))
        out[precision] = (h.detach(), grad)
        assert torch.get_float32_matmul_precision() == "highest"
    h_hi, g_hi = out["highest"]
    for precision in ("high", "default"):
        h, grad = out[precision]
        # TF32 carries 10 mantissa bits (2^-11 relative) into a chain of
        # about 2 log2(d) products
        assert float(((h - h_hi).abs() / h_hi.abs()).max()) < 1e-2
        assert float((grad - g_hi).abs().max() / g_hi.abs().max()) < 1e-2
