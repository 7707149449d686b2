"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``cuda``; every test skips where ``torch.cuda.is_available()`` is
false. Imports no JAX, so it runs on a machine that has only torch
(``--noconftest`` skips ``tests/conftest.py``, which imports JAX)::

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

The checks are the kernel phases of ``chip_smoke.py`` (same shapes and
tolerances, the fused linear-Gaussian kernels, the fused MLP kernel #8, the
fused transport kernel #4, the SE matrix #3 from ``[1, 1]`` to config 5 and
the fused acyclicity gradient #9 included), the
wide fused linear tier at small shapes, the ``'spectral'`` option and a
checkpoint round trip, plus the launch counters and the wrappers' input
checks.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from dibs_tpu_torch.inference import fused_linear as fl  # noqa: E402
from dibs_tpu_torch.inference import fused_nonlinear as fnl  # noqa: E402
from dibs_tpu_torch.models import (  # noqa: E402
    BGe,
    DenseNonlinearGaussian,
    LinearGaussian,
)
from dibs_tpu_torch.ops import gpu_kernels as gk  # noqa: E402
from dibs_tpu_torch.ops import transport_kernel as tk  # noqa: E402
from dibs_tpu_torch.ops.bge_kernel import (  # noqa: E402
    bge_logdet_pairs,
    bge_logdet_pairs_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.set_float32_matmul_precision("highest")
    gk.build()
    return torch.device("cuda:0")


def test_kernels_match_plain_twins(cuda):
    results = {}
    chip_smoke.phase_kernels(cuda, results)
    assert set(results) == {"gumbel_graphs", "bge_pairs", "se_matrix"}


def test_fused_kernels_match_plain_versions(cuda):
    results = {}
    chip_smoke.phase_fused(cuda, results)
    assert set(results) == {"fused_linear_single", "fused_linear_pass1",
                            "fused_linear_pass2"}


def test_fused_nonlinear_kernel_matches_plain_version(cuda):
    """Kernel #8 against its plain version at config 3's shape and at d=30,
    N=600 (tiled rows), relu and tanh, injected and Philox noise, and at
    config 7's shape on a cluster of blocks, within 1e-4 max(1,
    max|ref|)."""
    results = {}
    chip_smoke.phase_fused_nonlinear(cuda, results)
    assert set(results) == {"fused_nonlinear", "fused_nonlinear_cluster"}
    assert results["fused_nonlinear"]["ms"] > 0
    assert results["fused_nonlinear_cluster"]["ms"] > 0


def test_fused_nonlinear_wrapper_counts_and_rejects(cuda):
    model = DenseNonlinearGaussian(n_vars=5, hidden_layers=(3,))
    gen = torch.Generator().manual_seed(0)
    theta = model.sample_parameters(generator=gen, n_vars=5, n_particles=3,
                                    device=cuda)
    args = (torch.randn(3, 5, 5, device=cuda),
            *fnl.kernel_layout(theta, model), torch.randn(7, 5, device=cuda),
            torch.ones(7, 5, device=cuda))
    kw = dict(seed=1, streams=(0, 1), alpha=1.0, tau=1.0, n_samples=9,
              model=model)
    before = gk.LAUNCHES["fused_nonlinear"]
    got = fnl.fused_nonlinear(*args, **kw)
    fnl.fused_nonlinear_plain(*args, **kw)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["fused_nonlinear"] == before + 1
    assert [tuple(a.shape) for a in got] == [(3, 5, 5), (3, 3, 5, 5),
                                             (3, 7, 5)]
    with pytest.raises(ValueError):  # float64
        fnl.fused_nonlinear(*[a.double() for a in args], **kw)
    with pytest.raises(ValueError):  # a layer the kernel does not serve
        fnl.fused_nonlinear(*args, **{**kw, "model": DenseNonlinearGaussian(
            n_vars=5, hidden_layers=(3,), bias=False)})
    lib = gk.build()
    plan = fnl.fused_nonlinear_plan(20, 5, 100)
    assert lib.dibs_fused_nonlinear_smem_bytes(20, 5, *plan[:4], 100) == \
        plan.smem_bytes


def _fused_args(device, p=3, d=5, n=7):
    gen = torch.Generator().manual_seed(0)
    return [torch.randn(shape, generator=gen).to(device)
            for shape in ((p, d, d), (p, d, d), (n, d), (n, d))]


_FUSED_KW = dict(seed=1, streams=(0, 1), alpha=1.0, tau=1.0, n_samples=9,
                 model=LinearGaussian(n_vars=5))


def test_in_kernel_rng_statistics(cuda):
    chip_smoke.phase_rng(cuda)


def test_launch_counters_count_kernel_launches_only(cuda):
    before = dict(gk.LAUNCHES)
    scores = torch.randn(2, 5, 5, device=cuda)
    gk.gumbel_graphs(scores, 1, 0, 1.0, 1.0, 3, True)
    gk.gumbel_graphs_plain(scores, 1, 0, 1.0, 1.0, 3, True)
    x = torch.randn(3, 7, device=cuda)
    gk.se_matrix(x, x, 2.0, 1.0)
    gk.se_matrix_plain(x, x, 2.0, 1.0)
    r = torch.eye(4, device=cuda).expand(4, 4, 4).contiguous()
    bge_logdet_pairs(r, torch.zeros(3, 4, 4, device=cuda))
    args = _fused_args(cuda)
    lls = fl.fused_linear_pass1(*args, **_FUSED_KW)
    fl.fused_linear_pass1_plain(*args, **_FUSED_KW)
    weights = tuple(torch.softmax(ll, dim=1) for ll in lls)
    fl.fused_linear_pass2(*args, weights, **_FUSED_KW)
    fl.fused_linear_single(*args, **_FUSED_KW)
    fl.fused_linear_single_plain(*args, **_FUSED_KW)
    model = DenseNonlinearGaussian(n_vars=5, hidden_layers=(3,))
    theta = model.sample_parameters(generator=torch.Generator().manual_seed(0),
                                    n_vars=5, n_particles=3, device=cuda)
    nl_args = (args[0], *fnl.kernel_layout(theta, model), args[2], args[3])
    nl_kw = {**_FUSED_KW, "model": model}
    fnl.fused_nonlinear(*nl_args, **nl_kw)
    fnl.fused_nonlinear_plain(*nl_args, **nl_kw)
    wide_args = _fused_args(cuda, d=72, n=9)  # past the row tier
    wide_kw = {**_FUSED_KW, "model": LinearGaussian(n_vars=72)}
    fl.fused_linear_pass1(*wide_args, **wide_kw)
    fl.fused_linear_pass2(*wide_args, weights, **wide_kw)
    k_mat = torch.rand(3, 3, device=cuda)
    g = torch.randn(3, 10, device=cuda)
    tk.transport_phi(k_mat, k_mat, g, g, c=-0.4)
    tk.transport_phi_plain(k_mat, k_mat, g, g, c=-0.4)
    gk.acyclic_grad(scores, 1, 0.2, 2)
    gk.acyclic_grad_plain(scores, 1, 0.2, 2)
    hard = (torch.rand(2, 3, 5, 5, device=cuda) > 0.5).float()
    ratio_args = (hard, torch.rand(2, 3, device=cuda),
                  torch.rand(2, 5, 5, device=cuda), 1.0)
    gk.score_ratio(*ratio_args)
    gk.score_ratio_plain(*ratio_args)
    torch.cuda.synchronize()
    assert gk.LAUNCHES == {k: v + 1 for k, v in before.items()}


@pytest.mark.parametrize("b,m,d,tau,misaligned", [
    (4, 8, 5, 1.0, False),  # the scalar path (d * d % 4 != 0)
    (4, 8, 13, 0.7, False),
    (600, 128, 5, 1.0, False),  # B * M > 65,535
    (30, 128, 20, 1.0, True),  # misaligned scores: the scalar path
    (2, 3, 6, 1.0, False),  # runs of 4 across rows
    (1, 140_000, 2, 1.0, False),  # more samples than gridDim.y holds
    (3, 2, 1, 1.0, False),  # the diagonal alone
    (8, 3, 128, 1.3, False),
])
def test_sampler_at_its_plan_edges(cuda, b, m, d, tau, misaligned):
    """#1 against its twin on the same Philox uniforms at the edges of its
    launch plan: hard exact off ties, soft within 1e-5; two calls bitwise
    equal."""
    gen = torch.Generator(device=cuda).manual_seed(b * 1000 + d)
    scores = 2.0 * torch.randn(b, d, d, generator=gen, device=cuda)
    if misaligned:
        scores = torch.empty(b * d * d + 1, device=cuda)[1:].view(
            b, d, d).copy_(scores)
    u = gk.philox_uniform((b, m, d, d), 3, 1, cuda)
    logit = torch.log(u) - torch.log1p(-u) + 1.5 * scores[:, None]
    for hard in (True, False):
        out = gk.gumbel_graphs(scores, 3, 1, 1.5, tau, m, hard)
        again = gk.gumbel_graphs(scores, 3, 1, 1.5, tau, m, hard)
        ref = gk.gumbel_graphs_plain(scores, 3, 1, 1.5, tau, m, hard)
        assert torch.equal(out, again)
        diff = (out - ref).abs()
        if hard:
            assert int(((diff > 0) & (logit.abs() >= 1e-5)).sum()) == 0
        else:
            assert float(diff.max()) <= 1e-5


@pytest.mark.parametrize("d", [31, 32])
@pytest.mark.parametrize("kind", ["empty", "full"])
def test_bge_warp_tier_at_its_lane_edges(cuda, d, kind):
    """#2's d <= 32 tier with no parents and with d - 1 (the most its
    32 lanes take: d - 1 columns and the border): equal to the twin within
    rtol = atol = 1e-4 and to float64 slogdet within 1e-4 relative, an
    empty mask exactly 0, two calls bitwise equal."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    x = torch.randn(100, d, generator=gen, device=cuda)
    r_mats, _ = BGe(n_vars=d, device=cuda)._posterior_r_mats(
        x, torch.zeros_like(x, dtype=torch.int32))
    r_mats = r_mats.contiguous()
    eye = torch.eye(d, device=cuda)
    gs = (torch.zeros(6, d, d, device=cuda) if kind == "empty"
          else (1.0 - eye).expand(6, d, d).contiguous())
    pa, full = bge_logdet_pairs(r_mats, gs)
    again = bge_logdet_pairs(r_mats, gs)
    assert torch.equal(pa, again[0]) and torch.equal(full, again[1])
    pa_p, full_p = bge_logdet_pairs_plain(r_mats, gs)
    assert torch.allclose(pa, pa_p, rtol=1e-4, atol=1e-4)
    assert torch.allclose(full, full_p, rtol=1e-4, atol=1e-4)
    if kind == "empty":
        assert bool((pa == 0).all())
    r64, eye64 = r_mats.double(), eye.double()
    for j in range(d):
        par = gs[0, :, j].double()
        for mask, got in ((par, pa[0, j]), (par + eye64[j], full[0, j])):
            outer = mask[:, None] * mask[None, :]
            ref = torch.linalg.slogdet(outer * r64[j] + (1 - outer) * eye64)[1]
            assert abs(float(got) - float(ref)) <= 1e-4 * (1 + abs(float(ref)))


def _bge_problem(cuda, d, collinear=False, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(1000 * d + seed)
    x = torch.randn(100, d, generator=gen, device=cuda)
    if collinear:  # chip_smoke.py phase 3's collinear case
        x[:, 1] = x[:, 0] + 1e-3 * x[:, 1]
    r_mats, _ = BGe(n_vars=d, device=cuda)._posterior_r_mats(
        x, torch.zeros_like(x, dtype=torch.int32))
    return r_mats.contiguous()


def _k_masks(d, ks, b, seed):
    """``b`` graphs whose node j has ``ks[j % len(ks)]`` parents (at most
    d - 1), drawn at random, zero diagonal."""
    rng = np.random.default_rng(seed)
    gs = np.zeros((b, d, d), np.float32)
    for g in range(b):
        for j in range(d):
            k = min(ks[j % len(ks)], d - 1)
            gs[g, rng.choice(np.delete(np.arange(d), j), size=k,
                             replace=False), j] = 1.0
    return torch.from_numpy(gs)


@pytest.mark.parametrize("d", [33, 64, 128])
@pytest.mark.parametrize("collinear", [False, True])
def test_bge_routes_at_their_k_edges_are_bitwise_the_twin(cuda, d,
                                                          collinear):
    """#2 past d = 32 at every route's parent-count edge (k = 0, 15 | 16,
    31 | 32, 33, 63 | 64, 95 | 96, 127), on random and collinear data: bitwise the
    twin, two calls bitwise equal, within 1e-4 relative of float64
    slogdet, each launch counted once."""
    r_mats = _bge_problem(cuda, d, collinear)
    gs = _k_masks(d, (0, 15, 16, 31, 32, 33, 63, 64, 95, 96, 127), 5,
                  d).to(cuda)
    if collinear:
        gs[:, :2, 5] = 1.0  # nodes 0 and 1, collinear, parents of node 5
    before = gk.LAUNCHES["bge_pairs"]
    pa, full = bge_logdet_pairs(r_mats, gs)
    again = bge_logdet_pairs(r_mats, gs)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["bge_pairs"] == before + 2
    assert torch.equal(pa, again[0]) and torch.equal(full, again[1])
    pa_p, full_p = bge_logdet_pairs_plain(r_mats, gs)
    assert torch.equal(pa, pa_p) and torch.equal(full, full_p)
    r64, eye64 = r_mats.double(), torch.eye(d, dtype=torch.float64,
                                            device=cuda)
    mask = gs[0].t().double()  # [j, r]
    for m, got in ((mask, pa[0]), (mask + eye64, full[0])):
        outer = m[:, :, None] * m[:, None, :]
        ref = torch.linalg.slogdet(outer * r64 + (1 - outer) * eye64)[1]
        assert bool(((got.double() - ref).abs()
                     <= 1e-4 * (1 + ref.abs())).all())


def test_bge_soft_masks_past_d32_are_bitwise_the_twin(cuda):
    """Mask values other than 0 and 1 are read back from the graphs."""
    r_mats = _bge_problem(cuda, 64, seed=1)
    gs = _k_masks(64, (3, 40, 70), 4, 7).to(cuda)
    gs[1] *= 0.75
    gs[2, :, 7] *= 0.5
    pa, full = bge_logdet_pairs(r_mats, gs)
    pa_p, full_p = bge_logdet_pairs_plain(r_mats, gs)
    assert torch.equal(pa, pa_p) and torch.equal(full, full_p)


def test_bge_plan_agrees_with_the_kernel(cuda):
    lib = gk.build()
    for d in range(2, 129):
        for k in range(d + 1):
            try:
                want = gk.bge_pairs_plan(d, k).smem_bytes
            except ValueError:
                want = -1
            assert lib.dibs_bge_pairs_smem_bytes(d, k) == want, (d, k)


def test_bge_launcher_refuses_a_plan_it_does_not_name(cuda, monkeypatch):
    from dibs_tpu_torch.ops import bge_kernel

    plans = gk.bge_route_plans()
    wrong = plans[:2] + (plans[2]._replace(smem_bytes=0),) + plans[3:]
    monkeypatch.setattr(bge_kernel, "bge_route_plans", lambda: wrong)
    r_mats = _bge_problem(cuda, 40)
    with pytest.raises(RuntimeError):
        bge_logdet_pairs(r_mats, torch.zeros(2, 40, 40, device=cuda))


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.randn(4, 6, device=cuda)
    with pytest.raises(ValueError):
        gk.se_matrix(x.double(), x.double(), 1.0, 1.0)
    with pytest.raises(ValueError):
        gk.se_matrix(x.t(), x.t(), 1.0, 1.0)
    with pytest.raises(ValueError):
        gk.gumbel_graphs(torch.randn(2, 3, 3, device=cuda), 0, 0, 1.0, 1.0,
                         4, True, eps=torch.randn(2, 5, 3, 3, device=cuda))


def test_acyclic_grad_kernel_matches_plain_version(cuda):
    """Kernel #9 against its plain version at the microbenchmark's shape and
    ragged d, its times, and its entry point with exact launches."""
    results = {}
    launches = chip_smoke.phase_acyclic(cuda, "card", results)
    assert set(results) == {"acyclic_grad"}
    assert launches["acyclic_grad"] > 0 and results["acyclic_grad"]["ms"] > 0


def test_acyclic_grad_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    s = torch.randn(2, 9, 9, device=cuda)
    with pytest.raises(ValueError):  # float64
        gk.acyclic_grad(s.double(), 0, 0.2, 2)
    with pytest.raises(ValueError):  # not contiguous
        gk.acyclic_grad(s.transpose(1, 2), 0, 0.2, 2)
    with pytest.raises(ValueError):  # a CPU eps with CUDA scores
        gk.acyclic_grad(s, 0, 0.2, 2, eps=torch.zeros(2, 2, 9, 9))
    with pytest.raises(ValueError):  # past the shared-memory gate
        gk.acyclic_grad(torch.zeros(1, 140, 140, device=cuda), 0, 0.2, 1)


@pytest.mark.parametrize("d", [1, 2, 4, 5, 64, 65, 128, 129, 139])
def test_acyclic_grad_at_its_tier_edges(cuda, d):
    """Kernel #9 against its plain version at the quad tier's edges (4 x 4
    tiles up to d = 64, 8 x 8 up to 128) and the strided tier's (129,
    139), Philox and injected noise, each particle within ``1e-4 max(1,
    max|plain[p]|)``, and two calls bitwise equal."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    p, k, alpha = 6, 3, 0.2
    scores = 0.5 * torch.randn((p, d, d), generator=gen, device=cuda)
    scores[0, :, : d // 2] = -100.0 / alpha  # exp(-alpha s) overflows
    for eps in (None, torch.randn((p, k, d, d), generator=gen, device=cuda)):
        got = gk.acyclic_grad(scores, 3, alpha, k, eps=eps)
        again = gk.acyclic_grad(scores, 3, alpha, k, eps=eps)
        want = gk.acyclic_grad_plain(scores, 3, alpha, k, eps=eps)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all() and torch.equal(got, again)
        err = (got - want).abs().amax(dim=(1, 2))
        tol = 1e-4 * want.abs().amax(dim=(1, 2)).clamp(min=1.0)
        assert bool((err <= tol).all()), (d, eps is None, err, tol)


@pytest.mark.parametrize("d", [1, 64, 65, 128, 129, 139])
def test_acyclic_grad_plan_agrees_with_the_kernel(cuda, d):
    lib = gk.build()
    assert lib.dibs_acyclic_grad_smem_bytes(d) == gk.acyclic_grad_plan(
        d).smem_bytes
    # the launcher refuses a stride other than the plan's
    plan = gk.acyclic_grad_plan(d)
    s = torch.zeros((1, d, d), device=cuda)
    scratch = torch.zeros((1, plan.tile * plan.tile * 256), device=cuda)
    rc = lib.dibs_acyclic_grad(s.data_ptr(), None, s.data_ptr(),
                               scratch.data_ptr(), 1, d, 1, 0, 0.2, plan.tile,
                               plan.stride + 4, None)
    assert rc != 0


def test_bge_past_the_kernel_range_on_the_card(cuda):
    """BGe at d = 130 on the card (no kernel) against the CPU."""
    chip_smoke.phase_bge_large(cuda, "card")


def test_spectral_engine_and_checkpoint_on_the_card(cuda):
    """``acyclicity='spectral'`` in both classes with exact launch counts,
    and a checkpoint round trip equal to a straight run."""
    chip_smoke.phase_spectral_checkpoint(cuda, "card", 10)


def test_fused_wrappers_reject_what_the_kernels_do_not_take(cuda):
    args = _fused_args(cuda)
    with pytest.raises(ValueError):  # a CPU tensor among CUDA inputs
        fl.fused_linear_single(*args[:2], args[2].cpu(), args[3],
                               **_FUSED_KW)
    with pytest.raises(ValueError):  # float64
        fl.fused_linear_pass1(*[a.double() for a in args], **_FUSED_KW)
    with pytest.raises(ValueError):  # eps of the wrong shape
        bad = torch.zeros(3, 8, 5, 5, device=cuda)
        fl.fused_linear_single(*args, **{**_FUSED_KW, "eps": (bad, bad)})
    with pytest.raises(ValueError):  # weights of the wrong shape
        w = torch.ones(3, 8, device=cuda)
        fl.fused_linear_pass2(*args, (w, w), **_FUSED_KW)
    with pytest.raises(ValueError):  # d past the shared-memory limit
        fl.fused_linear_single(*_fused_args(cuda, d=72, n=9),
                               **{**_FUSED_KW,
                                  "model": LinearGaussian(n_vars=72)})
    with pytest.raises(ValueError):  # d past the wide tier's limit
        fl.fused_linear_pass1(*_fused_args(cuda, d=700, n=9),
                              **{**_FUSED_KW,
                                 "model": LinearGaussian(n_vars=700)})
    lib = gk.build()
    assert lib.dibs_fused_linear_smem_bytes(30, 128) == \
        fl.fused_linear_smem_bytes(30, 128)
    assert lib.dibs_fused_linear_wide_smem_bytes(128, 100) == \
        fl.fused_linear_wide_smem_bytes(128, 100)


def test_transport_kernel_matches_plain_version(cuda):
    """Kernel #4 against its plain version at config 5's families, the d=20
    marginal family, config 3's tree family and a ragged shape."""
    results = {}
    chip_smoke.phase_transport(cuda, results)
    assert set(results) == {"transport_phi"}
    with pytest.raises(ValueError):  # a kernel matrix of the wrong shape
        g = torch.randn(4, 6, device=cuda)
        tk.transport_phi(torch.rand(3, 3, device=cuda), None, g, g, c=-0.4)


def test_se_matrix_kernel_matches_plain_version(cuda):
    """#3 against its plain version and float64 (atol 1e-5) at every shape
    of ``chip_smoke.SHAPES3``, symmetric (exactly symmetric, diagonal
    exactly ``scale``) and not, and its times at config 5."""
    results = {}
    chip_smoke.phase_se_matrix(cuda, results)
    assert set(results) == {"se_matrix"}
    assert results["se_matrix"]["library_ms"] > 0


def test_split_se_matrix_call_counts_one_launch(cuda):
    """A call that splits its features (two launches: the slices and their
    reduction) counts once, is exactly symmetric and matches the plain
    version within atol 1e-5."""
    x = torch.randn(1000, 8192, device=cuda) * (5.0 / 8192) ** 0.5
    tile = gk.se_tile_size(1000, 1000)
    slots = gk._slots(gk.build(), x.device, tile)
    assert gk.se_split(gk.se_tile_count(1000, 1000, True, tile), 8192,
                       slots) > 1
    before = gk.LAUNCHES["se_matrix"]
    k_split = gk.se_matrix(x, x, 5.0, 1.0)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["se_matrix"] == before + 1
    assert torch.equal(k_split, k_split.T)
    assert float((k_split - gk.se_matrix_plain(x, x, 5.0, 1.0)).abs().max()) \
        <= 1e-5


@pytest.mark.parametrize("p,d,n,m", [
    (3, 72, 16, 9), (2, 75, 300, 9), (2, 130, 9, 9), (1, 71, 37, 5),
    (2, 602, 30, 9)])
def test_wide_fused_tier_matches_plain_versions(cuda, p, d, n, m):
    """The wide tier (column tiles; ragged last tile, tiled rows at N=300
    and at d=602) against the plain passes and the one-pass plain version;
    pass 1's edges: one particle, d=71, M=5 and 9 (not a multiple of its
    group of 4), N=37 (not a multiple of its row tiles)."""
    args = _fused_args(cuda, p=p, d=d, n=n)
    kw = {**_FUSED_KW, "model": LinearGaussian(n_vars=d), "n_samples": m}
    before = dict(gk.LAUNCHES)
    lls = fl.fused_linear_pass1(*args, **kw)
    lls_p = fl.fused_linear_pass1_plain(*args, **kw)
    weights = tuple(torch.softmax(ll, dim=1) for ll in lls_p)
    pairs = list(zip(lls, lls_p))
    pairs += list(zip(fl.fused_linear_pass2(*args, weights, **kw),
                      fl.fused_linear_pass2_plain(*args, weights, **kw)))
    pairs += list(zip(fl.fused_linear_pass2(
        *args, tuple(torch.softmax(ll, dim=1) for ll in lls), **kw),
        fl.fused_linear_single_plain(*args, **kw)))
    torch.cuda.synchronize()
    assert gk.LAUNCHES["fused_linear_wide_pass1"] == \
        before["fused_linear_wide_pass1"] + 1
    assert gk.LAUNCHES["fused_linear_wide_pass2"] == \
        before["fused_linear_wide_pass2"] + 2
    for got, want in pairs:
        tol = 1e-4 * max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= tol


@pytest.mark.parametrize("streams", [(4, 4), (4, 5)])
def test_wide_pass1_is_bitwise_reproducible(cuda, streams):
    """Two calls of wide pass 1 give bitwise-identical outputs (no atomics,
    fixed-order float64 sums), shared and separate noise streams."""
    args = _fused_args(cuda, p=5, d=128, n=100)
    kw = {**_FUSED_KW, "model": LinearGaussian(n_vars=128), "n_samples": 32,
          "streams": streams}
    first = fl.fused_linear_pass1(*args, **kw)
    second = fl.fused_linear_pass1(*args, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("d,n", [(128, 100), (71, 1), (75, 600), (602, 30),
                                 (128, 10_000), (300, 100)])
def test_wide_pass1_footprint_and_group_agree_with_the_kernel(cuda, d, n):
    """The launcher's pass-1 footprint and group (C) are the wrapper's
    (Python)."""
    lib = gk.build()
    plan = fl.fused_linear_wide_pass1_plan(1, d, n)
    assert lib.dibs_fused_linear_wide_pass1_group(d, plan.tile_rows) == \
        plan.group
    for group in (1, 2, 4):
        assert lib.dibs_fused_linear_wide_pass1_smem_bytes(
            d, plan.tile_rows, group) == \
            fl.fused_linear_wide_pass1_smem_bytes(d, plan.tile_rows, group)


@pytest.mark.parametrize("streams", [(4, 4), (4, 5)])
def test_wide_pass2_is_bitwise_reproducible(cuda, streams):
    """Two calls of wide pass 2 give bitwise-identical outputs (no atomics,
    each output element written by one block, shuffle sums in a fixed
    tree), shared and separate noise streams."""
    args = _fused_args(cuda, p=5, d=128, n=100)
    kw = {**_FUSED_KW, "model": LinearGaussian(n_vars=128), "n_samples": 32,
          "streams": streams}
    weights = tuple(torch.softmax(ll, dim=1)
                    for ll in fl.fused_linear_pass1(*args, **kw))
    first = fl.fused_linear_pass2(*args, weights, **kw)
    second = fl.fused_linear_pass2(*args, weights, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("d,n", [(128, 100), (71, 1), (75, 600), (602, 30),
                                 (128, 10_000), (300, 100), (652, 1)])
def test_wide_pass2_plan_agrees_with_the_kernel(cuda, d, n):
    """The launcher's pass-2 footprint (C) is the wrapper's plan (Python)."""
    lib = gk.build()
    plan = fl.fused_linear_wide_pass2_plan(1, d, n)
    assert lib.dibs_fused_linear_wide_pass2_smem_bytes(d, plan.tile_rows) == \
        plan.smem_bytes


@pytest.mark.parametrize("d,n", chip_smoke.SHAPES_ROW_EDGES)
def test_row_tier_edges_match_plain_versions(cuda, d, n):
    """#5-#7 (the row tier) at its edges, d from 2 to 70 and N from one row
    to tiled rows, injected, Philox and shared-stream noise, within 1e-4
    max(1, max|ref|); two calls bitwise equal."""
    import numpy as np

    def err(name, got, ref):
        e = float((got - ref).abs().max())
        tol = 1e-4 * max(1.0, float(ref.abs().max()))
        assert e <= tol, (name, e, tol)
        return e / tol

    chip_smoke.check_row_edges(fl, cuda, np.random.default_rng(d * n), err,
                               [(d, n)])


@pytest.mark.parametrize("d,n", [(20, 100), (30, 600), (70, 10_000),
                                 (2, 1), (7, 129), (69, 128), (48, 100)])
def test_row_plan_agrees_with_the_kernel(cuda, d, n):
    """The launcher's footprint and register tiles (C) are the wrapper's
    plan (Python)."""
    lib = gk.build()
    plan = fl.fused_linear_row_plan(1, d, n, 128, 132)
    assert lib.dibs_fused_linear_row_smem_bytes(
        d, plan.tile_rows, plan.group, plan.sub_rows) == plan.smem_bytes
    for group in (1, 2, 4):
        assert lib.dibs_fused_linear_row_items(d, group) == \
            fl.fused_linear_row_items(d, group)


def _pass2_weights(kind, p, m, device):
    if kind == "uniform":  # every sample replayed
        uni = torch.full((p, m), 1.0 / m, device=device)
        return uni, uni
    hot = torch.zeros(p, m, device=device)
    hot[torch.arange(p), (3 * torch.arange(p)) % m] = 1.0
    if kind == "one-hot":  # one sample a particle, another one hard
        return hot, hot.roll(1, dims=1)
    hot[1:] = 0.0  # all but particle 0 at zero weight
    return hot, hot.roll(2, dims=1)


@pytest.mark.parametrize("kind,p,d,n,m", [
    ("uniform", 3, 128, 100, 32), ("one-hot", 4, 128, 100, 32),
    ("one-particle", 4, 128, 100, 32), ("uniform", 2, 75, 300, 37),
    ("one-hot", 3, 100, 200, 64), ("uniform", 2, 72, 16, 64)])
def test_wide_pass2_weight_edges(cuda, kind, p, d, n, m):
    """Wide pass 2 against its plain version at the weights' edges (all
    samples replayed, one a particle, one particle only) and past one
    32-sample ballot (M = 37, 64), within 1e-4 max(1, max|ref|)."""
    args = _fused_args(cuda, p=p, d=d, n=n)
    kw = {**_FUSED_KW, "model": LinearGaussian(n_vars=d), "n_samples": m,
          "streams": (4, 5)}
    weights = _pass2_weights(kind, p, m, cuda)
    got = fl.fused_linear_pass2(*args, weights, **kw)
    want = fl.fused_linear_pass2_plain(*args, weights, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        tol = 1e-4 * max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= tol
    if kind == "one-particle":  # zero weights add exactly 0
        assert not got[0][1:].any() and not got[1][1:].any()


@pytest.mark.parametrize("kind,p,d,n,m", [
    ("uniform", 3, 20, 100, 128), ("one-hot", 4, 20, 100, 37),
    ("one-particle", 4, 30, 600, 64), ("uniform", 2, 7, 129, 37),
    ("one-hot", 3, 70, 100, 9), ("one-particle", 3, 2, 1, 33)])
def test_row_pass2_weight_edges(cuda, kind, p, d, n, m):
    """The row tier's pass 2 (#7, d <= 70), which replays only samples with
    a non-zero weight, against its plain version at the weights' edges and
    past one 32-sample ballot, within 1e-4 max(1, max|ref|); particles at
    zero weight get exactly 0."""
    args = _fused_args(cuda, p=p, d=d, n=n)
    kw = {**_FUSED_KW, "model": LinearGaussian(n_vars=d), "n_samples": m,
          "streams": (4, 5)}
    weights = _pass2_weights(kind, p, m, cuda)
    got = fl.fused_linear_pass2(*args, weights, **kw)
    want = fl.fused_linear_pass2_plain(*args, weights, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        tol = 1e-4 * max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= tol
    if kind == "one-particle":
        assert not got[0][1:].any() and not got[1][1:].any()


@pytest.mark.parametrize("p,d,n,h1,blocks,m,activation",
                         chip_smoke.SHAPES_NL_EDGES)
def test_fused_nonlinear_gate_edges(cuda, p, d, n, h1, blocks, m,
                                    activation):
    """#8 at the gate's edges (the widest d at h1 = 5 and 16, N = 1, h1 = 1
    over tiled rows, the hidden widths rounded up to 16, 4 and 8) against
    its plain version within 1e-4 max(1, max|ref|), Philox noise on two
    streams, two calls bitwise equal."""
    import numpy as np

    args = chip_smoke.nonlinear_problem(np.random.default_rng(d), cuda, p, d,
                                        n, h1, blocks)
    model = DenseNonlinearGaussian(n_vars=d, hidden_layers=(h1,),
                                   activation=activation)
    kw = dict(seed=3, streams=(4, 5), alpha=1.3, tau=0.9, n_samples=m,
              model=model)
    chip_smoke.check_fused_nonlinear(fnl, args, kw, f"d={d} h1={h1} N={n}")


@pytest.mark.parametrize("d,h1,n", [(20, 5, 100), (30, 5, 600), (40, 5, 100),
                                    (22, 16, 100), (23, 16, 1), (67, 1, 37),
                                    (13, 7, 130)])
def test_fused_nonlinear_plan_agrees_with_the_kernel(cuda, d, h1, n):
    """The launcher's footprint (C) is the wrapper's plan (Python)."""
    lib = gk.build()
    plan = fnl.fused_nonlinear_plan(d, h1, n)
    assert plan.ranks == 1
    assert lib.dibs_fused_nonlinear_smem_bytes(d, h1, *plan[:4], n) == \
        plan.smem_bytes


# #8's cluster build (kCluster): every (d, N, h1) of d = 41,
# 50, 64, N = 1, 30, 100, 600 and h1 = 1, 5, 16 that the one-block tier
# declines and a cluster plan holds (h1 = 1 never leaves the one-block tier
# there), plus h1 = 1 at d = 80 and h1 = 7 at d = 50, so that the kernels of
# every hidden width (5 exact; 4, 8, 16 padded) run; each activation
CLUSTER_SHAPES = [(d, n, h1) for d in (41, 50, 64) for n in (1, 30, 100, 600)
                  for h1 in (1, 5, 16)
                  if fnl.fused_nonlinear_tile_rows(d, h1, n) is None
                  and fnl.fused_nonlinear_plan(d, h1, n) is not None
                  ] + [(80, 100, 1), (50, 100, 7)]
CLUSTER_CASES = [(*s, act) for s in CLUSTER_SHAPES
                 for act in ("relu", "tanh", "sigmoid", "leakyrelu")]


@pytest.mark.parametrize("d,n,h1,activation", CLUSTER_CASES,
                         ids=lambda v: str(v))
def test_fused_nonlinear_cluster_tier_matches_plain(cuda, d, n, h1,
                                                    activation):
    """The cluster tier against #8's plain version within 1e-4 max(1,
    max|ref|), with Philox noise on two streams and with injected noise;
    two calls bitwise equal. A fault poisons the process's CUDA context:
    on a new build run a case alone by its node id."""
    assert fnl.fused_nonlinear_tile_rows(d, h1, n) is None
    rng = np.random.default_rng(1000 * d + 10 * n + h1)
    p, m = 3, 9
    args = chip_smoke.nonlinear_problem(rng, cuda, p, d, n, h1,
                                        5 if n == 600 else 0)
    model = DenseNonlinearGaussian(n_vars=d, hidden_layers=(h1,),
                                   activation=activation)
    for noise in ("philox", "injected"):
        kw = dict(seed=7, streams=(4, 5), alpha=1.3, tau=0.9, n_samples=m,
                  model=model)
        if noise == "injected":
            kw["eps"] = (chip_smoke.logistic(rng, (p, m, d, d)).to(cuda),
                         chip_smoke.logistic(rng, (p, m, d, d)).to(cuda))
        chip_smoke.check_fused_nonlinear(
            fnl, args, kw, f"cluster d={d} N={n} h1={h1} {activation} {noise}")


@pytest.mark.parametrize("d,h1,n", [(50, 5, 100), (41, 16, 30), (64, 5, 600),
                                    (80, 1, 100), (50, 7, 100)])
@pytest.mark.parametrize("ranks", [None, 2, 4, 8])
def test_fused_nonlinear_cluster_plan_agrees_with_the_kernel(cuda, d, h1, n,
                                                             ranks):
    """The launcher's rank footprint (C) is the wrapper's cluster plan
    (Python), for the rule's plan and each cluster size's."""
    lib = gk.build()
    plan = (fnl.fused_nonlinear_plan(d, h1, n) if ranks is None
            else chip_smoke.cluster_plan_at(fnl, d, h1, n, ranks))
    if plan is None:
        assert ranks is not None
        return
    assert plan.ranks > 1
    assert lib.dibs_fused_nonlinear_smem_bytes(
        d, h1, *plan[:4], n) == plan.smem_bytes


@pytest.mark.parametrize("d,ranks", [(50, 2), (50, 4), (50, 8), (20, 1),
                                     (20, 2), (20, 4)])
def test_fused_nonlinear_cluster_sizes_agree(cuda, monkeypatch, d, ranks):
    """Config 7's shape (d = 50, N = 100, h1 = 5) on clusters of 2, 4 and 8
    ranks, and config 3's (d = 20) on one block and on clusters of 2 and 4:
    the one kernel body at each rank count against the plain version within
    1e-4 max(1, max|ref|), two calls bitwise equal."""
    rng = np.random.default_rng(d)
    args = chip_smoke.nonlinear_problem(rng, cuda, 4, d, 100, 5, 0)
    plan = chip_smoke.cluster_plan_at(fnl, d, 5, 100, ranks)
    assert plan is not None and plan.ranks == ranks
    monkeypatch.setattr(fnl, "fused_nonlinear_plan", lambda d, h1, n: plan)
    kw = dict(seed=11, streams=(6, 6), alpha=0.6, tau=1.0, n_samples=12,
              model=DenseNonlinearGaussian(n_vars=d, hidden_layers=(5,)))
    chip_smoke.check_fused_nonlinear(fnl, args, kw, f"d={d} ranks={ranks}")


def test_fused_nonlinear_cluster_counters(cuda):
    """While a profiler records, a cluster-tier call counts
    ``fused_nl_cluster.calls`` 1 and ``.ranks`` its plan's cluster size; a
    one-block call counts neither. A JointDiBS step at d = 50 takes the
    cluster tier (no fallback warning): one call and one cluster a step,
    beside ``mlp_lik.pairs`` 2 P M."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from dibs_tpu_torch import profiling
    from dibs_tpu_torch.inference import JointDiBS
    from dibs_tpu_torch.models import ScaleFreeDAGDistribution

    rng = np.random.default_rng(3)
    kw = dict(seed=1, streams=(2, 2), alpha=1.0, tau=1.0, n_samples=5)
    small = chip_smoke.nonlinear_problem(rng, cuda, 2, 20, 100, 5, 0)
    big = chip_smoke.nonlinear_problem(rng, cuda, 2, 50, 100, 5, 0)
    ranks = fnl.fused_nonlinear_plan(50, 5, 100).ranks
    with profile(activities=[ProfilerActivity.CPU]):
        fnl.fused_nonlinear(*small, model=DenseNonlinearGaussian(
            n_vars=20, hidden_layers=(5,)), **kw)
        for _ in range(2):
            fnl.fused_nonlinear(*big, model=DenseNonlinearGaussian(
                n_vars=50, hidden_layers=(5,)), **kw)
        torch.cuda.synchronize()
    assert profiling.counters() == {"fused_nl_cluster.calls": 2,
                                    "fused_nl_cluster.ranks": 2 * ranks}

    p, m, steps = 4, 6, 3
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        dibs = JointDiBS(
            x=torch.randn(100, 50, generator=torch.Generator().manual_seed(0)
                          ).to(cuda),
            graph_model=ScaleFreeDAGDistribution(50),
            likelihood_model=DenseNonlinearGaussian(n_vars=50,
                                                    hidden_layers=(5,)),
            n_grad_mc_samples=m, n_acyclicity_mc_samples=2)
    launches = gk.LAUNCHES["fused_nonlinear"]
    with profile(activities=[ProfilerActivity.CPU]):
        dibs.sample(seed=1, n_particles=p, steps=steps)
        torch.cuda.synchronize()
    counts = profiling.counters()
    assert gk.LAUNCHES["fused_nonlinear"] - launches == steps
    assert counts["fused_nl_cluster.calls"] == steps
    assert counts["fused_nl_cluster.ranks"] == steps * ranks
    assert counts["mlp_lik.pairs"] == steps * 2 * p * m
