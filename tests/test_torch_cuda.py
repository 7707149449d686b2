"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``cuda``; every test skips where ``torch.cuda.is_available()`` is
false. Imports no JAX, so it runs on a machine that has only torch
(``--noconftest`` skips ``tests/conftest.py``, which imports JAX)::

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

The checks are the kernel phases of ``chip_smoke.py`` (same shapes and
tolerances, the fused linear-Gaussian kernels, the fused MLP kernel #8, the
fused transport kernel #4 and the fused acyclicity gradient #9 included), the
wide fused linear tier at small shapes, the ``'spectral'`` option and a
checkpoint round trip, plus the launch counters and the wrappers' input
checks.
"""
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from dibs_tpu_torch.inference import fused_linear as fl  # noqa: E402
from dibs_tpu_torch.inference import fused_nonlinear as fnl  # noqa: E402
from dibs_tpu_torch.models import (  # noqa: E402
    DenseNonlinearGaussian,
    LinearGaussian,
)
from dibs_tpu_torch.ops import gpu_kernels as gk  # noqa: E402
from dibs_tpu_torch.ops import transport_kernel as tk  # noqa: E402
from dibs_tpu_torch.ops.bge_kernel import bge_logdet_pairs  # noqa: E402

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
    N=600 (tiled rows), relu and tanh, injected and Philox noise, within
    1e-4 max(1, max|ref|)."""
    results = {}
    chip_smoke.phase_fused_nonlinear(cuda, results)
    assert set(results) == {"fused_nonlinear"}
    assert results["fused_nonlinear"]["ms"] > 0


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
    assert lib.dibs_fused_nonlinear_smem_bytes(20, 5, 25) == \
        fnl.fused_nonlinear_smem_bytes(20, 5, 25)


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
    torch.cuda.synchronize()
    assert gk.LAUNCHES == {k: v + 1 for k, v in before.items()}


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


@pytest.mark.parametrize("p,d,n", [(3, 72, 16), (2, 75, 300), (2, 130, 9)])
def test_wide_fused_tier_matches_plain_versions(cuda, p, d, n):
    """The wide tier (column tiles; ragged last tile, tiled rows at N=300)
    against the plain passes and the one-pass plain version."""
    args = _fused_args(cuda, p=p, d=d, n=n)
    kw = {**_FUSED_KW, "model": LinearGaussian(n_vars=d)}
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
