"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``cuda``; every test skips where ``torch.cuda.is_available()`` is
false. Imports no JAX, so it runs on a machine that has only torch
(``--noconftest`` skips ``tests/conftest.py``, which imports JAX)::

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

The checks are the kernel phases of ``chip_smoke.py`` (same shapes and
tolerances, the fused linear-Gaussian kernels and the fused MLP kernel #8
included), plus the launch counters and the wrappers' input checks.
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
    lib = gk.build()
    assert lib.dibs_fused_linear_smem_bytes(30, 128) == \
        fl.fused_linear_smem_bytes(30, 128)
