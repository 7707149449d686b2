"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``cuda``; every test skips where ``torch.cuda.is_available()`` is
false. Imports no JAX, so it runs on a machine that has only torch
(``--noconftest`` skips ``tests/conftest.py``, which imports JAX)::

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

The checks are the kernel phases of ``chip_smoke.py`` (same shapes and
tolerances), plus the launch counters and the wrappers' input checks.
"""
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
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
