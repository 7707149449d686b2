"""The work counters of the data-dependent kernels, on the card: #2's
histogram of parent counts and wide pass 2's replayed samples, counted by
the kernels while a profiler records, equal the counts made from the same
inputs with torch ops, and the outputs with the counters on are bitwise
those with them off.

Marked ``cuda``; every test skips where ``torch.cuda.is_available()`` is
false. Imports no JAX::

    python -m pytest tests/test_torch_cuda_profiling.py -m cuda -q --noconftest
"""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dibs_tpu_torch import profiling
from dibs_tpu_torch.inference import fused_linear as fl
from dibs_tpu_torch.models import BGe, LinearGaussian
from dibs_tpu_torch.ops import gpu_kernels as gk
from dibs_tpu_torch.ops.bge_kernel import bge_logdet_pairs

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.set_float32_matmul_precision("highest")
    gk.build()
    return torch.device("cuda:0")


def _counted(fn):
    """``fn()`` while a profiler records, and the window's counters."""
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
        torch.cuda.synchronize()
    return out, profiling.counters()


def _masks(d, b, density, seed, device):
    gen = torch.Generator().manual_seed(seed)
    gs = (torch.rand(b, d, d, generator=gen) < density).float()
    gs *= 1.0 - torch.eye(d)
    return gs.to(device)


@pytest.mark.parametrize("d,b,density,sets", [
    (20, 96, 0.3, 1), (32, 40, 0.5, 1), (64, 33, 0.2, 1), (128, 70, 0.4, 1),
    (128, 64, 0.05, 2), (20, 64, 0.3, 4)])
def test_bge_parent_histogram_is_the_masks(cuda, d, b, density, sets):
    """The warp kernel (d <= 32) and the bits pass (past it), one dataset
    and a fleet's: the histogram of k over every (graph, node) pair, the
    graphs and the calls; the pairs bitwise those of an uncounted call."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    x = torch.randn(sets, 100, d, generator=gen, device=cuda)
    r_mats, _ = BGe(n_vars=d, device=cuda)._posterior_r_mats(
        x, torch.zeros_like(x, dtype=torch.int32))
    r_mats = r_mats.reshape(sets, d, d, d).squeeze(0).contiguous()
    gs = _masks(d, b, density, d + b, cuda)
    off = bge_logdet_pairs(r_mats, gs)
    on, counts = _counted(lambda: bge_logdet_pairs(r_mats, gs))
    assert all(torch.equal(a, c) for a, c in zip(off, on))
    want = torch.bincount((gs != 0).sum(1).reshape(-1), minlength=d + 1)
    assert counts["bge_pairs.parents"] == want.tolist()
    assert counts["bge_pairs.graphs"] == b
    assert counts["bge_pairs.calls"] == 1


def test_bge_soft_masks_count_their_non_zero_entries(cuda):
    d = 64
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(100, d, generator=gen, device=cuda)
    r_mats, _ = BGe(n_vars=d, device=cuda)._posterior_r_mats(
        x, torch.zeros_like(x, dtype=torch.int32))
    gs = _masks(d, 8, 0.3, 5, cuda)
    gs[1] *= 0.75
    _, counts = _counted(lambda: bge_logdet_pairs(r_mats.contiguous(), gs))
    want = torch.bincount((gs != 0).sum(1).reshape(-1), minlength=d + 1)
    assert counts["bge_pairs.parents"] == want.tolist()


def _wide_args(device, p, d, n, datasets=1):
    gen = torch.Generator().manual_seed(p * d + n)
    lead = (datasets,) if datasets > 1 else ()
    return [torch.randn(shape, generator=gen).to(device)
            for shape in ((p, d, d), (p, d, d), (*lead, n, d),
                          (*lead, n, d))]


def _weights(p, m, kind, device):
    gen = torch.Generator().manual_seed(p + m)
    w = torch.softmax(torch.randn(p, m, generator=gen) * 40.0, dim=1)
    if kind == "sparse":  # most pairs exactly 0 in both
        w = torch.where(w > 0.05, w, torch.zeros_like(w))
    hard = w.roll(1, dims=1)
    hard[0] = 0.0
    return w.to(device), hard.to(device)


@pytest.mark.parametrize("kind,p,d,n,m,offset,datasets", [
    ("dense", 6, 128, 100, 32, 0, 1), ("sparse", 9, 128, 100, 32, 0, 1),
    ("sparse", 5, 75, 300, 37, 0, 1), ("sparse", 4, 100, 50, 64, 8, 1),
    ("sparse", 8, 80, 40, 32, 0, 2)])
def test_wide_pass2_replays_are_the_weights(cuda, kind, p, d, n, m, offset,
                                            datasets):
    """One dataset (tiled rows at N = 300, two ballots at M = 37 and 64),
    a shard's build and a fleet's: the replayed (particle, sample) pairs
    are those whose two weights are not both 0, one call counted; the
    outputs bitwise those of an uncounted call."""
    args = _wide_args(cuda, p, d, n, datasets)
    weights = _weights(p, m, kind, cuda)
    seed = (torch.arange(datasets, dtype=torch.int64, device=cuda) + 7
            if datasets > 1 else 7)
    kw = dict(seed=seed, streams=(4, 4), alpha=1.0, tau=1.0, n_samples=m,
              model=LinearGaussian(n_vars=d), particle_offset=offset)
    off = fl.fused_linear_pass2(*args, weights, **kw)
    on, counts = _counted(lambda: fl.fused_linear_pass2(*args, weights,
                                                        **kw))
    assert all(torch.equal(a, c) for a, c in zip(off, on))
    want = int(((weights[0] != 0) | (weights[1] != 0)).sum())
    assert counts["wide_pass2.replayed"] == want
    assert counts["wide_pass2.calls"] == 1


def test_no_counter_reaches_a_kernel_without_a_profiler(cuda, monkeypatch):
    """With no profiler the launchers pass null counters and no buffer
    is allocated."""
    profiling._reset()
    d, b = 64, 4
    x = torch.randn(100, d, device=cuda)
    r_mats, _ = BGe(n_vars=d, device=cuda)._posterior_r_mats(
        x, torch.zeros_like(x, dtype=torch.int32))
    seen = []
    real = gk.build()

    class Spy:
        def __getattr__(self, name):
            fn = getattr(real, name)
            if name not in ("dibs_bge_pairs", "dibs_fused_linear_wide"):
                return fn
            return lambda *a: seen.append((name, a[-1])) or fn(*a)

    monkeypatch.setattr("dibs_tpu_torch.ops.bge_kernel.build", lambda: Spy())
    monkeypatch.setattr(fl, "build", lambda: Spy())
    bge_logdet_pairs(r_mats.contiguous(), _masks(d, b, 0.3, 1, cuda))
    args = _wide_args(cuda, 2, 80, 30)
    fl.fused_linear_pass2(*args, _weights(2, 32, "dense", cuda), seed=1,
                          streams=(0, 0), alpha=1.0, tau=1.0, n_samples=32,
                          model=LinearGaussian(n_vars=80))
    torch.cuda.synchronize()
    assert sorted(seen) == [("dibs_bge_pairs", None),
                            ("dibs_fused_linear_wide", None)]
    assert profiling.counters() == {}
