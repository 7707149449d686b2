"""The particle offset of the sharded port's kernels on the card.

Marked ``cuda``; every test skips where ``torch.cuda.is_available()`` is
false. Imports no JAX, so it runs on a machine that has only torch::

    python -m pytest tests/test_torch_cuda_parallel.py -m cuda -q --noconftest

Each kernel that takes ``particle_offset`` (#1 hard and soft, in runs of 4
and scalar; #5, #6 and #7 on the row tier at its edges and on the wide
tier; #8 through its shard build's gate edges and 16 instantiations) is
launched on 2, 3 and 4 shards of a batch, each at its first particle's
offset: the shards, concatenated, are bitwise one launch over the batch
(the shard at offset 0 through the single-dataset build, the others
through the shard build), and the last shard
matches the plain version at its offset (#1 hard exact off ties, soft
within 1e-5; #5-#8 within ``1e-4 max(1, max|ref|)``). #1 also takes
``sample_offset`` (the ``("p", "mc")`` mesh): its sample blocks are
bitwise one launch too. The phase-14 checks of ``chip_smoke.py`` at the
main paths' shapes are the same code.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from dibs_tpu_torch.fleet import fleet_seeds  # noqa: E402
from dibs_tpu_torch.inference import fused_linear as fl  # noqa: E402
from dibs_tpu_torch.models import LinearGaussian  # noqa: E402
from dibs_tpu_torch.ops import gpu_kernels as gk  # noqa: E402

pytestmark = pytest.mark.cuda

SPLITS = (2, 3, 4)
P_SHARDS = 12


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.set_float32_matmul_precision("highest")
    gk.build()
    return torch.device("cuda:0")


@pytest.mark.parametrize("hard, tau", [(True, 1.0), (False, 1.0),
                                        (False, 0.7)])
@pytest.mark.parametrize("d", [5, 20, 33])
def test_sampler_shards_are_one_launch(cuda, hard, tau, d):
    rng = np.random.default_rng(d)
    m = 9
    scores = torch.from_numpy((2.0 * rng.normal(size=(P_SHARDS, d, d)))
                              .astype(np.float32)).to(cuda)

    def launch(rows, off):
        return (gk.gumbel_graphs(scores[rows], 77, 3, 1.1, tau, m, hard,
                                 particle_offset=off),)

    (whole,) = chip_smoke.shards_bitwise(f"#1 d={d}", launch, P_SHARDS,
                                         SPLITS)
    rows, off = chip_smoke.last_shard(P_SHARDS, SPLITS)
    ref = gk.gumbel_graphs_plain(scores[rows], 77, 3, 1.1, tau, m, hard,
                                 particle_offset=off)
    diff = (whole[rows] - ref).abs()
    if hard:
        u = gk.philox_uniform(tuple(ref.shape), 77, 3, cuda, off)
        logit = torch.log(u) - torch.log1p(-u) + 1.1 * scores[rows][:, None]
        assert int(((diff > 0) & (logit.abs() >= 1e-5)).sum()) == 0
    else:
        assert float(diff.max()) <= 1e-5


@pytest.mark.parametrize("hard, tau", [(True, 1.0), (False, 1.0),
                                        (False, 0.7)])
@pytest.mark.parametrize("d", [5, 20, 33])
def test_sampler_sample_blocks_are_one_launch(cuda, hard, tau, d):
    """#1's sample-offset build (the ``("p", "mc")`` mesh): the samples'
    blocks, each at its first sample's offset, alone and with a particle
    offset, are bitwise one launch; the last block matches the plain
    version at its offset."""
    rng = np.random.default_rng(100 + d)
    m = 12
    scores = torch.from_numpy((2.0 * rng.normal(size=(P_SHARDS, d, d)))
                              .astype(np.float32)).to(cuda)
    args = (77, 3, 1.1, tau)
    whole = gk.gumbel_graphs(scores, *args, m, hard)
    for k in (2, 3, 4):
        n = m // k
        parts = [gk.gumbel_graphs(scores, *args, n, hard, sample_offset=j * n)
                 for j in range(k)]
        assert torch.equal(torch.cat(parts, dim=1), whole)
        per = P_SHARDS // k
        for r in range(k):
            rows = slice(r * per, (r + 1) * per)
            got = gk.gumbel_graphs(scores[rows], *args, n, hard,
                                   particle_offset=r * per,
                                   sample_offset=(k - 1) * n)
            assert torch.equal(got, whole[rows, (k - 1) * n:])
    ref = gk.gumbel_graphs_plain(scores, *args, 3, hard, sample_offset=9)
    diff = (whole[:, 9:] - ref).abs()
    if hard:
        u = gk.philox_uniform(tuple(ref.shape), 77, 3, cuda,
                              sample_offset=9)
        logit = torch.log(u) - torch.log1p(-u) + 1.1 * scores[:, None]
        assert int(((diff > 0) & (logit.abs() >= 1e-5)).sum()) == 0
    else:
        assert float(diff.max()) <= 1e-5


def test_an_offset_with_fleet_keys_is_refused(cuda):
    scores = torch.zeros((4, 5, 5), device=cuda)
    keys = fleet_seeds(0, 2).to(cuda)
    with pytest.raises(ValueError, match="particle_offset"):
        gk.gumbel_graphs(scores, keys, 1, 1.0, 1.0, 3, True,
                         particle_offset=2)


@pytest.mark.parametrize("streams", [(4, 4), (4, 5)])
@pytest.mark.parametrize("d,n", [(2, 100), (20, 100), (70, 129), (71, 100),
                                 (128, 100)])
def test_fused_linear_shards_are_one_launch(cuda, d, n, streams):
    rng = np.random.default_rng(d * 1000 + n)
    m = 9
    scores, thetas, x, w = chip_smoke.fused_problem(rng, cuda, P_SHARDS, d,
                                                    n, 0)
    kw = dict(seed=5, streams=streams, alpha=0.8, tau=1.0, n_samples=m,
              model=LinearGaussian(n_vars=d))
    wts = tuple(torch.softmax(ll, dim=1) for ll in fl.fused_linear_pass1(
        scores, thetas, x, w, **kw))
    calls = [(fl.fused_linear_pass1, fl.fused_linear_pass1_plain, ()),
             (fl.fused_linear_pass2, fl.fused_linear_pass2_plain, (wts,))]
    if d <= 70:
        calls.append((fl.fused_linear_single, fl.fused_linear_single_plain,
                       ()))
    rows, off = chip_smoke.last_shard(P_SHARDS, SPLITS)
    for kern, plain, extra in calls:
        def launch(r, o, fn=kern):
            return fn(scores[r], thetas[r], x, w,
                      *(tuple(t[r] for t in e) for e in extra),
                      particle_offset=o, **kw)

        whole = chip_smoke.shards_bitwise(f"{kern.__name__} d={d} N={n}",
                                          launch, P_SHARDS, SPLITS)
        for got, want in zip(whole, launch(rows, off, plain)):
            tol = 1e-4 * max(1.0, float(want.abs().max()))
            assert float((got[rows] - want).abs().max()) <= tol


@pytest.mark.parametrize("case", chip_smoke.SHARD_NL_CASES,
                         ids=lambda c: f"d{c[1]}-n{c[2]}-h{c[3]}-{c[6]}")
def test_fused_nonlinear_shards_are_one_launch(cuda, case):
    """#8 through its shard build's gate edges and 16 instantiations (a
    failing #8 launch poisons the process's CUDA context: run a case alone
    by its node id to isolate it)."""
    assert chip_smoke.shard_nonlinear(cuda, case, str(case)) <= 1.0


@pytest.mark.parametrize("case", [(12, 50, 100, 5, 0, 5, "relu"),
                                  (12, 41, 30, 16, 0, 5, "sigmoid"),
                                  (12, 80, 100, 1, 0, 5, "tanh"),
                                  (12, 50, 100, 7, 0, 5, "leakyrelu")],
                         ids=lambda c: f"d{c[1]}-n{c[2]}-h{c[3]}-{c[6]}")
def test_fused_nonlinear_cluster_shards_are_one_launch(cuda, case):
    """#8's cluster tier through its shard build: 2, 3 and 4 shards bitwise
    one launch, the last shard against the plain version at its offset."""
    assert chip_smoke.shard_nonlinear(cuda, case, str(case)) <= 1.0
