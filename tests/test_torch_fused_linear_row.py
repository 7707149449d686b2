"""Host-side sizing of the row tier of the fused linear-Gaussian kernels
(#5-#7 at d <= 70, ``fused_linear_kernel`` in ``csrc/fused_linear.cu``):
the launch plan, its shared-memory footprint region by region, and the gate
(``fused_linear_tile_rows``), which keeps its old measure so that the served
(d, N) do not change. The wrapper computes the plan in Python and the
kernel's launcher checks it in C (the card-side agreement is
``tests/test_torch_cuda.py``). Runs on the CPU: no kernel is launched.
"""
import numpy as np
import pytest
import torch

from dibs_tpu_torch.inference import fused_linear as fl
from dibs_tpu_torch.models import LinearGaussian

torch.set_num_threads(1)

MAX_SMEM = 232448  # 227 KB, the most one block can use on an H100
TWO_PER_SM = 233472 // 2 - 1024  # two blocks in an SM's 228 KB
SMS = 132  # an H100 SXM
DS = range(1, 73)
NS = (1, 8, 30, 100, 128, 129, 600, 10_000)


def footprint(d, tile_rows, group, sub_rows):
    """The kernel's layout, region by region (bytes)."""
    dp, ldn, combos = -(-d // 4) * 4, -(-tile_rows // 4) * 4, 2 * group
    head = 8 * (2 * 8 * 8 + 8) + 64  # float64 slots, the group's indices
    a_or_dw = 4 * d * combos * dp  # A, then x^T resid, of the group
    x_t = 4 * d * ldn  # the data tile, transposed
    tiles = 4 * 3 * ldn * dp  # x, w, resid_ref
    resid = 4 * combos * sub_rows * dp  # one chunk's residuals
    mats = 4 * 6 * d * d  # alpha s, E[G], Theta, logN(Theta), 2 accumulators
    samples = 4 * combos * d * d  # the group's soft and hard samples
    return head + a_or_dw + x_t + tiles + resid + mats + samples


def old_gate(d, n):
    """The row tier's first footprint: 11 [d, d] matrices and 5 data tiles
    of up to 128 rows, halved down to 8, within 227 KB."""
    def fits(tile):
        return 144 + 4 * (11 * d * d + 5 * tile * d) <= MAX_SMEM

    tile = min(n, 128)
    while not fits(tile) and tile > 8:
        tile = max(8, tile // 2)
    return tile if fits(tile) else None


def test_config2_plan():
    """Config 2 (P=30, d=20, N=100, M=128): all rows resident, groups of 4,
    chunks of 64 rows, 109,312 B (two blocks an SM), 30 x 8 blocks of 16
    samples."""
    plan = fl.fused_linear_row_plan(30, 20, 100, 128, SMS)
    assert plan == fl.RowPlan(100, 4, 64, 109_312, (30, 8), 16)
    assert plan.smem_bytes == footprint(20, 100, 4, 64) <= TWO_PER_SM


def test_config4_plan():
    """Config 4's shape (P=20, d=30, N=600, M=128): 64-row tiles, groups of
    2, chunks of 32 rows, 101,152 B (two blocks an SM), 20 x 13 blocks of
    10 samples."""
    plan = fl.fused_linear_row_plan(20, 30, 600, 128, SMS)
    assert plan == fl.RowPlan(64, 2, 32, 101_152, (20, 13), 10)
    assert plan.smem_bytes == footprint(30, 64, 2, 32) <= TWO_PER_SM


@pytest.mark.parametrize("d,tile_rows,group,sub_rows", [
    (20, 100, 4, 64), (30, 64, 2, 32), (70, 8, 1, 8), (1, 1, 4, 4),
    (7, 129, 4, 64), (69, 16, 1, 16), (33, 37, 2, 40), (48, 128, 2, 64)])
def test_footprint_formula(d, tile_rows, group, sub_rows):
    assert fl.fused_linear_row_smem_bytes(d, tile_rows, group, sub_rows) == \
        footprint(d, tile_rows, group, sub_rows)


@pytest.mark.parametrize("d,group,items", [
    (20, 4, 1), (30, 4, 2), (30, 2, 1), (40, 4, 4), (48, 4, 5), (48, 2, 3),
    (70, 1, 3), (70, 2, 6), (1, 4, 1)])
def test_register_tiles_a_thread(d, group, items):
    """x^T resid's (d/4)^2 4 x 4 tiles of one (sample, branch) over its team
    of 256 / (2 group) threads."""
    assert fl.fused_linear_row_items(d, group) == items


@pytest.mark.parametrize("n", NS)
def test_gate_is_unchanged(n):
    """``fused_linear_tile_rows`` keeps the first design's measure at every
    d from 1 to 72: the row tier serves d <= 70 for any N (more where the
    rows are few)."""
    for d in DS:
        assert fl.fused_linear_tile_rows(d, n) == old_gate(d, n), d
        if n >= 8:
            assert (old_gate(d, n) is not None) == (d <= 70), d
        if old_gate(d, n) is not None:
            assert fl.fused_linear_smem_bytes(d, old_gate(d, n)) == \
                144 + 4 * (11 * d * d + 5 * old_gate(d, n) * d)


@pytest.mark.parametrize("n", NS)
def test_plan_fits_wherever_the_gate_admits(n):
    """At every (d, N) the gate serves, the plan fits 227 KB with at most 4
    register tiles a thread; its tiles, groups and chunks are ones the
    launcher takes; its grid covers the M samples in chunks that are whole
    groups, within one wave of the blocks the footprint lets an SM hold."""
    for d in DS:
        for p, m in ((30, 128), (1, 9), (1000, 32)):
            plan = fl.fused_linear_row_plan(p, d, n, m, SMS)
            if fl.fused_linear_tile_rows(d, n) is None:
                continue
            assert plan is not None, (d, n)
            tile, group, sub = plan.tile_rows, plan.group, plan.sub_rows
            ldn = -(-tile // 4) * 4
            assert plan.smem_bytes == footprint(d, tile, group, sub) \
                <= MAX_SMEM
            assert fl.fused_linear_row_items(d, group) <= 4
            assert 1 <= tile <= min(n, 128) and group in (1, 2, 4)
            assert sub % 4 == 0 and 4 <= sub <= min(64, ldn)
            assert plan.chunk % group == 0
            assert plan.grid == (p, -(-m // plan.chunk))
            assert plan.chunk * plan.grid[1] >= m > plan.chunk * (
                plan.grid[1] - 1)
            per_sm = 2 if plan.smem_bytes <= TWO_PER_SM else 1
            assert p * plan.grid[1] <= max(p, per_sm * SMS)


@pytest.mark.parametrize("d,n,tile,group,sub", [
    (20, 100, 100, 4, 64), (30, 600, 64, 2, 32), (70, 10_000, 16, 1, 16),
    (70, 100, 12, 1, 12), (2, 1, 1, 4, 4), (7, 129, 128, 4, 64),
    (69, 600, 16, 1, 16), (40, 600, 32, 1, 32)])
def test_plan_values(d, n, tile, group, sub):
    """Tiles of at least min(N, 32) rows first, then two blocks an SM, then
    the largest group, chunk and tile."""
    plan = fl.fused_linear_row_plan(20, d, n, 128, SMS)
    assert (plan.tile_rows, plan.group, plan.sub_rows) == (tile, group, sub)


def test_grid_is_one_wave():
    """Config 2: two blocks an SM on 132 SMs hold 264 blocks, 8 chunks a
    particle; fewer SMs give fewer, longer chunks; more particles than the
    wave holds give one chunk a particle."""
    assert fl.fused_linear_row_plan(30, 20, 100, 128, 132).grid == (30, 8)
    assert fl.fused_linear_row_plan(30, 20, 100, 128, 66).grid == (30, 4)
    plan = fl.fused_linear_row_plan(1000, 20, 100, 128, 132)
    assert plan.grid == (1000, 1) and plan.chunk == 128


@pytest.mark.parametrize("seed,soft,hard", [(0, 3, 37), (1, 20, 20),
                                            (2, 39, 0)])
def test_pass2_skipping_zero_weights_is_exact(seed, soft, hard):
    """Pass 2's replay list: dropping the samples whose two weights are both
    exactly 0 leaves the plain pass 2 bitwise unchanged. The weights are the
    softmax of log-likelihoods ~200 nats apart, so all but one a branch
    underflow to exact 0 (the live samples sit in different 16-sample
    chunks of the plain loop in the two runs)."""
    rng = np.random.default_rng(seed)
    p, d, n, m = 1, 5, 7, 40

    def arr(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    scores, thetas, x = arr(p, d, d), arr(p, d, d), arr(n, d)
    w = torch.from_numpy((rng.uniform(size=(n, d)) > 0.2).astype(np.float32))
    u = rng.uniform(np.finfo(np.float32).tiny, 1.0, size=(2, p, m, d, d))
    eps = torch.from_numpy((np.log(u) - np.log1p(-u)).astype(np.float32))
    lls = -200.0 - 50.0 * torch.rand(2, p, m,
                                     generator=torch.Generator().manual_seed(
                                         seed))
    lls[0, :, soft] = 0.0
    lls[1, :, hard] = 0.0
    weights = tuple(torch.softmax(ll, dim=1) for ll in lls)
    assert all(int((wt != 0).sum()) == 1 for wt in weights)
    kw = dict(seed=0, streams=(0, 1), alpha=1.5, tau=0.8,
              model=LinearGaussian(n_vars=d))
    full = fl.fused_linear_pass2_plain(scores, thetas, x, w, weights,
                                       n_samples=m, eps=(eps[0], eps[1]),
                                       **kw)
    live = ((weights[0] != 0) | (weights[1] != 0))[0].nonzero()[:, 0]
    kept = fl.fused_linear_pass2_plain(
        scores, thetas, x, w, tuple(wt[:, live] for wt in weights),
        n_samples=len(live), eps=(eps[0][:, live], eps[1][:, live]), **kw)
    assert len(live) == len({soft, hard})
    for a, b in zip(full, kept):
        assert torch.equal(a, b)
        assert bool(a.abs().sum() > 0)
