"""Host-side sizing of kernel #8 (``fused_nl_kernel`` in
``csrc/fused_nonlinear.cu``): the plan (blocks a particle, samples a group,
rows of u_h staged at once, data rows a tile), its shared-memory footprint,
the one-wave grid, and that the plan fits wherever the gate serves. The wrapper computes the
plan in Python and the launcher checks it against its own arithmetic in C
(the card-side agreement is ``tests/test_torch_cuda.py``). Runs on the CPU:
no kernel is launched.
"""
import pytest
import torch

from dibs_tpu_torch.inference import fused_nonlinear as fnl
from dibs_tpu_torch.models import DenseNonlinearGaussian

torch.set_num_threads(1)

MAX_SMEM = 232448  # 227 KB, the most one block can use on an H100
THREADS = 512  # a fused_nl_kernel block


def footprint(d, h1, group, sub_rows, tile_rows, n_obs):
    """The kernel's layout, region by region (bytes), restated from
    ``csrc/fused_nonlinear.cu``."""
    ldt = -(-tile_rows // 4) * 4
    ldx = -(-d // 4) * 4
    hs = h1 if h1 % 2 else h1 + 1  # odd stride of the hidden unit
    regions = {
        "float64 partials": 8 * (THREADS + 16 * 4),
        "x^T": 4 * d * ldt,
        "x, twice where tiled": 4 * tile_rows * ldx * (
            2 if tile_rows < n_obs else 1),
        "u_h stage": 4 * 2 * (2 * group) * sub_rows * d * hs,
        "w, resid_ref": 4 * 2 * tile_rows * d,
        "pre_ref": 4 * tile_rows * d * hs,
        "alpha s, E[G], L1": 4 * 3 * d * d,
        "W1, W2": 4 * (d * d * hs + h1 * d),
        "accumulators": 4 * ((1 + h1) * d * d + (2 * h1 + 1) * d),
        "samples, x^T u sums": 4 * group * (3 + h1) * d * d,
        "row sums, dll": 4 * ((2 * h1 + 1) * THREADS // 2 + 4),
    }
    return sum(regions.values())


def test_config3_plan():
    """Config 3 (d=20, h1=5, N=100): all 100 rows resident, groups of 2,
    u_h staged in 5 sub-tiles of 20 rows (80 (sample, stream, column)
    combos x 6 row lanes; 25 row quads in 5 rounds), 201,168 B: one block
    an SM."""
    plan = fnl.fused_nonlinear_plan(20, 5, 100)
    assert plan == fnl.NonlinearPlan(1, 2, 20, 100, 201_168)
    assert plan.smem_bytes == footprint(20, 5, 2, 20, 100, 100)
    assert 2 * plan.smem_bytes > MAX_SMEM


def test_d30_n600_plan():
    """d=30, N=600 (config 4's shape): the rows do not fit; 16-row tiles
    loaded once per group of 2 samples, 222,064 B."""
    plan = fnl.fused_nonlinear_plan(30, 5, 600)
    assert plan == fnl.NonlinearPlan(1, 2, 16, 16, 222_064)
    assert plan.smem_bytes == footprint(30, 5, 2, 16, 16, 600)


@pytest.mark.parametrize("d,h1,group,sub_rows,tile_rows,n", [
    (20, 5, 2, 20, 100, 100), (30, 5, 2, 16, 16, 600), (1, 1, 2, 4, 1, 1),
    (7, 3, 1, 36, 13, 13), (22, 16, 1, 8, 16, 100), (67, 1, 1, 12, 12, 37),
    (13, 7, 2, 36, 72, 130), (40, 5, 1, 24, 24, 24)])
def test_footprint_formula(d, h1, group, sub_rows, tile_rows, n):
    assert fnl.fused_nonlinear_plan_smem_bytes(
        d, h1, group, sub_rows, tile_rows, n) == footprint(
            d, h1, group, sub_rows, tile_rows, n)


@pytest.mark.parametrize("d,h1,n", [
    (20, 5, 100), (30, 5, 600), (40, 5, 100), (41, 5, 1), (22, 16, 100),
    (23, 16, 1), (67, 1, 37), (68, 1, 1), (13, 7, 130), (1, 1, 1),
    (20, 5, 10_000)])
def test_plan_rules(d, h1, n):
    """One block; groups of 2 where two samples' (sample, stream, column)
    combos fit 512 threads, else 1; sub-tiles of whole row quads, at most one
    round of the row lanes; the data resident where it fits, else tiles of
    whole sub-tiles below N; the footprint fits one block."""
    plan = fnl.fused_nonlinear_plan(d, h1, n)
    assert plan is not None
    ranks, group, sub, tile = plan[:4]
    assert ranks == 1
    lanes = THREADS // (2 * group * d)
    assert group in (1, 2) and 2 * group * d <= THREADS
    assert sub % 4 == 0 and 4 <= sub <= 4 * lanes
    assert plan.smem_bytes == footprint(d, h1, group, sub, tile, n) \
        <= MAX_SMEM
    if tile < n:  # a larger tile of whole sub-tiles would not fit
        assert tile % sub == 0
        assert footprint(d, h1, group, sub, tile + sub, n) > MAX_SMEM
    if group == 1:  # two samples' combos, or their footprint, do not fit
        assert 4 * d > THREADS or footprint(d, h1, 2, 4, min(n, 4), n) \
            > MAX_SMEM


@pytest.mark.parametrize("h1,d_max", [(1, 67), (5, 40), (16, 22)])
def test_gate_edges_are_served(h1, d_max):
    """The widest d the gate serves at N=100 (and, at N=1, one more) has a
    plan; one past it is declined, as before the redesign."""
    for n, d in ((100, d_max), (1, d_max + 1)):
        model = DenseNonlinearGaussian(n_vars=d, hidden_layers=(h1,))
        assert fnl.fused_nonlinear_available(model, n)
        assert fnl.fused_nonlinear_plan(d, h1, n) is not None
        wider = DenseNonlinearGaussian(n_vars=d + 1, hidden_layers=(h1,))
        assert not fnl.fused_nonlinear_available(wider, n)


@pytest.mark.parametrize("n", [1, 2, 5, 8, 9, 31, 100, 129, 600, 4097])
def test_plan_fits_wherever_the_gate_serves(n):
    """Every (d, h1) the gate serves at this N has a plan: the redesign
    declines no shape the kernel served."""
    for h1 in range(1, 17):
        for d in range(1, 80):
            if fnl.fused_nonlinear_tile_rows(d, h1, n) is None:
                continue
            plan = fnl.fused_nonlinear_plan(d, h1, n)
            assert plan is not None, (d, h1, n)
            assert plan.smem_bytes <= MAX_SMEM


@pytest.mark.parametrize("p,m,n_sms,chunk", [
    (30, 128, 132, 32),   # config 3: 4 chunks a particle, 120 blocks
    (20, 128, 132, 22),   # d=30, N=600: 6 chunks, 120 blocks
    (30, 128, 114, 43),   # a card with 114 SMs: 3 chunks, 90 blocks
    (1, 5, 132, 5),       # at least 4 samples a block: one chunk
    (1, 9, 132, 5),       # two chunks of at least 4
    (200, 16, 132, 16),   # more particles than SMs: one chunk each
])
def test_grid_fills_one_wave(p, m, n_sms, chunk):
    """One block an SM, so the grid is at most one wave of SMs."""
    assert fnl._chunk(p, m, n_sms) == chunk
    n_split = -(-m // chunk)
    assert p * n_split <= max(p, n_sms)


# --- the cluster build (kCluster): shapes past the one-block measure, each
# particle's node columns split over a thread-block cluster ---

CLUSTER_RANKS = (2, 4, 8)


def rank_footprint(d, h1, ranks, group, sub_rows, tile_rows, n_obs):
    """One rank's layout, restated from ``csrc/fused_nonlinear.cu``
    (``smem_bytes`` at ``ranks`` > 1): the double-buffered float64 exchange
    slots, then the one-block regions with every node-column axis cut to
    ``ceil(d / ranks)``; x stays whole."""
    cols = -(-d // ranks)
    ldt = -(-tile_rows // 4) * 4
    ldx = -(-d // 4) * 4
    hs = h1 if h1 % 2 else h1 + 1
    regions = {
        "dll exchange slots": 8 * 2 * 4,
        "float64 partials": 8 * (THREADS + 16 * 4),
        "x^T": 4 * d * ldt,
        "x, twice where tiled": 4 * tile_rows * ldx * (
            2 if tile_rows < n_obs else 1),
        "u_h stage": 4 * 2 * (2 * group) * sub_rows * cols * hs,
        "w, resid_ref": 4 * 2 * tile_rows * cols,
        "pre_ref": 4 * tile_rows * cols * hs,
        "alpha s, E[G], L1": 4 * 3 * d * cols,
        "W1, W2": 4 * (d * cols * hs + h1 * cols),
        "accumulators": 4 * ((1 + h1) * d * cols + (2 * h1 + 1) * cols),
        "samples, x^T u sums": 4 * group * (3 + h1) * d * cols,
        "row sums, dll": 4 * ((2 * h1 + 1) * THREADS // 2 + 4),
    }
    return sum(regions.values())


def old_plan(d, h1, n):
    """The one-block plan search as it was before clusters (the served
    shapes and plans must not move)."""
    def smem(group, sub, tile):
        return footprint(d, h1, group, sub, tile, n)

    quads = -(-n // 4)
    groups = [g for g in range(2, 0, -1) if 2 * g * d <= THREADS]
    for group in groups:
        lanes = THREADS // (2 * group * d)
        first = 4 * -(-quads // -(-quads // lanes))
        for sub in range(first, 0, -4):
            if smem(group, sub, n) <= MAX_SMEM:
                return (group, sub, n, smem(group, sub, n))
    for group in groups:
        lanes = THREADS // (2 * group * d)
        for sub in range(min(4 * lanes, 4 * quads), 0, -4):
            base = smem(group, sub, 0)
            per_row = smem(group, sub, 4) - base
            fit = (MAX_SMEM - base) // per_row * 4 if base < MAX_SMEM else 0
            tile = min((n - 1) // sub, fit // sub) * sub
            if tile >= sub:
                return (group, sub, tile, smem(group, sub, tile))
    return None


@pytest.fixture
def cluster_card(monkeypatch):
    """A CUDA device that launches clusters, as the gate sees it."""
    monkeypatch.setattr(fnl, "_cluster_launch",
                        lambda device: device is not None
                        and torch.device(device).type == "cuda")
    return "cuda"


@pytest.mark.parametrize("d,h1,ranks,group,sub_rows,tile_rows,n", [
    (50, 5, 4, 2, 28, 100, 100), (50, 5, 2, 2, 12, 12, 100),
    (50, 5, 8, 2, 52, 100, 100), (41, 16, 4, 1, 16, 30, 30),
    (64, 5, 2, 1, 8, 8, 600), (41, 5, 2, 2, 4, 1, 1),
    (80, 1, 2, 2, 20, 100, 100), (50, 7, 8, 1, 8, 16, 600)])
def test_cluster_footprint_formula(d, h1, ranks, group, sub_rows, tile_rows,
                                   n):
    assert fnl.fused_nonlinear_plan_smem_bytes(
        d, h1, group, sub_rows, tile_rows, n, ranks) == rank_footprint(
            d, h1, ranks, group, sub_rows, tile_rows, n)


@pytest.mark.parametrize("n", [1, 2, 5, 9, 30, 100, 129, 600, 4097])
def test_one_block_tier_is_unchanged(n):
    """The shapes served by one block and their plans are those of the
    search before clusters; past the one-block measure a plan is a
    cluster's."""
    for h1 in range(1, 17):
        for d in range(1, 90):
            want = old_plan(d, h1, n) \
                if fnl.fused_nonlinear_tile_rows(d, h1, n) is not None \
                else None
            got = fnl.fused_nonlinear_plan(d, h1, n)
            if want is not None:
                assert got == fnl.NonlinearPlan(1, *want), (d, h1, n)
                assert fnl.fused_nonlinear_plan_smem_bytes(
                    d, h1, *got[1:4], n) == footprint(d, h1, *got[1:4], n)
            elif got is not None:
                assert got.ranks in CLUSTER_RANKS, (d, h1, n, got)


@pytest.mark.parametrize("n", [1, 2, 5, 8, 9, 30, 31, 100, 129, 600, 4097])
def test_cluster_gate_serves_only_with_a_plan_that_fits(cluster_card, n):
    """Every (d, h1) the gate serves on a cluster card past the one-block
    measure has a cluster plan of 2, 4 or 8 ranks whose rank fits 227 KB,
    groups and lanes within the block's 512 threads; the reference's block
    fits too."""
    served = 0
    for h1 in range(1, 17):
        for d in range(2, 257, 3 if h1 > 1 else 1):
            model = DenseNonlinearGaussian(n_vars=d, hidden_layers=(h1,))
            if fnl.fused_nonlinear_tile_rows(d, h1, n) is not None:
                continue
            reason = fnl.fused_nonlinear_decline_reason(model, n,
                                                        cluster_card)
            plan = fnl.fused_nonlinear_plan(d, h1, n)
            assert (reason is None) == (plan is not None), (d, h1, n)
            if plan is None:
                assert "cluster" in reason
                continue
            served += 1
            ranks, group, sub, tile, smem = plan
            cols = -(-d // ranks)
            assert ranks in CLUSTER_RANKS and d >= ranks
            assert group in (1, 2) and 2 * group * cols <= THREADS
            assert sub % 4 == 0 and 4 <= sub
            assert tile == n or tile % sub == 0
            assert smem == rank_footprint(d, h1, *plan[:4], n) <= MAX_SMEM
            assert 4 * (h1 * d * d + (2 * h1 + 1) * d) <= MAX_SMEM
    assert served > 0


@pytest.mark.parametrize("ranks", [None, *CLUSTER_RANKS])
def test_config7_takes_the_cluster_tier(cluster_card, ranks):
    """d = 50, h1 = 5, N = 100 (config 7): past the one-block measure,
    served on a cluster card; every cluster size holds it, each rank within
    227 KB; the rule takes 4 ranks with every row resident."""
    model = DenseNonlinearGaussian(n_vars=50, hidden_layers=(5,))
    assert fnl.fused_nonlinear_tile_rows(50, 5, 100) is None
    assert fnl.fused_nonlinear_available(model, 100, cluster_card)
    if ranks is None:
        plan = fnl.fused_nonlinear_plan(50, 5, 100)
        assert plan == fnl.NonlinearPlan(4, 2, 28, 100, 230_224)
        return
    plan = (fnl._block_plan(50, 5, 100, ranks, True)
            or fnl._block_plan(50, 5, 100, ranks, False))
    assert plan is not None and plan[-1] <= MAX_SMEM


@pytest.mark.parametrize("device", [None, "cpu", torch.device("cpu")])
@pytest.mark.parametrize("d,h1,n", [(41, 5, 100), (50, 5, 100), (23, 16, 100),
                                    (68, 1, 100)])
def test_cpu_declines_past_the_one_block_measure(device, d, h1, n):
    """Off a cluster card the gate declines past the one-block measure as
    before, and its reason names both tiers."""
    model = DenseNonlinearGaussian(n_vars=d, hidden_layers=(h1,))
    reason = fnl.fused_nonlinear_decline_reason(model, n, device)
    assert not fnl.fused_nonlinear_available(model, n, device)
    assert "shared memory" in reason and "cluster tier" in reason
    assert fnl.fused_nonlinear_plan(d, h1, n).ranks in CLUSTER_RANKS


@pytest.mark.parametrize("p,ranks,m,n_sms,chunk", [
    (1000, 4, 32, 132, 32),  # config 7: one chunk, 4,000 blocks
    (3, 4, 9, 132, 5),       # 12 blocks: two chunks of at least 4
    (2, 8, 32, 132, 4),      # 16 blocks: eight chunks
])
def test_cluster_grid_fills_one_wave(p, ranks, m, n_sms, chunk):
    """A cluster plan sizes its sample chunks by its P x ranks blocks."""
    assert fnl._chunk(p * ranks, m, n_sms) == chunk
