"""Host-side sizing of the wide tier's pass 1 (``fused_linear_wide_pass1_
kernel`` in ``csrc/fused_linear.cu``): its shared-memory footprint, the
samples per group, the data rows per tile and the grid, which the wrapper
computes in Python and the kernel's launcher mirrors in C (the card-side
agreement is ``tests/test_torch_cuda.py``). Runs on the CPU: no kernel is
launched.
"""
import pytest
import torch

from dibs_tpu_torch.inference import fused_linear as fl

torch.set_num_threads(1)

MAX_SMEM = 232448  # 227 KB, the most one block can use on an H100
TWO_PER_SM = 233472 // 2 - 1024  # two blocks in an SM's 228 KB
DS = (71, 75, 128, 602)
NS = (1, 30, 100, 600, 10_000)


def footprint(d, tile_rows, group):
    """The kernel's layout, region by region (bytes)."""
    ldn = -(-tile_rows // 8) * 8
    partials = 8 * 2 * 2 * group * (8 + ldn // 8)  # prior + data, 2 parities
    slabs = 4 * 4 * d * 8  # alpha s, E[G], Theta, logN(Theta)
    tiles = 4 * 2 * ldn * 8  # w, resid_ref
    x_t = 4 * d * ldn  # the data tile, transposed
    group_slabs = 4 * 2 * group * d * 8  # both branches of each sample
    return partials + slabs + tiles + x_t + group_slabs


def test_config5_plan():
    """Config 5 (P=1000, d=128, N=100): all rows resident, groups of 4
    samples, 111,744 B (two blocks an SM), 1000 x 16 blocks."""
    plan = fl.fused_linear_wide_pass1_plan(1000, 128, 100)
    assert plan == fl.WidePass1Plan(100, 4, 111_744, (1000, 16))
    assert plan.smem_bytes == footprint(128, 100, 4) <= TWO_PER_SM


@pytest.mark.parametrize("d,tile_rows,group", [
    (128, 100, 4), (71, 1, 4), (75, 128, 4), (128, 128, 2), (602, 8, 1),
    (300, 25, 1), (200, 64, 2), (602, 37, 4)])
def test_footprint_formula(d, tile_rows, group):
    assert fl.fused_linear_wide_pass1_smem_bytes(d, tile_rows, group) == \
        footprint(d, tile_rows, group)


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("n", NS)
def test_plan_at_the_tier_shapes(d, n):
    """Tile rows at most min(N, 128), halved only while two blocks do not
    fit an SM; the largest group of 4, 2, 1 that leaves two blocks an SM;
    one block per particle and 8-column tile."""
    plan = fl.fused_linear_wide_pass1_plan(7, d, n)
    assert plan is not None
    tile, group = plan.tile_rows, plan.group
    assert 1 <= tile <= min(n, 128)
    assert plan.grid == (7, -(-d // 8))
    assert plan.smem_bytes == footprint(d, tile, group) <= MAX_SMEM
    assert group == fl.fused_linear_wide_pass1_group(d, tile)
    assert group in (1, 2, 4)
    if group > 1:
        assert footprint(d, tile, group) <= TWO_PER_SM
    if group < 4:
        assert footprint(d, tile, 2 * group) > TWO_PER_SM
    if tile < min(n, 128):  # halved: the larger tile left no two per SM
        assert tile >= 8
        big = min(n, 128) if tile == 8 else 2 * tile
        assert footprint(d, big, fl.fused_linear_wide_pass1_group(
            d, big)) > TWO_PER_SM


@pytest.mark.parametrize("d,n,tile,group", [
    (128, 100, 100, 4), (128, 10_000, 128, 2), (71, 1, 1, 4),
    (75, 600, 128, 4), (602, 30, 8, 1), (602, 10_000, 8, 1)])
def test_plan_values(d, n, tile, group):
    plan = fl.fused_linear_wide_pass1_plan(1, d, n)
    assert (plan.tile_rows, plan.group) == (tile, group)


@pytest.mark.parametrize("d", (71, 128, 300, 602, 603))
@pytest.mark.parametrize("n", NS)
def test_availability_is_unchanged(d, n):
    """``fused_linear_available`` is pass 2's rule, as before pass 1 had a
    kernel of its own: the wide tier fits at its smallest tile, min(N, 8)
    rows of 11 [d, 8] slabs, 4 [rows, 8] tiles and the data tile; so it
    serves d <= 602 for any N (more where N < 8)."""
    rows = min(n, 8)
    fits = 144 + 4 * (88 * d + 32 * rows + rows * (d | 1)) <= MAX_SMEM
    assert fl.fused_linear_available(d, n) == fits
    assert fits == (d <= 602 or n < 8)


@pytest.mark.parametrize("n", NS)
def test_pass1_fits_wherever_the_tier_is_available(n):
    """Pass 1's footprint fits 227 KB at every d the wide tier serves."""
    for d in range(71, 700):
        if fl.fused_linear_wide_tile_rows(d, n) is None:
            continue
        plan = fl.fused_linear_wide_pass1_plan(1, d, n)
        assert plan is not None, d
        assert plan.smem_bytes <= MAX_SMEM


def test_pass2_footprint_is_unchanged():
    """Pass 2 keeps its own footprint and tile rule."""
    assert fl.fused_linear_wide_smem_bytes(128, 100) == \
        144 + 4 * (11 * 128 * 8 + 4 * 100 * 8 + 100 * 129)
    assert fl.fused_linear_wide_tile_rows(128, 100) == 100
