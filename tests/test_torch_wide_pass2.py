"""Host-side sizing of the wide tier's pass 2 (``fused_linear_wide_kernel``
in ``csrc/fused_linear.cu``): its shared-memory footprint, the data rows per
tile and the grid, which the wrapper computes in Python and the kernel's
launcher mirrors in C (the card-side agreement is
``tests/test_torch_cuda.py``). Runs on the CPU: no kernel is launched.
"""
import pytest
import torch

from dibs_tpu_torch.inference import fused_linear as fl

torch.set_num_threads(1)

MAX_SMEM = 232448  # 227 KB, the most one block can use on an H100
TWO_PER_SM = 233472 // 2 - 1024  # two blocks in an SM's 228 KB
DS = (71, 75, 128, 200, 602)
NS = (1, 30, 37, 100, 600, 10_000)


def footprint(d, tile_rows):
    """The kernel's layout, region by region (bytes)."""
    ldn = -(-tile_rows // 4) * 4  # rows rounded up to 4 ...
    if ldn % 8 == 0:  # ... and to 4 mod 8
        ldn += 4
    per_particle = 4 * 4 * d * 8  # alpha s, Theta, the d scores, d Theta sums
    per_sample = 4 * 6 * d * 8  # both branches' A, G, H, both x^T resid
    tiles = 4 * 2 * ldn * 8  # w, resid_ref
    residuals = 4 * ldn * 2 * 8  # both branches' weighted residuals
    x_t = 4 * d * ldn  # the data tile, transposed
    return per_particle + per_sample + tiles + residuals + x_t


def test_config5_plan():
    """Config 5 (P=1000, d=128, N=100): all rows resident, 104,960 B (two
    blocks an SM), 1000 x 16 blocks."""
    plan = fl.fused_linear_wide_pass2_plan(1000, 128, 100)
    assert plan == fl.WidePass2Plan(100, 104_960, (1000, 16))
    assert plan.smem_bytes == footprint(128, 100) <= TWO_PER_SM


@pytest.mark.parametrize("d,tile_rows", [
    (128, 100), (71, 1), (75, 128), (128, 128), (602, 8), (300, 25),
    (200, 64), (602, 37), (652, 1)])
def test_footprint_formula(d, tile_rows):
    assert fl.fused_linear_wide_pass2_smem_bytes(d, tile_rows) == \
        footprint(d, tile_rows)


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("n", NS)
def test_plan_at_the_tier_shapes(d, n):
    """Tile rows at most min(N, 128), halved only while two blocks do not
    fit an SM; one block per particle and 8-column tile; the footprint is
    the layout's and at most 227 KB."""
    plan = fl.fused_linear_wide_pass2_plan(7, d, n)
    assert plan is not None
    tile = plan.tile_rows
    assert 1 <= tile <= min(n, 128)
    assert plan.grid == (7, -(-d // 8))
    assert plan.smem_bytes == footprint(d, tile) <= MAX_SMEM
    if tile < min(n, 128):  # halved: the larger tile left no two per SM
        assert tile >= 8
        big = min(n, 128) if tile == 8 else 2 * tile
        assert footprint(d, big) > TWO_PER_SM


@pytest.mark.parametrize("d,n,tile", [
    (128, 100, 100), (128, 10_000, 64), (71, 1, 1), (75, 600, 128),
    (200, 300, 32), (602, 30, 8), (602, 10_000, 8), (128, 37, 37)])
def test_plan_values(d, n, tile):
    assert fl.fused_linear_wide_pass2_plan(1, d, n).tile_rows == tile


@pytest.mark.parametrize("n", NS + (2, 7, 8))
def test_pass2_fits_wherever_the_tier_is_available(n):
    """Pass 2's plan fits 227 KB at every d the wide tier serves, d=602 at
    N=30 (80 B under the gate's limit) and d up to 652 at N=1 included."""
    for d in range(71, 700):
        if fl.fused_linear_wide_tile_rows(d, n) is None:
            continue
        plan = fl.fused_linear_wide_pass2_plan(1, d, n)
        assert plan is not None, d
        assert plan.smem_bytes <= MAX_SMEM


def test_tier_edge_shapes():
    """The gate's edge: d=602, N=30 sits 80 B under 227 KB in the gate's
    measure; pass 2 takes 8 rows there in 223,072 B."""
    assert fl.fused_linear_wide_smem_bytes(602, 8) == MAX_SMEM - 80
    plan = fl.fused_linear_wide_pass2_plan(2, 602, 30)
    assert plan == fl.WidePass2Plan(8, 223_072, (2, 76))
    assert fl.fused_linear_wide_pass2_plan(1, 652, 1).smem_bytes <= MAX_SMEM
    assert fl.fused_linear_wide_tile_rows(653, 1) is None


def test_gate_is_unchanged():
    """``fused_linear_available`` keeps the gate's measure: d <= 602 for
    any N, d = 603 only where N < 8."""
    for n in NS + (7, 8):
        assert fl.fused_linear_available(602, n)
        assert fl.fused_linear_available(603, n) == (n < 8)
