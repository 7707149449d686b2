"""The yardstick's frozen work counts equal the program's
``accounting.kernel_cost`` at every cell's shapes, and the count behind
config 5's ``step_mfu``."""
import pytest
import torch

from dibs_tpu_torch import accounting
from portbench import layers, spec, workcount
from portbench.tests.conftest import CELLS


@pytest.mark.parametrize("name", CELLS)
def test_counts_equal_the_programs(name):
    cell = spec.load_cell(name)
    assert cell.config["step_work"]
    for w in cell.config["step_work"]:
        assert workcount.kernel_cost(w["kernel"], **w["shape"]) == \
            accounting.kernel_cost(w["kernel"], **w["shape"]), w
        # the full pass 2 too (its count at every replayed sample)
        shape = {k: v for k, v in w["shape"].items() if k != "replayed"}
        assert workcount.kernel_cost(w["kernel"], **shape) == \
            accounting.kernel_cost(w["kernel"], **shape)


@pytest.mark.parametrize("d,b", [(20, 64), (128, 16)])
def test_bge_count_equals_the_programs(d, b):
    gen = torch.Generator().manual_seed(d)
    gs = (torch.rand((b, d, d), generator=gen) < 0.3).float()
    gs = gs * (1 - torch.eye(d))
    counts = gs.sum(1).flatten().tolist()
    assert workcount.kernel_cost("bge_pairs", parent_counts=counts,
                                 graphs=b, d=d) == pytest.approx(
        accounting.kernel_cost("bge_pairs", gs=gs), rel=1e-12)


def test_bound_and_peaks_equal_the_programs():
    peaks = accounting.CHIP_PEAKS["h100_sxm"]
    assert workcount.FP32_FLOPS == peaks["fp32_tflops"] * 1e12
    assert workcount.HBM_BYTES_S == peaks["hbm_gbps"] * 1e9
    for flops, n_bytes in ((1e12, 1e6), (1e6, 1e10), (6.7e10, 3.35e7)):
        ms, _ = accounting.bound_ms(flops, n_bytes)
        assert workcount.bound_s(flops, n_bytes) == pytest.approx(ms / 1e3)


def test_config5_step_count():
    """#1, wide pass 1, wide pass 2 at no replayed sample, #3 as one
    triangle for Z and Theta, #4 with both matrices for Z and Theta, and
    the acyclicity chain's 12 products: 892.96 GFLOP, a floor."""
    cell = spec.load_cell("joint_linear_sf128.single")
    flops = layers.step_flops(cell)
    parts = [0.3932, 216.2688, 3.2768, 49.2020, 24.6010, 131.072, 65.536,
             402.6532]
    assert flops / 1e9 == pytest.approx(sum(parts), rel=1e-4)
    assert flops / 1e9 == pytest.approx(892.96, rel=1e-4)


def test_config6_has_no_step_mfu_count():
    """Config 6's step list leaves out #2, whose count needs the parents
    the step drew: its cell does not report ``step_mfu``."""
    cell = spec.load_cell("marginal_bge_sf128.dense")
    assert "step_mfu" not in [m["name"] for m in cell.per_layer]
    assert "bge_pairs" not in [w["kernel"] for w in cell.config["step_work"]]
