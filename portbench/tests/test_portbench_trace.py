"""The traced window's reductions on a synthetic trace: busy time, idle
share, launches, rooflines from the frozen counts, kernels matched to a
file of the program by their operator's Python stack, and the
breakdown."""
import pytest

from portbench import spec, workcount
from portbench.trace import DeviceOp, Trace

ACYC = ("dibs_tpu_torch/ops/acyclic.py(58): _scaled_matrix_power",
        "dibs_tpu_torch/inference/estimators.py(498): prior")
OTHER = ("dibs_tpu_torch/inference/transport.py(90): phi",)


def _trace(steps=2, window_s=1e-3):
    ops = [
        DeviceOp("void gumbel_graphs_kernel<4, 0>(float*)", 0, 100, True,
                 None),
        DeviceOp("sm80_xmma_gemm_f32f32", 150, 350, True, (1, 140, ACYC)),
        DeviceOp("void at::native::add_kernel(float)", 350, 400, True,
                 (1, 345, ACYC)),
        DeviceOp("sm80_xmma_gemm_f32f32", 500, 700, True, (1, 490, OTHER)),
        DeviceOp("Memcpy DtoD (Device -> Device)", 700, 800, False, None),
        DeviceOp("void (anonymous namespace)::transport_phi_kernel<true>(x)",
                 900, 1000, True, None),
    ]
    host = [(400, 500, "aten::mul"), (800, 900, "aten::bmm")]
    return Trace(ops, host, steps, window_s)


def test_busy_idle_and_launches():
    tr = _trace()
    assert tr.busy_s == pytest.approx(750e-9)  # the union of the intervals
    assert spec.load_reader("device_idle_share")(tr, None) == \
        pytest.approx(100 * (1 - 750e-9 / 1e-3))
    assert spec.load_reader("launches_per_step")(tr, None) == 2.5


def test_launched_from_the_operators_stack():
    tr = _trace()
    names = [k.name for k in tr.launched_from("dibs_tpu_torch/ops/acyclic.py")]
    assert names == ["sm80_xmma_gemm_f32f32",
                     "void at::native::add_kernel(float)"]


def test_no_frames_no_match():
    tr = Trace([DeviceOp("k", 0, 1, True, (1, 0, ()))], [], 1, 1.0)
    assert tr.launched_from("ops/acyclic.py") is None


def test_roofline_from_frozen_counts():
    cell = spec.load_cell("joint_linear_sf128.single")
    tr = _trace(steps=3)
    flops, n_bytes = workcount.kernel_cost("gumbel_graphs", p=1000, m=8,
                                           d=128)
    want = 100 * workcount.bound_s(flops, n_bytes) * 3 / 100e-9
    assert spec.load_reader("gumbel_roofline")(tr, cell) == pytest.approx(want)
    acyc = workcount.bound_s(*workcount.kernel_cost("acyclic_grad", p=1000,
                                                    d=128, k=8))
    assert spec.load_reader("acyclic_roofline")(tr, cell) == \
        pytest.approx(100 * acyc * 3 / 250e-9)
    # nothing to read: no wide pass 1 in this trace, no count for #2
    assert spec.load_reader("wide_pass1_roofline")(tr, cell) is None
    assert spec.load_reader("bge_pairs_ms")(tr, cell) is None


def test_breakdown():
    out = _trace().breakdown()
    assert out["device_ops"][0] == ["sm80_xmma_gemm_f32f32", 400e-9]
    assert ["transport_phi_kernel<true>", 100e-9] in out["device_ops"]
    assert out["idle_gaps"] == [["aten::bmm", 100e-9], ["aten::mul", 100e-9],
                                ["host idle", 50e-9]]
