"""The readers of the program's spans and counters on a synthetic trace:
each kernel given to the innermost span open at its launching operator's
start, the update and the score-gradient chain by span, the idle inside
steps, the two rooflines from counted work; every
reader ``None`` where the program logged or counted nothing, or keeps no
log at all."""
import pytest

from dibs_tpu_torch import profiling
from portbench import spec, spans, workcount
from portbench.trace import DeviceOp, Trace

NEW = ("update_ms", "grad_chain_ms", "step_idle_ms", "wide_pass2_roofline",
       "bge_pairs_roofline")

# two steps; the second's prior gradient runs the chain's backward (the
# acyclicity span) on another thread inside the caller's autograd span
LOG = [
    profiling.Span("dibs.step", 1, 0, 1000),
    profiling.Span("dibs.likelihood", 1, 10, 400),
    profiling.Span("dibs.likelihood.grad", 1, 300, 390),
    profiling.Span("dibs.prior", 1, 400, 700),
    profiling.Span("dibs.prior.grad", 1, 600, 690),
    profiling.Span("dibs.prior.acyclic", 2, 650, 680),
    profiling.Span("dibs.update", 1, 800, 900),
    profiling.Span("dibs.step", 1, 2000, 3000),
    profiling.Span("dibs.update", 1, 2800, 2900),
]


def _op(t):
    return (1, t, ())


def _trace():
    ops = [
        DeviceOp("void fused_linear_wide_kernel<false, false>(x)", 100, 300,
                 True, _op(20)),
        DeviceOp("sm80_xmma_gemm", 300, 340, True, _op(350)),  # lik. grad
        DeviceOp("gemm", 340, 400, True, _op(660)),  # acyclic
        DeviceOp("elementwise", 400, 430, True, _op(620)),  # prior grad
        DeviceOp("rmsprop", 500, 520, True, _op(850)),  # update
        # a gap 520-600 (midpoint inside the first step)
        DeviceOp("void bge_pairs_bits_kernel(x)", 600, 700, True, _op(30)),
        DeviceOp("Memcpy DtoD", 700, 710, False, None),
        # a gap 710-1900 (midpoint 1305: between the steps)
        DeviceOp("rmsprop", 1900, 1950, True, _op(2850)),
        DeviceOp("k", 1950, 1960, True, None),  # no operator: no span
    ]
    return Trace(ops, [], 2, 1e-5)


@pytest.fixture
def program(monkeypatch):
    """The program's span log and counters, as a window left them."""
    state = {"spans": list(LOG), "counters": {}}
    monkeypatch.setattr(profiling, "spans", lambda: state["spans"])
    monkeypatch.setattr(profiling, "counters", lambda: state["counters"])
    return state


def test_kernels_go_to_the_innermost_open_span(program):
    owners = [o for _, o in spans.owners(_trace(), spans.log())]
    assert owners == ["dibs.likelihood", "dibs.likelihood.grad",
                      "dibs.prior.acyclic", "dibs.prior.grad", "dibs.update",
                      "dibs.likelihood", "dibs.update", None]


def test_update_chain_and_idle(program):
    tr = _trace()
    read = {name: spec.load_reader(name) for name in NEW}
    assert read["update_ms"](tr, None) == pytest.approx((20 + 50) / 1e6 / 2)
    # the likelihood's and the prior's gradient spans, not the acyclicity
    assert read["grad_chain_ms"](tr, None) == pytest.approx((40 + 30) / 1e6
                                                             / 2)
    assert read["step_idle_ms"](tr, None) == pytest.approx((70 + 80) / 1e6
                                                           / 2)


def test_wide_pass2_roofline_from_the_replayed_samples(program):
    cell = spec.load_cell("joint_linear_sf128.single")
    program["counters"] = {"wide_pass2.replayed": 2 * 1598,
                           "wide_pass2.calls": 2}
    flops, n_bytes = workcount.kernel_cost("fused_linear_wide_pass2", p=1000,
                                           m=32, n=100, d=128, replayed=1598)
    want = 100 * 2 * workcount.bound_s(flops, n_bytes) / 200e-9
    assert spec.load_reader("wide_pass2_roofline")(_trace(), cell) == \
        pytest.approx(want)


def test_bge_pairs_roofline_from_the_parent_histogram(program):
    """The histogram's count is the frozen count of the pairs' parent
    counts, listed one by one."""
    cell = spec.load_cell("marginal_bge_sf128.dense")
    ks = [0, 3, 3, 40, 127, 64, 64, 64]
    hist = [0] * 129
    for k in ks:
        hist[k] += 1
    program["counters"] = {"bge_pairs.parents": hist, "bge_pairs.graphs": 4,
                           "bge_pairs.calls": 2}
    flops, _ = workcount.kernel_cost("bge_pairs", parent_counts=ks, graphs=4,
                                     d=128)
    _, n_bytes = workcount.kernel_cost("bge_pairs", parent_counts=[],
                                       graphs=2, d=128)
    want = 100 * 2 * workcount.bound_s(flops / 2, n_bytes) / 100e-9
    assert spec.load_reader("bge_pairs_roofline")(_trace(), cell) == \
        pytest.approx(want)


@pytest.mark.parametrize("name", NEW)
def test_nothing_logged_or_counted_reads_none(program, name):
    program["spans"], program["counters"] = [], {}
    cell = spec.load_cell("joint_linear_sf128.single")
    assert spec.load_reader(name)(_trace(), cell) is None


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_the_log_reads_none(monkeypatch, name):
    monkeypatch.delattr(profiling, "spans")
    monkeypatch.delattr(profiling, "counters")
    cell = spec.load_cell("marginal_bge_sf128.dense")
    assert spec.load_reader(name)(_trace(), cell) is None
