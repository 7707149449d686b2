"""Config 7 (``joint_nonlinear_sf50``: ``JointDiBS`` with the per-node MLP
model) at a CPU test's size, through the port's plain PyTorch path: the
route the engine takes past #8's gate, the run judged correct at the
file's limits and not with half the samples or an unchanged state, the
reference's initial particles and likelihood against the port's on both
routes (the generic estimators at d = 48, where #8 declines as at d = 50,
and #8's plain twin at d = 16), the rows ``Theta`` is compared as, and
the two readers of the MLP likelihood's layer."""
import subprocess
import sys

import pytest
import torch

from dibs_tpu_torch import profiling
from dibs_tpu_torch.utils.tree import tree_leaves
from portbench import datagen, harness, spec, workcount
from portbench.reference import common
from portbench.reference.joint_nonlinear import Reference
from portbench.systems import dibs_nonlinear
from portbench.tests.conftest import ROOT, tiny
from portbench.trace import DeviceOp, Trace

CELL = "joint_nonlinear_sf50.single"
# d = 48 at N = 30: #8 declines (325,776 bytes of shared memory), the
# generic estimators run, as at the cell's d = 50; at d = 16 #8 serves
ROUTES = {48: "fused_shared", 16: "fused_nonlinear"}


def _cell(d=48):
    return tiny(spec.load_cell(CELL), d=d, p=6)


def _engine(cfg):
    if ROUTES[cfg["n_vars"]] == "fused_nonlinear":
        return dibs_nonlinear.build(cfg, datagen.make_data(cfg).x, "cpu")
    with pytest.warns(UserWarning, match="fused nonlinear kernel disabled"):
        return dibs_nonlinear.build(cfg, datagen.make_data(cfg).x, "cpu")


@pytest.mark.parametrize("d", list(ROUTES))
def test_route_by_the_gate(d):
    engine = _engine(_cell(d).config)
    assert engine.dibs.est.fused_grad_both.__name__ == ROUTES[d]


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 99])
def test_correct_at_the_files_limits(seed):
    """Both modes correct; set-up's start state and a segment's output lie
    within 1e-4 of the reference's change (the CPU trials read ~1e-5)."""
    cell = _cell()
    plain, *_ = harness.run_cell(cell, seed, 0.0, False, "cpu")
    assert plain["correct"], plain["checks"]
    values = {k: c["value"] for k, c in plain["checks"].items()
              if "_over_" not in k}
    assert max(values.values()) < 1e-4, values
    traced, *_ = harness.run_cell(cell, seed, 0.0, True, "cpu")
    assert traced["correct"], traced["checks"]


def test_half_of_the_samples_fails(monkeypatch):
    build = dibs_nonlinear.build

    def half(cfg, x, device):
        return build(dict(cfg, n_grad_mc_samples=cfg["n_grad_mc_samples"]
                          // 2), x, device)

    monkeypatch.setattr(dibs_nonlinear, "build", half)
    line, *_ = harness.run_cell(_cell(), 11, 0.0, False, "cpu")
    assert not line["correct"]


def test_unchanged_state_fails(monkeypatch):
    monkeypatch.setattr(dibs_nonlinear.NonlinearEngine, "run",
                        lambda self, state, steps, on_step=None: state)
    line, *_ = harness.run_cell(_cell(), 11, 0.0, False, "cpu")
    assert not line["correct"]


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 4])
def test_initial_particles_are_the_ports_bit_for_bit(seed):
    """The reference draws ``Z`` and the MLP tree from the configuration's
    generator as the port's ``init_state`` does, in the seed's order."""
    cfg = _cell().config
    engine = _engine(cfg)
    st = engine.init_state(seed)
    ref = Reference(cfg, datagen.make_data(cfg).x, common.REFERENCE,
                    "cpu").init_state(seed)
    mine = engine.leaves(st)
    assert torch.equal(mine["z"].double(), ref.z)
    assert torch.equal(mine["theta"].double(), ref.theta)
    other = engine.init_state(seed + 1)
    assert not torch.equal(other.z, st.z)


@pytest.mark.parametrize("d", list(ROUTES))
def test_likelihood_stage_agrees_with_the_reference(d):
    """The engine's likelihood estimator on a state 3 steps in against the
    float64 reference at the same inputs, ``||p - r|| / ||r||`` a
    particle. The port computes in float32, so it lies some 1e-7 from the
    float64 reference (the largest particle of seeds 7-9, dz / dtheta:
    2.7e-7 / 1.3e-7 at d = 48, 2.5e-7 / 1.5e-7 at d = 16); 1e-5 leaves a
    factor of 35 above that, and the same reference in float32 with TF32
    products reads 8e-4 to 4e-3 there, 80 times the bar and more."""
    cfg = _cell(d).config
    engine = _engine(cfg)
    st = engine.run(engine.init_state(7), 3)
    stage = engine.likelihood(st)
    ref = Reference(cfg, datagen.make_data(cfg).x, common.REFERENCE, "cpu")
    want = ref.likelihood(stage["z"], stage["theta"], stage["t"], 7)
    for name in ("dz", "dtheta"):
        p = stage["out"][name].double().reshape(6, -1)
        r = want[name].reshape(6, -1)
        gap = ((p - r).norm(dim=1) / r.norm(dim=1)).max()
        assert gap < 1e-5, (name, float(gap))


_REFERENCE_ALONE = """
import sys
sys.path.insert(0, {root!r})
import numpy as np
from portbench.reference import common, joint_nonlinear
cfg = dict(n_vars=6, latent_dim=6, n_particles=3, n_grad_mc_samples=4,
           n_acyclicity_mc_samples=2, tau=1.0, alpha_linear=0.5,
           beta_linear=1.0, obs_noise=0.1, sig_param=1.0, hidden_layers=[5],
           activation="relu", bias=True, graph_prior="sf", edges_per_node=2,
           h_latent=5.0, h_theta=500.0, stepsize=0.005, fixed_seed=5)
x = np.random.default_rng(0).standard_normal((10, 6)).astype("float32")
for prec in (common.REFERENCE, common.CONTROL):
    ref = joint_nonlinear.Reference(cfg, x, prec, "cpu")
    st = ref.step(ref.step(ref.init_state(1), 1), 1)
    assert st.theta.dtype == prec.dtype and st.theta.shape == (3, 246)
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_reference_imports_nothing_of_the_program():
    """Two steps of the reference at both precisions in a fresh process
    load neither the program nor JAX."""
    out = subprocess.run([sys.executable, "-c", _REFERENCE_ALONE.format(
        root=str(ROOT))], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    mods = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not mods & {"dibs_tpu_torch", "dibs_tpu", "jax", "jaxlib"}, mods


def test_theta_rows_in_tree_order():
    """``theta`` and ``nu_theta`` are the leaves W1 ``[P, d, d, 5]``, b1
    ``[P, d, 5]``, W2 ``[P, d, 5, 1]``, b2 ``[P, d, 1]`` flattened and
    concatenated in that order: 13,050 a particle at d = 50."""
    cfg = _cell().config
    engine = _engine(cfg)
    st = engine.run(engine.init_state(9), 1)
    rows = engine.leaves(st)
    d = cfg["n_vars"]
    sizes = [d * d * 5, d * 5, d * 5, d]
    for key, tree in (("theta", st.theta),
                      ("nu_theta", st.opt_state_theta[0].nu)):
        leaves = tree_leaves(tree)
        assert [tuple(x.shape[1:]) for x in leaves] == [
            (d, d, 5), (d, 5), (d, 5, 1), (d, 1)]
        assert rows[key].shape == (6, sum(sizes))
        parts = torch.split(rows[key], sizes, dim=1)
        for part, leaf in zip(parts, leaves):
            assert torch.equal(part, leaf.reshape(6, -1))


# --- the layer's readers on a synthetic trace ------------------------------

def _op(t):
    return (1, t, ())


LOG = [
    profiling.Span("dibs.step", 1, 0, 1000),
    profiling.Span("dibs.likelihood", 1, 10, 700),
    profiling.Span("dibs.likelihood.sampler", 1, 20, 60),
    profiling.Span("dibs.likelihood.score", 1, 100, 300),
    profiling.Span("dibs.likelihood.grad", 1, 300, 600),
    profiling.Span("dibs.transport", 1, 700, 900),
]


def _trace():
    ops = [DeviceOp("gumbel", 0, 50, True, _op(30)),  # sampler
           DeviceOp("bmm", 100, 400, True, _op(150)),  # score
           DeviceOp("gemm", 400, 900, True, _op(350)),  # grad
           DeviceOp("relu", 900, 1000, True, _op(650)),  # likelihood
           DeviceOp("se", 1000, 1100, True, _op(800))]  # transport
    return Trace(ops, [], 2, 1e-5)


@pytest.fixture
def program(monkeypatch):
    state = {"spans": list(LOG), "counters": {}}
    monkeypatch.setattr(profiling, "spans", lambda: state["spans"])
    monkeypatch.setattr(profiling, "counters", lambda: state["counters"])
    return state


def test_mlp_likelihood_ms_reads_score_and_grad(program):
    read = spec.load_reader("mlp_likelihood_ms")
    assert read(_trace(), None) == pytest.approx((300 + 500) / 1e6 / 2)


def test_mlp_likelihood_roofline_from_the_scored_pairs(program):
    """The frozen count at M = pairs / (2 P steps) over the spans' device
    time: 2 steps of 64,000 pairs are 2 steps at M = 32."""
    cell = spec.load_cell(CELL)
    program["counters"] = {"mlp_lik.pairs": 2 * 64000, "mlp_lik.calls": 4}
    bound = workcount.bound_s(*workcount.kernel_cost(
        "fused_nonlinear", p=1000, m=32, n=100, d=50, h1=5))
    assert bound == pytest.approx(4.813e-3, rel=1e-3)
    want = 100 * bound / (800e-9 / 2)
    assert spec.load_reader("mlp_likelihood_roofline")(_trace(), cell) == \
        pytest.approx(want)


@pytest.mark.parametrize("name", ["mlp_likelihood_ms",
                                  "mlp_likelihood_roofline"])
def test_readers_read_none_without_the_log_or_the_counter(program, name):
    cell = spec.load_cell(CELL)
    program["spans"], program["counters"] = [], {}
    assert spec.load_reader(name)(_trace(), cell) is None
    program["spans"] = list(LOG)
    if name == "mlp_likelihood_roofline":
        # a program without the counter (a tree before it)
        assert spec.load_reader(name)(_trace(), cell) is None


@pytest.mark.parametrize("name", ["mlp_likelihood_ms",
                                  "mlp_likelihood_roofline"])
def test_a_program_without_the_log_reads_none(monkeypatch, name):
    monkeypatch.delattr(profiling, "spans")
    monkeypatch.delattr(profiling, "counters")
    assert spec.load_reader(name)(_trace(), spec.load_cell(CELL)) is None
