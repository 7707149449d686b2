"""``dibs_tpu_torch.profiling`` against ``dibs_tpu.profiling`` on the CPU:
``StepTimer`` records the same chunks and ``summary()`` gives the same
dict for the same callback times (``time.perf_counter`` patched), and
``trace()`` writes a Chrome trace of a short run.

The engine's spans and counters, on the plain paths: with no profiler a
step enters no record function and logs and counts nothing, and its bits
are those with spans on or the facility off; under a profiler the steps of
the marginal, joint (fused and generic, the MLP past #8's gate among them),
fleet and sharded engines open the layer spans, nested, on the profiler's
clock; #2's parent histogram and wide pass 2's replays equal counts made
from the sampled masks and the weights, and the MLP likelihood's scored
pairs are 2 P M a step on either route and absent in other models' steps.
"""
import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dibs_tpu import profiling as jax_profiling
from dibs_tpu_torch import profiling
from dibs_tpu_torch.fleet import fleet_init_state, fleet_seeds, fleet_step
from dibs_tpu_torch.inference import JointDiBS, MarginalDiBS
from dibs_tpu_torch.inference import fused_linear as fl
from dibs_tpu_torch.inference.fused_nonlinear import (
    fused_nonlinear_decline_reason,
)
from dibs_tpu_torch.models import (
    BGe,
    DenseNonlinearGaussian,
    LinearGaussian,
    ScaleFreeDAGDistribution,
)
from dibs_tpu_torch.ops import gpu_kernels as gk
from dibs_tpu_torch.ops.edges import edge_scores

torch.set_num_threads(1)

# callback times (s) and step counters: a slow first chunk, then steady ones
SEQUENCES = {
    "steady": ([0.0, 5.0, 5.5, 6.0, 6.5], [0, 100, 200, 300, 400]),
    "two_calls": ([1.0, 2.0], [0, 50]),
    "one_call": ([1.0], [10]),
    "ragged": ([0.0, 3.0, 3.2, 3.2, 4.0], [0, 10, 30, 40, 45]),
}


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_step_timer_summary_matches_reference(monkeypatch, name):
    times, steps = SEQUENCES[name]
    clock = iter(times + times)
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    ref, port = jax_profiling.StepTimer(), profiling.StepTimer()
    for t in steps:
        ref(t=t, zs=jnp.zeros(3))
    for t in steps:
        port(t=t, zs=torch.zeros(3))
    assert port.chunks == ref.chunks
    assert port.summary() == ref.summary()


def test_step_timer_as_a_sample_callback(capsys):
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(10, 5)).astype(np.float32))
    dibs = MarginalDiBS(x=x, graph_model=ScaleFreeDAGDistribution(5),
                        likelihood_model=BGe(n_vars=5, device="cpu"),
                        n_grad_mc_samples=4, n_acyclicity_mc_samples=2,
                        device="cpu")
    timer = profiling.StepTimer(verbose=True)
    dibs.sample(seed=0, n_particles=3, steps=6, callback=timer,
                callback_every=2)
    summary = timer.summary()
    assert summary["chunks"] == 2 and summary["total_steps"] == 2
    assert summary["steps_per_sec"] > 0
    assert "steps/s" in capsys.readouterr().out


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with profiling.trace(str(log_dir)) as prof:
        a = torch.randn(64, 64)
        (a @ a).sum()
    path = log_dir / "trace.json"
    assert path.exists()
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert len(prof.key_averages()) > 0


# --- the engine's spans and counters ---------------------------------------

# the layer each span opens in: a span's parent is the innermost span that
# holds it (the acyclicity chain's backward runs inside the prior's
# autograd call)
PARENTS = {
    "dibs.step": (None,),
    "dibs.likelihood": ("dibs.step",),
    "dibs.prior": ("dibs.step",),
    "dibs.transport": ("dibs.step",),
    "dibs.update": ("dibs.step",),
    "dibs.likelihood.sampler": ("dibs.likelihood",),
    "dibs.likelihood.score": ("dibs.likelihood",),
    "dibs.likelihood.grad": ("dibs.likelihood",),
    "dibs.prior.sampler": ("dibs.prior",),
    "dibs.prior.grad": ("dibs.prior",),
    "dibs.prior.acyclic": ("dibs.prior", "dibs.prior.grad"),
}
# a fused kernel draws its own noise: no likelihood sampler span
FUSED = set(PARENTS) - {"dibs.likelihood.sampler"}


def _data(d, n=20, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(n, d)).astype(np.float32))


def _engine(kind, d):
    common = dict(graph_model=ScaleFreeDAGDistribution(d),
                  n_grad_mc_samples=4, n_acyclicity_mc_samples=2,
                  device="cpu")
    if kind == "marginal":
        return MarginalDiBS(x=_data(d), likelihood_model=BGe(
            n_vars=d, device="cpu"), **common)
    if kind == "joint_linear":
        return JointDiBS(x=_data(d), likelihood_model=LinearGaussian(
            n_vars=d), **common)
    if kind == "joint_mlp5":  # one hidden layer of 5: #8 where it serves d
        lik = DenseNonlinearGaussian(n_vars=d, hidden_layers=(5,))
        if fused_nonlinear_decline_reason(lik, 20) is None:
            return JointDiBS(x=_data(d), likelihood_model=lik, **common)
        with pytest.warns(UserWarning, match="fused nonlinear"):
            return JointDiBS(x=_data(d), likelihood_model=lik, **common)
    with pytest.warns(UserWarning, match="fused nonlinear"):
        return JointDiBS(x=_data(d), likelihood_model=DenseNonlinearGaussian(
            n_vars=d, hidden_layers=(3, 3)), **common)


# joint_mlp5 at d = 48: past #8's gate (config 7's route at d = 50)
ENGINES = {"marginal": ("marginal", 40), "joint_linear": ("joint_linear", 72),
           "joint_generic": ("joint_generic", 6),
           "joint_mlp5": ("joint_mlp5", 48)}
EXPECTED = {"marginal": set(PARENTS), "joint_linear": FUSED,
            "joint_generic": set(PARENTS), "joint_mlp5": set(PARENTS)}


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _parents(spans):
    """Each logged span with the name of the innermost other span that
    holds its interval."""
    out = []
    for s in spans:
        holders = [h for h in spans if h is not s and h.start_ns <= s.start_ns
                   and h.end_ns >= s.end_ns]
        best = max(holders, key=lambda h: (h.start_ns, -h.end_ns),
                   default=None)
        out.append((s.name, None if best is None else best.name))
    return out


def _check_spans(spans, expected, steps):
    assert {s.name for s in spans} == expected
    assert sum(s.name == "dibs.step" for s in spans) == steps
    for name, parent in _parents(spans):
        assert parent in PARENTS[name], (name, parent)


def _resume(dibs, state, steps):
    out = dibs.resume(state, steps=steps, return_state=True)
    return out[-1]


@pytest.mark.parametrize("name", list(ENGINES))
def test_a_step_without_a_profiler_opens_and_logs_nothing(monkeypatch, name):
    """No record function is entered, nothing is logged or counted, no
    counter buffer is allocated; a profiler started afterwards holds no
    span of the step."""
    entered = []

    class Spy:
        def __init__(self, span_name):
            entered.append(span_name)

    monkeypatch.setattr(profiling, "_RecordFunction", Spy)
    profiling._reset()
    dibs = _engine(*ENGINES[name])
    state = dibs.init_state(seed=1, n_particles=3)
    _resume(dibs, state, 2)
    assert entered == [] and profiling.spans() == []
    assert profiling.counters() == {} and profiling._device == {}
    _, prof = _profiled(lambda: torch.ones(3) + 1.0)
    assert not [e for e in prof.profiler.kineto_results.events()
                if e.name().startswith("dibs.")]


@pytest.mark.parametrize("name", list(ENGINES))
def test_steps_are_bitwise_with_spans_and_without(monkeypatch, name):
    """Two steps with no profiler, under a profiler (spans and counters
    on), and under a profiler with the facility switched off (the code
    path without spans or counters): the same bits."""
    dibs = _engine(*ENGINES[name])
    state = dibs.init_state(seed=2, n_particles=3)
    plain = _resume(dibs, state, 2)
    traced, _ = _profiled(lambda: _resume(dibs, state, 2))
    assert profiling.spans()
    monkeypatch.setattr(profiling, "recording", lambda: False)
    bare, _ = _profiled(lambda: _resume(dibs, state, 2))
    for other in (traced, bare):
        assert torch.equal(plain.z, other.z)
        assert torch.equal(plain.opt_state_z[0].nu, other.opt_state_z[0].nu)
        if plain.theta is not None:
            for a, b in zip(plain.theta if isinstance(plain.theta, list)
                            else [plain.theta], other.theta
                            if isinstance(other.theta, list)
                            else [other.theta]):
                assert all(torch.equal(u, v) for u, v in
                           zip(a if isinstance(a, tuple) else [a],
                               b if isinstance(b, tuple) else [b]))


@pytest.mark.parametrize("name", list(ENGINES))
def test_a_traced_step_opens_the_layer_spans_nested(name):
    dibs = _engine(*ENGINES[name])
    state = _resume(dibs, dibs.init_state(seed=3, n_particles=3), 1)
    _profiled(lambda: _resume(dibs, state, 2))
    _check_spans(profiling.spans(), EXPECTED[name], 2)


def test_a_window_starts_after_steps_without_a_profiler():
    """The first span that finds a profiler recording after a call that
    found none starts a new window: the log holds the last window only."""
    dibs = _engine("marginal", 40)
    state = _resume(dibs, dibs.init_state(seed=9, n_particles=3), 1)
    _profiled(lambda: _resume(dibs, state, 2))
    assert sum(s.name == "dibs.step" for s in profiling.spans()) == 2
    state = _resume(dibs, state, 1)
    assert len(profiling.spans()) > 0  # readable after the window
    _profiled(lambda: _resume(dibs, state, 1))
    assert sum(s.name == "dibs.step" for s in profiling.spans()) == 1


@pytest.mark.parametrize("name", ["marginal", "joint_linear"])
def test_logged_intervals_are_the_profilers_events(name):
    """Each logged span and the profiler's event of the same name (k-th
    with k-th, by start) agree within 100 us at both ends: one clock."""
    dibs = _engine(*ENGINES[name])
    state = _resume(dibs, dibs.init_state(seed=4, n_particles=3), 1)
    _, prof = _profiled(lambda: _resume(dibs, state, 1))
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("dibs."):
            events.setdefault(e.name(), []).append(e)
    logged = {}
    for s in profiling.spans():
        logged.setdefault(s.name, []).append(s)
    assert set(events) == set(logged)
    for span_name, spans in logged.items():
        evs = sorted(events[span_name], key=lambda e: e.start_ns())
        assert len(evs) == len(spans)
        for s, e in zip(spans, evs):
            assert abs(e.start_ns() - s.start_ns) <= 100_000, span_name
            assert abs(e.end_ns() - s.end_ns) <= 100_000, span_name


@pytest.mark.parametrize("name", ["marginal", "joint_mlp5"])
def test_span_bodies_lie_inside_the_logged_intervals(name):
    """Each span's body record function (``profiling.BODY``, k-th with
    k-th by start) starts at or after the logged start and ends at or
    before the logged end: a kernel the program launches directly in a
    span is linked to an operator inside the logged interval."""
    dibs = _engine(*ENGINES[name])
    state = _resume(dibs, dibs.init_state(seed=4, n_particles=3), 1)
    _, prof = _profiled(lambda: _resume(dibs, state, 1))
    bodies = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name() == profiling.BODY),
                    key=lambda e: e.start_ns())
    spans = profiling.spans()
    assert len(bodies) == len(spans) > 0
    for s, body in zip(spans, bodies):
        assert s.start_ns <= body.start_ns() <= body.end_ns() <= s.end_ns, \
            s.name


@pytest.mark.parametrize("kind", ["marginal", "joint_linear"])
def test_fleet_steps_open_the_layer_spans(kind):
    d = ENGINES[kind][1]
    dibs = _engine(kind, d)
    xs = torch.stack([_data(d, seed=s) for s in range(2)])
    step = fleet_step(dibs, xs)
    state = step(fleet_init_state(dibs, fleet_seeds(5, 2), 3))
    _profiled(lambda: step(step(state)))
    _check_spans(profiling.spans(), EXPECTED[kind], 2)


def _parent_counts(gs):
    """``[..., d, d]`` masks -> the histogram ``[d + 1]`` of the parent
    counts of every (graph, node), counted with numpy."""
    g = gs.numpy()
    k = (g != 0).sum(axis=-2).reshape(-1)
    return np.bincount(k, minlength=gs.shape[-1] + 1).tolist()


def test_bge_counter_is_the_sampled_masks():
    """Config 6's shape (marginal BGe, ``score``, d > 32), small: one
    step's ``bge_pairs.parents`` is the parent counts of the hard samples
    the step draws, redrawn here from the step's stream."""
    dibs = _engine("marginal", 40)
    state = _resume(dibs, dibs.init_state(seed=6, n_particles=3), 2)
    _profiled(lambda: _resume(dibs, state, 1))
    counts = profiling.counters()
    t, m = state.t, dibs.cfg.n_grad_mc_samples
    gs = gk.gumbel_graphs_plain(edge_scores(state.z), state.seed, 2 * t,
                                dibs.cfg.alpha(t), 1.0, m, hard=True)
    assert counts["bge_pairs.parents"] == _parent_counts(gs)
    assert counts["bge_pairs.graphs"] == 3 * m
    assert counts["bge_pairs.calls"] == 1


def test_wide_pass2_counter_is_the_weighted_samples():
    """Config 5's shape (joint linear past d = 70, shared samples),
    small: one step's ``wide_pass2.replayed`` is the (particle, sample)
    pairs whose pass-1 softmax weights are not both exactly 0."""
    d = 72
    dibs = _engine("joint_linear", d)
    state = _resume(dibs, dibs.init_state(seed=7, n_particles=3), 2)
    _profiled(lambda: _resume(dibs, state, 1))
    counts = profiling.counters()
    t = state.t
    kw = dict(seed=state.seed, streams=(3 * t, 3 * t),
              alpha=dibs.cfg.alpha(t), tau=dibs.cfg.tau,
              n_samples=dibs.cfg.n_grad_mc_samples,
              model=dibs.likelihood_model)
    lls = fl.fused_linear_pass1_plain(
        edge_scores(state.z).contiguous(), state.theta, dibs.x,
        torch.ones_like(dibs.x), **kw)
    w_soft, w_hard = (torch.softmax(ll, dim=1) for ll in lls)
    want = int(((w_soft != 0) | (w_hard != 0)).sum())
    assert counts == {"wide_pass2.replayed": want, "wide_pass2.calls": 1}


@pytest.mark.parametrize("kind,d,calls", [
    ("joint_mlp5", 48, 2),  # past #8's gate: the soft and the hard call
    ("joint_generic", 6, 2),  # two hidden layers: the generic route too
    ("joint_mlp5", 8, 1),  # #8 (its plain twin here): one call a step
])
def test_mlp_counter_is_two_p_m_a_step(kind, d, calls):
    """``mlp_lik.pairs`` counts the (particle, sample) pairs whose MLP
    log-joint a step scored, 2 P M a step on either route, and
    ``mlp_lik.calls`` the calls that scored them."""
    dibs = _engine(kind, d)
    route = dibs.est.fused_grad_both.__name__
    assert route == ("fused_nonlinear" if calls == 1 else "fused_shared")
    state = _resume(dibs, dibs.init_state(seed=10, n_particles=3), 1)
    _profiled(lambda: _resume(dibs, state, 2))
    m = dibs.cfg.n_grad_mc_samples
    assert profiling.counters() == {"mlp_lik.pairs": 2 * 3 * m * 2,
                                    "mlp_lik.calls": calls * 2}


@pytest.mark.parametrize("d", [48, 8])
def test_mlp_steps_keep_no_counter_without_a_profiler(d):
    dibs = _engine("joint_mlp5", d)
    profiling._reset()
    _resume(dibs, dibs.init_state(seed=11, n_particles=3), 2)
    assert profiling.counters() == {} and profiling.spans() == []


@pytest.mark.parametrize("name", ["marginal", "joint_linear"])
def test_mlp_counter_absent_in_linear_and_bge_steps(name):
    dibs = _engine(*ENGINES[name])
    state = _resume(dibs, dibs.init_state(seed=12, n_particles=3), 1)
    _profiled(lambda: _resume(dibs, state, 1))
    counts = profiling.counters()
    assert profiling.spans()
    assert not {"mlp_lik.pairs", "mlp_lik.calls"} & set(counts), counts


def test_counters_of_one_window():
    """Host and device counters of one window, as ints and lists; a
    counter keeps its buffer and its size through the window; a new
    window starts empty."""
    profiling._reset()
    bufs = []
    _profiled(lambda: (
        profiling.count("calls", 2),
        bufs.append(profiling.counter("hist", 3, "cpu")),
        bufs[0].add_(torch.tensor([1, 0, 2])),
        bufs.append(profiling.counter("hist", 3, "cpu")),
        bufs[1][2].add_(7),
        profiling.counter("one", 1, "cpu").add_(4)))
    assert bufs[0] is bufs[1]
    assert profiling.counters() == {"calls": 2, "hist": [1, 0, 9], "one": 4}
    assert profiling.counter("hist", 3, "cpu") is None
    _profiled(lambda: profiling.count("calls", 1))
    assert profiling.counters() == {"calls": 1}


def test_a_counter_asked_for_at_another_size_fails():
    profiling._reset()
    with pytest.raises(AssertionError, match="hist"):
        _profiled(lambda: (profiling.counter("hist", 3, "cpu"),
                           profiling.counter("hist", 5, "cpu")))


def test_trace_writes_the_span_log_and_counters(tmp_path):
    dibs = _engine("marginal", 40)
    state = dibs.init_state(seed=8, n_particles=3)
    with profiling.trace(str(tmp_path)) as prof:
        _resume(dibs, state, 1)
    assert prof.with_stack and prof.record_shapes
    assert (tmp_path / "trace.json").exists()
    log = json.loads((tmp_path / "spans.json").read_text())
    names = {row[0] for row in log["spans"]}
    assert names == set(PARENTS)
    assert log["counters"]["bge_pairs.graphs"] == 3 * 4
    assert sum(log["counters"]["bge_pairs.parents"]) == 3 * 4 * 40


@pytest.mark.parametrize("world", [2])
def test_sharded_steps_open_the_layer_spans(tmp_path, world):
    """Particles split over a ``gloo`` world: every rank's traced steps
    open the spans of the table, nested, the transport its ring form."""
    import torch_parallel_workers as workers

    out = workers.run_world(workers.span_checks, world, tmp_path)
    for rank_out in out:
        for kind, rows in rank_out.items():
            spans = [profiling.Span(*row) for row in rows]
            _check_spans(spans, EXPECTED[kind], 2)
