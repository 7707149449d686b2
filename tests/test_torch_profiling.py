"""``dibs_tpu_torch.profiling`` against ``dibs_tpu.profiling`` on the CPU:
``StepTimer`` records the same chunks and ``summary()`` gives the same
dict for the same callback times (``time.perf_counter`` patched), and
``trace()`` writes a Chrome trace of a short run.
"""
import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dibs_tpu import profiling as jax_profiling
from dibs_tpu_torch import profiling
from dibs_tpu_torch.inference import MarginalDiBS
from dibs_tpu_torch.models import BGe, ScaleFreeDAGDistribution

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
