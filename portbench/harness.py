"""One run of one cell: set-up, the measured window, the traced window's
per-layer metrics, and the comparison with the plain reference.

Set-up makes the configuration's data (:mod:`portbench.datagen`), builds the
port's engine (the configuration's system module) and has it load its
kernels (built once a checkout, the build's seconds printed apart on
standard error and counted in ``setup_s``), takes the configuration's
initial particles in the seed's order, keys the noise with the seed, and
runs the traffic's ``warm_steps`` steps: every
shape of the window is then built and warm. The window replays segments:
each runs ``segment_steps`` steps through the engine's public ``resume``
from that same start state, with the same noise, so every segment does the
same work. The window closes at the first segment end past ``--seconds``,
at the device's synchronised end of its last step. A CUDA event after
every step gives each step's device time, read after the window.

Then the JAX check, the peak memory, and the window's last segment once
more: its last step is run again (it must give the window's output to the
bit, as the port's kernels are deterministic), and the likelihood's part
of that step is taken through the engine's estimators on the same inputs.
With the program's state freed, the reference works out, from the same
seed, the initial particles, the ``warm_steps`` steps, one segment, and
the likelihood at those inputs, and :mod:`portbench.compare` judges the
port's start state, its last segment's output and its likelihood.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from portbench import compare, datagen, spec

__all__ = ["main", "run_cell", "reference_states", "judge_run", "FORBIDDEN"]

# top-level modules the process must not hold once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "dibs_tpu")


def _log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def process_age_s() -> float:
    """Seconds since this process started (from ``/proc``; 0 elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class _Window:
    """The measured window: per-step CUDA events (host clock on the CPU)."""

    def __init__(self, torch, device):
        self.torch, self.cuda = torch, device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = self.torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def step_ms(self) -> list:
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(self.marks,
                                                       self.marks[1:])]
        return [1e3 * (b - a) for a, b in zip(self.marks, self.marks[1:])]


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reference_states(cell: spec.Cell, x, seed: int, prec, device,
                     stage=None) -> dict:
    """The reference's run of the cell keyed by ``seed`` at precision
    ``prec``: the leaves of the initial particles (``init``), after the
    traffic's ``warm_steps`` (``start``) and after one segment more
    (``end``); with ``stage`` (the likelihood stage's recorded inputs),
    also the reference's likelihood at them (``stage``)."""
    cfg, traffic = cell.config, cell.traffic
    ref = spec.load_reference(cfg["reference"]).Reference(
        cfg, x, prec, device, **cfg.get("reference_options", {}))
    r = ref.init_state(seed)
    out = {"init": r.leaves()}
    for name, n in (("start", traffic["warm_steps"]),
                    ("end", traffic["segment_steps"])):
        for _ in range(n):
            r = ref.step(r, seed)
        out[name] = r.leaves()
    if stage is not None:
        out["stage"] = ref.likelihood(stage["z"], stage["theta"],
                                      stage["t"], seed)
    return out


def judge_run(cell: spec.Cell, port: dict, ref: dict) -> dict:
    """Every number of :mod:`portbench.compare` of the port's run against
    the reference's (``port``: ``start``, ``end``, ``stage_out``,
    ``replay``)."""
    limits = cell.config["limits"]
    values = compare.numbers(cell.config["compare"], port["start"],
                             port["end"], ref["init"], ref["start"],
                             ref["end"], limits)
    if port["stage_out"] is None or "stage" not in ref:
        # the likelihood never ran: its numbers read infinite
        values.update({k: float("inf") for k in limits
                       if k.startswith("lik_")})
    else:
        values.update(compare.stage_numbers(port["stage_out"], ref["stage"],
                                            limits))
    values["replay"] = port["replay"]
    return values


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float = None):
    """Runs ``cell`` once; returns the result line (``checks`` last),
    every number of :func:`judge_run`, and the port's compared outputs
    with its recorded likelihood stage (``port``) and the reference's run
    (``ref``). ``t_start`` is the process's start on the
    ``time.perf_counter`` clock."""
    import torch

    from portbench.reference.common import REFERENCE

    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cfg, traffic = cell.config, cell.traffic
    s0, seg = traffic["warm_steps"], traffic["segment_steps"]

    _log(f"torch imported at {time.perf_counter() - t_start:.2f} s")
    data = datagen.make_data(cfg)
    engine = spec.load_system(cfg["system"]).build(cfg, data.x, device)
    built = engine.prepare()
    _log(f"data and engine at {time.perf_counter() - t_start:.2f} s"
         + (f" (the kernel library built in {built:.2f} s of it)"
            if built else ""))
    state = engine.init_state(seed)
    _sync(torch, device)
    _log(f"particles at {time.perf_counter() - t_start:.2f} s")
    state = engine.run(state, 1)
    _sync(torch, device)
    _log(f"first step at {time.perf_counter() - t_start:.2f} s")
    start = engine.run(state, s0 - 1)
    del state
    _sync(torch, device)
    _log(f"set-up done ({s0} steps) at {time.perf_counter() - t_start:.2f} s")

    window = _Window(torch, device)
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        # verbose: each operator carries its Python stack (the readers
        # match kernels to the program's files by it)
        prof = profile(activities=acts, record_shapes=True, with_stack=True,
                       experimental_config=torch._C._profiler.
                       _ExperimentalConfig(verbose=True))
        prof.start()
    t_w0 = time.perf_counter()
    setup_s = t_w0 - t_start
    window.mark()
    segments, last = 0, None
    while segments == 0 or time.perf_counter() - t_w0 < seconds:
        last = engine.run(start, seg, on_step=window.mark)
        segments += 1
    _sync(torch, device)
    window_s = time.perf_counter() - t_w0
    # a step of a system that steps several datasets at once counts each
    steps = segments * seg * getattr(engine, "datasets", 1)
    step_ms = window.step_ms()
    out_metrics, breakdown = {}, None
    if prof is not None:
        from portbench.trace import collect

        prof.stop()
        tr = collect(prof, segments * seg, window_s)
        del prof
        _log(f"trace: {len(tr.kernels)} kernels, {tr.n_stacks} operators "
             f"with a Python stack, over {tr.steps} steps")
        for m in cell.per_layer:
            value = spec.load_reader(m["name"], cell.root)(tr, cell)
            if value is not None:
                out_metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = tr.breakdown()
        busy = {"busy_s": tr.busy_s, "window_s": window_s}
    else:
        e2e = {"steps_per_s": steps / window_s,
               "step_ms_p95": (float(np.percentile(step_ms, 95)) if step_ms
                               else None),
               "setup_s": setup_s}
        for m in cell.end_to_end:
            if m["name"] == "peak_mem_gb":
                continue  # read below, with the device's peak
            out_metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
        busy = {}
    _log(f"window: {segments} segments, {steps} steps in {window_s:.3f} s")

    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules loaded in the process: {found}")
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device)
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": peak, **busy}
    else:
        peak = 0
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0, **busy}
    if not trace and any(m["name"] == "peak_mem_gb" for m in cell.end_to_end):
        out_metrics["peak_mem_gb"] = {"value": peak / 1e9, "unit": "GB"}

    # the window's last segment once more, after the window: its last
    # step again (it must give the window's bits), and the likelihood's
    # part of that step on its inputs; then the comparison, with the
    # program's state freed
    leaves = cfg["compare"]
    before = engine.run(start, seg - 1)
    again = engine.run(before, 1)
    stage = engine.likelihood(before)
    _sync(torch, device)
    mine = {k: v for k, v in engine.leaves(last).items() if k in leaves}
    port = {"start": {k: v for k, v in engine.leaves(start).items()
                      if k in leaves},
            "end": mine,
            "replay": compare.replay_gap(mine, engine.leaves(again)),
            "stage_out": stage.pop("out"),
            "stage_in": stage}
    del before
    del engine, start, last, again
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference_states(cell, data.x, seed, REFERENCE, device,
                           port["stage_in"])
    values = judge_run(cell, port, ref)
    _sync(torch, device)
    _log(f"reference: {s0 + seg} steps in {time.perf_counter() - t_ref:.1f} s")
    correct = compare.judge(values, cfg["limits"])
    # one segment's output is judged: attempted counts the segments run
    line = {"correct": correct, "attempted": segments,
            "failed": 0 if correct else 1, "metrics": out_metrics,
            "device": info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {k: {"value": v, "limit": cfg["limits"][k]}
                      for k, v in compare.judged(values, cfg["limits"]).items()}
    return line, values, {"port": port, "ref": ref}


def main(argv=None) -> int:
    t_start = time.perf_counter() - process_age_s()
    parser = argparse.ArgumentParser(description="Runs one benchmark cell "
                                     "once and prints its result line.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    if args.seed < 0:
        _log(f"--seed must be a whole number >= 0, got {args.seed}")
        return 2
    cell = spec.load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        _log(f"{args.workload} needs {cell.chips} CUDA device(s); found "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 1
    try:
        line = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                        "cuda", t_start)[0]
    except RuntimeError as err:
        _log(f"run failed: {err}")
        return 1
    for name, c in line["checks"].items():
        _log(f"check {name} = {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(line), flush=True)
    return 0
