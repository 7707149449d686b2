"""Arithmetic the per-layer readers share: a configuration's work a step
from its ``step_work`` list and the frozen counts of
:mod:`portbench.workcount`, and a kernel's share of its roofline in the
traced window."""
from __future__ import annotations

from portbench import workcount

__all__ = ["step_bound_s", "step_flops", "roofline_pct", "ms_per_step"]


def _entries(cell, kernel):
    return [w for w in cell.config.get("step_work", [])
            if w["kernel"] == kernel]


def step_bound_s(cell, kernel: str):
    """The least seconds one engine step's calls of ``kernel`` could take
    (``None`` where the configuration lists none)."""
    entries = _entries(cell, kernel)
    if not entries:
        return None
    return sum(w.get("calls", 1)
               * workcount.bound_s(*workcount.kernel_cost(kernel, **w["shape"]))
               for w in entries)


def step_flops(cell):
    """The float32 operations of one engine step: the sum of the frozen
    counts of everything its ``step_work`` lists (``None`` where it lists
    nothing)."""
    work = cell.config.get("step_work")
    if not work:
        return None
    return sum(w.get("calls", 1)
               * workcount.kernel_cost(w["kernel"], **w["shape"])[0]
               for w in work)


def roofline_pct(trace, cell, kernel: str, ops) -> float:
    """``100 x`` the least time of the window's calls of ``kernel`` over the
    device time of ``ops``; ``None`` where there is nothing to read."""
    bound = step_bound_s(cell, kernel)
    if bound is None or not ops:
        return None
    return 100.0 * bound * trace.steps / trace.seconds(ops)


def ms_per_step(trace, ops) -> float:
    """Device milliseconds a step of ``ops`` (``None`` where none ran)."""
    if not ops:
        return None
    return 1e3 * trace.seconds(ops) / trace.steps
