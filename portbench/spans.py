"""The program's own spans and counters (``dibs_tpu_torch.profiling``) as
the readers of the span metrics use them: the traced window's span log and
counters, each kernel given to the innermost span open when its launching
operator started, the device's idle gaps that fall inside a step, and the
work of the counted kernels at the frozen counts of
:mod:`portbench.workcount`.

The program logs a span as ``(name, thread, start_ns, end_ns)`` on the
``time.time_ns()`` clock, the clock ``torch.profiler`` stamps its events
with, so a span's interval and an operator's start compare directly. A
kernel belongs to the span with the latest start among those open at its
operator's start: the innermost one, whichever thread opened it, because
a thread that opens a span inside another's is one the other waits on
(autograd's engine thread while the caller sits in ``autograd.grad``).

Where the program keeps no span log (a tree before it) or logged nothing,
:func:`log` and :func:`counters` give ``None`` and the readers ``None``.
"""
from __future__ import annotations

import bisect

from portbench import workcount

__all__ = ["log", "counters", "innermost", "owners", "ms_in", "idle_ms",
           "wide_pass2_bound_s", "bge_pairs_bound_s"]

# spans scanned back from the latest start before a time: more than the
# spans one step opens
_SCAN = 256


def _program_call(name):
    try:
        from dibs_tpu_torch import profiling
    except ImportError:
        return None
    fn = getattr(profiling, name, None)
    return None if fn is None else fn()


def log():
    """The window's spans as ``(name, start_ns, end_ns)`` by start, or
    ``None``."""
    spans = _program_call("spans")
    if not spans:
        return None
    return sorted(((s[0], s[2], s[3]) for s in spans), key=lambda s: s[1])


def counters():
    """The window's counters (:func:`dibs_tpu_torch.profiling.counters`),
    or ``None``."""
    return _program_call("counters") or None


def innermost(spans, starts, t_ns: int):
    """The name of the innermost span of ``spans`` (by start; ``starts``
    their starts) open at ``t_ns``, or ``None``."""
    i = bisect.bisect_right(starts, t_ns) - 1
    for j in range(i, max(i - _SCAN, -1), -1):
        if spans[j][2] >= t_ns:
            return spans[j][0]
    return None


def owners(trace, spans):
    """Each kernel of the window with the innermost span open at its
    launching operator's start (``None`` where none was, or where the
    kernel has no operator)."""
    starts = [s[1] for s in spans]
    return [(k, None if k.op is None else innermost(spans, starts, k.op[1]))
            for k in trace.kernels]


def ms_in(trace, spans, names) -> float:
    """Device ms a step of the kernels whose span (:func:`owners`) is one
    of ``names``; ``None`` where none is."""
    ns = [k.end_ns - k.start_ns for k, owner in owners(trace, spans)
          if owner in names]
    if not ns or not trace.steps:
        return None
    return sum(ns) / 1e6 / trace.steps


def idle_ms(trace, spans, name: str = "dibs.step") -> float:
    """Device idle ms a step in the gaps between the device's busy
    intervals whose midpoint lies inside a span ``name``; ``None`` where
    the window holds no such span or no device operation."""
    steps = [(s, e) for n, s, e in spans if n == name]
    if not steps or not trace.device_ops or not trace.steps:
        return None
    busy = []
    for o in trace.device_ops:  # by start
        if busy and o.start_ns <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], o.end_ns)
        else:
            busy.append([o.start_ns, o.end_ns])
    starts = [s for s, _ in steps]
    ns = 0
    for (_, g0), (g1, _) in zip(busy, busy[1:]):
        mid = (g0 + g1) // 2
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and steps[i][1] >= mid:
            ns += g1 - g0
    return ns / 1e6 / trace.steps


def wide_pass2_bound_s(cell, counts):
    """The least seconds of the window's wide pass-2 calls: the frozen
    count of one call of the configuration's shape at the mean replayed
    (particle, sample) pairs a call, times the calls; ``None`` without
    the shape or the counters."""
    shapes = [w["shape"] for w in cell.config.get("step_work", [])
              if w["kernel"] == "fused_linear_wide_pass2"]
    calls = counts.get("wide_pass2.calls", 0)
    if not shapes or not calls or "wide_pass2.replayed" not in counts:
        return None
    shape = dict(shapes[0], replayed=counts["wide_pass2.replayed"] / calls)
    return calls * workcount.bound_s(
        *workcount.kernel_cost("fused_linear_wide_pass2", **shape))


def bge_pairs_bound_s(counts):
    """The least seconds of the window's #2 calls: the frozen count's
    operations of every counted (graph, node) pair by its parent count k
    and its bytes at the mean graphs a call, at the mean a call, times the
    calls; ``None`` without the counters."""
    hist = counts.get("bge_pairs.parents")
    calls = counts.get("bge_pairs.calls", 0)
    if not hist or not calls or not any(hist):
        return None
    d = len(hist) - 1
    flops = sum(n * workcount.kernel_cost("bge_pairs", parent_counts=[k],
                                          graphs=0, d=d)[0]
                for k, n in enumerate(hist) if n)
    _, n_bytes = workcount.kernel_cost(
        "bge_pairs", parent_counts=[],
        graphs=counts.get("bge_pairs.graphs", 0) / calls, d=d)
    return calls * workcount.bound_s(flops / calls, n_bytes)
