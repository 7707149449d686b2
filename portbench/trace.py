"""The traced window: ``torch.profiler`` over the measured window (CPU and
CUDA activities, input shapes, Python frames), reduced to what the
per-layer readers need.

* every device operation's name and interval, and for a kernel launched
  from PyTorch the operator that launched it, with the operator's Python
  stack, so that a reader can ask which kernels were launched from inside
  a file of the program (:meth:`Trace.launched_from`);
* the busy seconds (the union of the device intervals), the window's
  length, the steps it holds, the top device operations and the longest
  idle gaps of the device with what the host was doing in each.
"""
from __future__ import annotations

import bisect
from typing import NamedTuple, Optional

__all__ = ["DeviceOp", "Trace", "collect"]


class DeviceOp(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    kernel: bool  # a kernel (not a copy or a memset)
    # (thread, start_ns, Python stack) of the launching operator
    op: Optional[tuple]


def _short(name: str) -> str:
    """A kernel's name without its return type, namespace marker and
    arguments, at most 120 characters."""
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    return name.split("(")[0].strip()[:120]


class Trace:
    def __init__(self, device_ops, host_ops, steps, window_s):
        self.device_ops = sorted(device_ops, key=lambda o: o.start_ns)
        self.kernels = [o for o in self.device_ops if o.kernel]
        self._host_ops = host_ops  # [(start, end, name)] of the main thread
        self.steps = steps
        self.window_s = window_s
        self._busy = self._union()
        self.busy_s = sum(e - s for s, e in self._busy) / 1e9

    def _union(self):
        out = []
        for o in self.device_ops:
            if out and o.start_ns <= out[-1][1]:
                out[-1][1] = max(out[-1][1], o.end_ns)
            else:
                out.append([o.start_ns, o.end_ns])
        return out

    def matching(self, *fragments: str):
        """The kernels whose name holds one of ``fragments``."""
        return [k for k in self.kernels if any(f in k.name for f in fragments)]

    @staticmethod
    def seconds(ops) -> float:
        return sum(o.end_ns - o.start_ns for o in ops) / 1e9

    def launched_from(self, path_fragment: str):
        """The kernels launched by an operator with a frame of a file whose
        path holds ``path_fragment`` on its Python stack; ``None`` where the
        trace recorded no stacks."""
        if not any(k.op and k.op[2] for k in self.kernels):
            return None
        return [k for k in self.kernels
                if k.op and any(path_fragment in f for f in k.op[2])]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations with most time, and the longest idle gaps
        of the device labelled by the host operator running at the gap's
        middle (``host idle`` where none ran)."""
        by_name = {}
        for o in self.device_ops:
            key = _short(o.name)
            by_name[key] = by_name.get(key, 0.0) + (o.end_ns - o.start_ns) / 1e9
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in
                       zip(self._busy, self._busy[1:])), reverse=True)[:top]
        starts = [h[0] for h in self._host_ops]
        labelled = []
        for length, g0, g1 in gaps:
            mid = (g0 + g1) // 2
            label = "host idle"
            last = bisect.bisect_right(starts, mid) - 1
            # the latest-starting operator still running (nested operators
            # start after their parents)
            for i in range(last, max(last - 256, -1), -1):
                if self._host_ops[i][1] >= mid:
                    label = self._host_ops[i][2]
                    break
            labelled.append([label, length / 1e9])
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": labelled}


def collect(prof, steps: int, window_s: float) -> Trace:
    """The :class:`Trace` of a stopped ``torch.profiler.profile``."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    ops_by_corr = {}
    host_ops = []
    main = None
    device = []
    for e in events:
        if e.device_type() == cuda:
            device.append(e)
            continue
        if e.correlation_id() and not e.linked_correlation_id():
            # an operator of PyTorch's (runtime calls link to one)
            ops_by_corr[e.correlation_id()] = (e.start_thread_id(),
                                               e.start_ns(), tuple(e.stack()))
            if e.name().startswith("aten::"):
                host_ops.append((e.start_ns(), e.end_ns(), e.name(),
                                 e.start_thread_id()))
    if host_ops:
        counts = {}
        for h in host_ops:
            counts[h[3]] = counts.get(h[3], 0) + 1
        main = max(counts, key=counts.get)
    host_main = sorted((h[0], h[1], h[2]) for h in host_ops if h[3] == main)
    device_ops = []
    for e in device:
        name = e.name()
        kernel = not (name.startswith("Memcpy") or name.startswith("Memset"))
        device_ops.append(DeviceOp(name, e.start_ns(), e.end_ns(), kernel,
                                   ops_by_corr.get(e.linked_correlation_id())))
    trace = Trace(device_ops, host_main, steps, window_s)
    trace.n_stacks = sum(1 for op in ops_by_corr.values() if op[2])
    return trace
