"""Training observability: step timing, device profiling, and the engine's
own layer spans and work counters (counterpart of ``dibs_tpu/profiling.py``).

* :class:`StepTimer`: a ``sample()`` callback measuring wall time and
  steps/s per callback chunk; on a CUDA ``zs`` it synchronizes the device
  first, so a chunk's time is the device's, not the enqueue's.
* :func:`trace`: a context around :class:`torch.profiler.profile` (CPU and,
  where CUDA is present, CUDA activities, with input shapes and Python
  stacks) writing a Chrome trace and the span log into ``log_dir``.
* :func:`span`, :func:`spans`, :func:`counters`: the layers of an SVGD step
  (``dibs.step``, ``dibs.likelihood`` and its sampler, score and gradient
  parts, ``dibs.prior`` and its parts, ``dibs.transport``, ``dibs.update``)
  and the work the data-dependent kernels did (the parent counts #2 served,
  the samples wide pass 2 replayed).

Spans and counters record only while a ``torch.profiler`` records in the
process (:func:`recording`). Otherwise :func:`span` enters nothing and
logs nothing, :func:`counter` allocates nothing and hands the kernels no
pointer, and :func:`count` adds nothing. A traced window begins at the
first call here (a span, a counter, or a read of the log) that finds a
profiler recording after one that found none, and where :func:`trace`
starts; it clears what the window before it left. Reading the log after a
window marks its end, so two profiler windows with no call here between
them count as one only when nothing read the first.

A span enters a ``FUNCTION``-scope record function (the operators' scope),
so it shows in Chrome and Perfetto traces and a kernel the program launches
itself (through ``ctypes``) inside it is linked to a launching operator
(its body's record function, below). ``torch.profiler.record_function`` is not used: its user scope
makes the profiler add a ``gpu_user_annotation`` event on the device's
timeline for every span, which a reader of the device trace takes for a
kernel. Each span also appends ``(name, thread, start_ns, end_ns)`` to the
process's span log, stamped by ``time.time_ns()``, the clock the profiler
stamps its events with. The stamps are taken inside the span's record
function, so the logged interval and the profiler's event differ by a few
microseconds: stamped around it, the interval also held the record
function's own entry, whose first call in a window took 30-40 us, and past
100 us on a loaded host. Inside the stamps a second record function
(:data:`BODY`) holds the span's body, so a kernel the program launches
itself directly in the span is linked to an operator that starts after the
logged start and ends before the logged end: the innermost span open at
its operator's start is the span.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import List, NamedTuple, Optional

import torch

__all__ = ["StepTimer", "trace", "Span", "BODY", "recording", "span",
           "spans", "count", "counter", "counters"]


class StepTimer:
    """Callback recording wall-clock throughput between callback chunks::

        timer = StepTimer()
        dibs.sample(..., callback=timer, callback_every=100)
        print(timer.summary())

    The first timed chunk holds the warm-up (on the card, the kernels'
    build) and :meth:`summary` leaves it out.
    """

    def __init__(self, verbose: bool = False):
        self.verbose = verbose
        self._last_wall: Optional[float] = None
        self._last_t: int = 0
        self.chunks: List[dict] = []

    def __call__(self, **kwargs):
        t = int(kwargs["t"])
        zs = kwargs.get("zs")
        if zs is not None and zs.device.type == "cuda":
            torch.cuda.synchronize(zs.device)
        now = time.perf_counter()
        if self._last_wall is not None:
            steps = t - self._last_t
            dt = now - self._last_wall
            rec = {
                "t": t,
                "steps": steps,
                "seconds": dt,
                "steps_per_sec": steps / dt if dt > 0 else float("inf"),
            }
            self.chunks.append(rec)
            if self.verbose:
                print(f"[t={t}] {rec['steps_per_sec']:.1f} steps/s")
        self._last_wall = now
        self._last_t = t

    def summary(self) -> dict:
        """Steady throughput (drops the first timed chunk)."""
        steady = self.chunks[1:] if len(self.chunks) > 1 else self.chunks
        if not steady:
            return {"steps_per_sec": None, "chunks": len(self.chunks)}
        total_steps = sum(c["steps"] for c in steady)
        total_secs = sum(c["seconds"] for c in steady)
        return {
            "steps_per_sec": total_steps / total_secs,
            "chunks": len(self.chunks),
            "total_steps": total_steps,
        }


# ---------------------------------------------------------------------------
# spans and counters
# ---------------------------------------------------------------------------


class Span(NamedTuple):
    """One logged span: its name, the native id of the thread that opened
    it, and its interval on the ``time.time_ns()`` clock."""
    name: str
    thread: int
    start_ns: int
    end_ns: int


_profiler_enabled = torch._C._autograd._profiler_enabled
_RecordFunction = torch._C._profiler._RecordFunctionFast
_NULL = contextlib.nullcontext()
# the record function inside every span's stamps (not a span: no log entry)
BODY = "profiling.span_body"
_log: List[Span] = []
_host: dict = {}  # name -> int
_device: dict = {}  # name -> int64 tensor
_was_on = False


def _reset() -> None:
    _log.clear()
    _host.clear()
    _device.clear()


def recording() -> bool:
    """True while a ``torch.profiler`` records in this process. The first
    call that finds it recording after one that did not starts a new
    window: the span log and the counters are cleared."""
    global _was_on
    on = _profiler_enabled()
    if on and not _was_on:
        _reset()
    _was_on = on
    return on


class _Span:
    __slots__ = ("name", "start", "record", "body")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.record = _RecordFunction(self.name)
        self.body = _RecordFunction(BODY)
        self.record.__enter__()
        self.start = time.time_ns()
        self.body.__enter__()
        return self

    def __exit__(self, *exc):
        self.body.__exit__(None, None, None)
        end = time.time_ns()
        self.record.__exit__(None, None, None)
        _log.append(Span(self.name, threading.get_native_id(), self.start,
                         end))
        return False


def span(name: str):
    """A context marking one layer of the step: while a profiler records,
    a record function ``name`` and an entry of the span log; otherwise a
    context that does nothing."""
    return _Span(name) if recording() else _NULL


def spans() -> List[Span]:
    """The span log of the last traced window, by start; it stays readable
    after the profiler stops, until the next window begins."""
    recording()
    return sorted(_log, key=lambda s: s.start_ns)


def count(name: str, n: int) -> None:
    """Adds ``n`` to the host counter ``name`` while a profiler records."""
    if recording():
        _host[name] = _host.get(name, 0) + int(n)


def counter(name: str, size: int, device) -> Optional[torch.Tensor]:
    """The ``[size]`` int64 buffer of the counter ``name`` while a profiler
    records (allocated and zeroed at its first call in the window, on
    ``device``), for a kernel or a plain path to add into; ``None``
    otherwise. A counter has one size and one device a window."""
    if not recording():
        return None
    buf = _device.get(name)
    if buf is None:
        _device[name] = buf = torch.zeros(size, dtype=torch.int64,
                                          device=device)
    assert buf.numel() == size and buf.device == torch.device(device), (
        f"counter {name!r} asked for at [{size}] on {device}, "
        f"held at [{buf.numel()}] on {buf.device}")
    return buf


def counters() -> dict:
    """The counters of the last traced window: host counters and device
    counters of one element as ints, the others (histograms) as lists.
    Copies the device buffers to the host, so it synchronizes; read it
    after the window, not inside it."""
    recording()
    out = dict(_host)
    for name, buf in _device.items():
        vals = buf.tolist()
        out[name] = vals[0] if len(vals) == 1 else vals
    return out


@contextlib.contextmanager
def trace(log_dir: str):
    """Profiler context: ``with trace("traces"): dibs.sample(...)``.

    Records CPU activity and, where CUDA is available, the card's kernels,
    each operator with its input shapes and its Python stack (with the
    profiler's verbose experimental option, which keeps the stacks of
    every operator), and writes into ``log_dir`` ``trace.json`` (Chrome
    trace format; open it in ``chrome://tracing`` or Perfetto) and
    ``spans.json`` (:func:`spans` as ``[name, thread, start_ns, end_ns]``
    rows and :func:`counters`). Yields the :class:`torch.profiler.profile`
    object (``key_averages()`` for sums by kernel)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    _reset()
    with torch.profiler.profile(
            activities=acts, record_shapes=True, with_stack=True,
            experimental_config=torch._C._profiler._ExperimentalConfig(
                verbose=True)) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump({"spans": [list(s) for s in spans()],
                   "counters": counters()}, f)
