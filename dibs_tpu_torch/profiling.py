"""Training observability: step timing and device profiling (counterpart of
``dibs_tpu/profiling.py``).

* :class:`StepTimer`: a ``sample()`` callback measuring wall time and
  steps/s per callback chunk; on a CUDA ``zs`` it synchronizes the device
  first, so a chunk's time is the device's, not the enqueue's.
* :func:`trace`: a context around :class:`torch.profiler.profile` (CPU and,
  where CUDA is present, CUDA activities) writing a Chrome trace into
  ``log_dir``.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import List, Optional

import torch

__all__ = ["StepTimer", "trace"]


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


@contextlib.contextmanager
def trace(log_dir: str):
    """Profiler context: ``with trace("traces"): dibs.sample(...)``.

    Records CPU activity and, where CUDA is available, the card's kernels,
    and writes ``trace.json`` (Chrome trace format; open it in
    ``chrome://tracing`` or Perfetto) into ``log_dir``. Yields the
    :class:`torch.profiler.profile` object (``key_averages()`` for sums by
    kernel)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
