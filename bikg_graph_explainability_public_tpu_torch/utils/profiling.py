"""Tracing / profiling hooks.

The reference has no profiling subsystem (SURVEY §5: only pytest
``--durations`` and notebook wall-clocks).  Here per-phase timing and
``torch.profiler`` traces are first-class.  A phase that launched device
work synchronises its device at exit, so its time covers that work.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator

import torch


def _sync(target) -> None:
    """``torch.cuda.synchronize`` for a CUDA device (or a tensor on one);
    nothing for the CPU."""
    dev = target.device if isinstance(target, torch.Tensor) else torch.device(target)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class PhaseTimer:
    """Accumulates wall-clock per named phase (host-side; device work is
    synchronised at phase exit)."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync=None) -> Iterator[None]:
        """Context manager timing one named phase.  ``sync``: a device (or
        a tensor's device) to synchronise at exit, or None."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _sync(sync)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        """Table of phase -> seconds and calls, longest first."""
        lines = ["phase                          total_s   calls"]
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(f"{name:<30} {total:8.3f}   {self.counts[name]}")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Capture a ``torch.profiler`` trace of the host and, where CUDA is
    available, the card; on exit it is written into ``log_dir`` as a Chrome
    trace (``trace_<pid>_<ns>.json``, view in ``chrome://tracing`` or
    Perfetto).  Yields the profiler, whose ``key_averages()`` sum the
    events by name."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    )


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region in the device trace (and an NVTX range on CUDA)."""
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield
