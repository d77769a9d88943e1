"""Tracing: spans, counters, a recorder and a per-phase timer.

The reference has no profiling subsystem (SURVEY §5: only pytest
``--durations`` and notebook wall-clocks).  Here the program names its own
host work.  A :func:`span` marks one region of it:

- with nobody listening it is one shared ``nullcontext`` after a single
  check, so the untraced program pays almost nothing;
- under ``torch.profiler`` it is a ``record_function`` event named
  ``bikg.<name>``, on the clock of the card's kernels and copies;
- inside :func:`recording` the active :class:`Recorder` also keeps it, with
  its parent, its request (the root span's sequence number) and the
  counters that :func:`count` added to it.

:class:`PhaseTimer` times named phases on top of spans; a phase that
launched device work synchronises its device at exit (the ``sync`` span),
so its time covers that work.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import torch

#: what :func:`span` returns with nobody listening (one object, never allocated anew)
_NULL = contextlib.nullcontext()
#: the recorder of the innermost open :func:`recording`, or None
_recorder: Optional["Recorder"] = None


@dataclass
class SpanRecord:
    """One span as a :class:`Recorder` keeps it.  Times are Unix-epoch
    nanoseconds (``time.time_ns``), the clock of ``torch.profiler``'s host
    events; ``end_ns`` is None while the span is open.  ``parent`` is the
    index of the enclosing span in :attr:`Recorder.spans` (None for a root),
    ``request`` the root's sequence number, ``child_ns`` the time its child
    spans cover."""

    name: str
    start_ns: int
    parent: Optional[int]
    request: int
    end_ns: Optional[int] = None
    child_ns: int = 0
    counters: Dict[str, int] = field(default_factory=dict)

    @property
    def seconds(self) -> float:
        """The span's time."""
        return (self.end_ns - self.start_ns) * 1e-9

    @property
    def self_seconds(self) -> float:
        """The span's time less what its child spans cover."""
        return (self.end_ns - self.start_ns - self.child_ns) * 1e-9


class Recorder:
    """The spans opened while it was active, in memory, in the order they
    opened.  Each thread nests its own spans."""

    def __init__(self) -> None:
        self.spans: List[SpanRecord] = []
        self._roots: List[int] = []  # request id -> index of its root span
        self._local = threading.local()
        self._lock = threading.Lock()

    def _stack(self) -> List[int]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _open(self, name: str) -> int:
        st = self._stack()
        with self._lock:
            idx = len(self.spans)
            if st:
                parent = st[-1]
                request = self.spans[parent].request
            else:
                parent, request = None, len(self._roots)
                self._roots.append(idx)
            self.spans.append(SpanRecord(name, time.time_ns(), parent, request))
        st.append(idx)
        return idx

    def _close(self, idx: int) -> None:
        s = self.spans[idx]
        s.end_ns = time.time_ns()
        self._stack().pop()
        if s.parent is not None:
            self.spans[s.parent].child_ns += s.end_ns - s.start_ns

    def _count(self, name: str, n: int) -> None:
        st = self._stack()
        if st:
            c = self.spans[st[-1]].counters
            c[name] = c.get(name, 0) + int(n)

    def _root_of(self, span: SpanRecord) -> str:
        """The name of the root span of ``span``'s request."""
        return self.spans[self._roots[span.request]].name

    def totals(self) -> Dict[Tuple[str, str], Dict[str, float]]:
        """Closed spans summed per (root name, span name): ``calls``,
        ``total_s``, ``self_s`` and each counter.  A root's own entry
        ``(root, root)`` counts its requests in ``calls``."""
        out: Dict[Tuple[str, str], Dict[str, float]] = {}
        for s in self.spans:
            if s.end_ns is None:
                continue
            t = out.setdefault((self._root_of(s), s.name),
                               {"calls": 0, "total_s": 0.0, "self_s": 0.0})
            t["calls"] += 1
            t["total_s"] += s.seconds
            t["self_s"] += s.self_seconds
            for k, v in s.counters.items():
                t[k] = t.get(k, 0) + v
        return out


class _Span:
    """A span somebody listens to: a profiler event, a record, or both."""

    __slots__ = ("_name", "_rec", "_prof", "_rf", "_idx")

    def __init__(self, name: str, rec: Optional[Recorder], prof: bool):
        self._name, self._rec, self._prof = name, rec, prof

    def __enter__(self) -> None:
        if self._prof:
            self._rf = torch.profiler.record_function("bikg." + self._name)
            self._rf.__enter__()
        if self._rec is not None:
            self._idx = self._rec._open(self._name)

    def __exit__(self, *exc) -> None:
        if self._rec is not None:
            self._rec._close(self._idx)
        if self._prof:
            self._rf.__exit__(*exc)


def span(name: str):
    """Context manager naming one region of the program's work (see the
    module docstring); the shared ``nullcontext`` when nobody listens."""
    rec = _recorder
    prof = torch.autograd._profiler_enabled()
    if rec is None and not prof:
        return _NULL
    return _Span(name, rec, prof)


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name`` of the innermost open span of this
    thread; nothing when no recorder is active."""
    rec = _recorder
    if rec is not None:
        rec._count(name, n)


def recorder() -> Optional[Recorder]:
    """The active recorder, or None: for counters that cost something to
    read."""
    return _recorder


@contextlib.contextmanager
def recording() -> Iterator[Recorder]:
    """Keep every span opened inside the block in a new :class:`Recorder`
    (in memory; nothing is written), and yield it."""
    global _recorder
    rec = Recorder()
    prev, _recorder = _recorder, rec
    try:
        yield rec
    finally:
        _recorder = prev


def _sync(target) -> None:
    """``torch.cuda.synchronize`` for a CUDA device (or a tensor on one);
    nothing for the CPU."""
    dev = target.device if isinstance(target, torch.Tensor) else torch.device(target)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class PhaseTimer:
    """Accumulates wall-clock per named phase (host-side; device work is
    synchronised at phase exit).  Each phase is a :func:`span`, and its
    synchronisation a ``sync`` span inside it."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync=None) -> Iterator[None]:
        """Context manager timing one named phase.  ``sync``: a device (or
        a tensor's device) to synchronise at exit, or None."""
        t0 = time.perf_counter()
        try:
            with span(name):
                try:
                    yield
                finally:
                    if sync is not None:
                        with span("sync"):
                            _sync(sync)
        finally:
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
    available, the card, with the program's ``bikg.*`` spans; on exit it is
    written into ``log_dir`` as a Chrome trace (``trace_<pid>_<ns>.json``,
    view in ``chrome://tracing`` or Perfetto).  Yields the profiler, whose
    ``key_averages()`` sum the events by name."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    )
