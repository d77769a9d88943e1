"""The program's own spans in a traced run.

The program names its host work with spans (its ``utils/profiling.py``):
under ``torch.profiler`` each is a host event ``bikg.<name>``, and inside
its ``recording()`` a recorder keeps them with their parents, requests and
counters.  From the profile, :func:`idle_split` divides every idle interval
of the card by overlap among the innermost spans covering it; from a
recorder, :func:`recorded` sums the spans per root.  The readers below take
a run's record whose ``profile`` carries both; a record without them, as
from a program that has no spans, reads as None.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from bench_port import trace

PREFIX = "bikg."
UNNAMED = "unnamed"


def _idle_intervals(events) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The card's idle intervals inside the window annotation, as
    ``trace.summarize`` finds them: the window less the union of the card's
    kernels and copies."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    win = [e for e in events if e.name() == trace.WINDOW and e.device_type() == cpu]
    if not win:
        return None
    w0 = min(e.start_ns() for e in win)
    w1 = max(e.start_ns() + e.duration_ns() for e in win)
    ds, de = [], []
    for e in events:
        if e.device_type() != cuda or e.is_user_annotation() or e.name() == trace.WINDOW:
            continue
        lo, hi = max(e.start_ns(), w0), min(e.start_ns() + e.duration_ns(), w1)
        if hi > lo:
            ds.append(lo)
            de.append(hi)
    us, ue = trace._union(np.asarray(ds, np.int64), np.asarray(de, np.int64))
    gs = np.concatenate([[w0], ue]).astype(np.int64)
    ge = np.concatenate([us, [w1]]).astype(np.int64)
    keep = ge > gs
    return gs[keep], ge[keep]


def _innermost(spans: List[Tuple[int, int, str]]):
    """Boundaries ``t`` and, for each piece ``[t[i], t[i+1])``, the name of
    the innermost span covering it, or :data:`UNNAMED` where none does or
    only a root span (one no other span encloses) does."""
    bounds = sorted({t for s, e, _ in spans for t in (s, e)})
    # at a shared start the longer span opens first, so the shorter is innermost
    opening = sorted(spans, key=lambda x: (x[0], -x[1]))
    open_: List[Tuple[int, str, bool]] = []  # (end, name, is_root), outermost first
    labels, at = [], 0
    for t in bounds[:-1]:
        open_ = [o for o in open_ if o[0] > t]
        while at < len(opening) and opening[at][0] == t:
            s, e, name = opening[at]
            if e > s:
                open_.append((e, name, not open_))
            at += 1
        top = open_[-1] if open_ else None
        labels.append(UNNAMED if top is None or top[2] else top[1])
    return np.asarray(bounds, np.int64), labels


def split_idle(gs: np.ndarray, ge: np.ndarray,
               spans: List[Tuple[int, int, str]]) -> Tuple[Dict[str, float], float]:
    """Idle seconds (intervals ``[gs, ge)``, sorted and disjoint, in ns) by
    the innermost span covering each part of them, split by overlap:
    ``(by span name, unnamed)``."""
    lens = ge - gs
    cum = np.concatenate([[0], np.cumsum(lens)])

    def idle_before(t: np.ndarray) -> np.ndarray:
        k = np.searchsorted(gs, t, side="right") - 1
        inside = np.clip(t - gs[np.maximum(k, 0)], 0, lens[np.maximum(k, 0)])
        return np.where(k >= 0, cum[np.maximum(k, 0)] + inside, 0)

    total = float(lens.sum()) * 1e-9
    if not spans or not lens.size:
        return {}, total
    bounds, labels = _innermost(spans)
    pieces = np.diff(idle_before(bounds)) * 1e-9
    by: Dict[str, float] = {}
    for name, sec in zip(labels, pieces):
        by[name] = by.get(name, 0.0) + float(sec)
    unnamed = by.pop(UNNAMED, 0.0) + total - float(pieces.sum())
    return dict(sorted(by.items(), key=lambda kv: -kv[1])), unnamed


def idle_split(prof) -> Optional[Dict]:
    """``idle_by_span`` (seconds by ``bikg.*`` name) and ``idle_unnamed_s``
    of a profile with the window annotation; None where it has no
    ``bikg.*`` event."""
    events = prof.profiler.kineto_results.events()
    cpu = torch.autograd.DeviceType.CPU
    spans = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in events
             if e.device_type() == cpu and e.name().startswith(PREFIX)]
    idle = _idle_intervals(events)
    if not spans or idle is None:
        return None
    by, unnamed = split_idle(*idle, spans)
    return {"idle_by_span": by, "idle_unnamed_s": unnamed}


def recorded(rec) -> Optional[Dict]:
    """A recorder's spans summed per root: ``{"roots": {root: requests},
    "by_span": {root: {span: {calls, total_s, self_s, counters...}}}}``, or
    None where it kept nothing."""
    tot = rec.totals()
    if not tot:
        return None
    by: Dict[str, Dict[str, Dict]] = {}
    for (root, name), t in tot.items():
        by.setdefault(root, {})[name] = dict(t)
    return {"roots": {r: int(by[r][r]["calls"]) for r in by}, "by_span": by}


# -- readers: a total a root, from a record's ``profile`` ---------------------


def _per_root(record, root: str) -> Optional[Tuple[int, Dict[str, Dict]]]:
    sp = (record.get("profile") or {}).get("spans")
    n = (sp or {}).get("roots", {}).get(root)
    if not n:
        return None
    return n, sp["by_span"][root]


def self_ms(record, root: str, name: str) -> Optional[float]:
    """Self milliseconds of span ``name`` a ``root`` request."""
    got = _per_root(record, root)
    if got is None or name not in got[1]:
        return None
    n, by = got
    return 1000.0 * by[name]["self_s"] / n


def counter_mb(record, root: str, counter: str) -> Optional[float]:
    """Counter ``counter`` summed over every span of a ``root`` request,
    in 1e6 units a request."""
    got = _per_root(record, root)
    if got is None:
        return None
    n, by = got
    return sum(t.get(counter, 0) for t in by.values()) / n / 1e6


def idle_unnamed_pct(record) -> Optional[float]:
    """100 x the card's idle seconds that no non-root span covers / its
    idle seconds, in the profiled slice."""
    p = record.get("profile") or {}
    idle = p.get("window_s", 0.0) - p.get("busy_s", 0.0)
    if "idle_unnamed_s" not in p or idle <= 0:
        return None
    return 100.0 * p["idle_unnamed_s"] / idle


#: the readings of a traced run, by the name a per-layer metric would take
READINGS = {
    "plan_stack_ms.many": lambda r: self_ms(r, "many.call", "plan.stack"),
    "plan_upload_ms.many": lambda r: self_ms(r, "many.call", "plan.upload"),
    "upload_mb.many": lambda r: counter_mb(r, "many.call", "upload_bytes"),
    "idle_unnamed_pct.many": lambda r: idle_unnamed_pct(r) if _per_root(r, "many.call") else None,
    "prepare_graph_ms.run": lambda r: self_ms(r, "run.request", "prepare_graph"),
    "fit_host_ms.run": lambda r: self_ms(r, "run.request", "fit"),
    "upload_mb.run": lambda r: counter_mb(r, "run.request", "upload_bytes"),
    "idle_unnamed_pct.run": lambda r: idle_unnamed_pct(r) if _per_root(r, "run.request") else None,
}


def readings(record) -> Dict[str, float]:
    """Every reading of :data:`READINGS` the record has."""
    out = {}
    for name, read in READINGS.items():
        v = read(record)
        if v is not None:
            out[name] = v
    return out
