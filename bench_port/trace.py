"""Reading a ``torch.profiler`` pass over part of a traced run's window.

The profiler records the card's activity (kernels, copies, sets) and the
host's (operators, CUDA runtime calls, annotations) on one clock.  From
them: the window (the ``bench_port.window`` annotation), the seconds in
which anything ran on the card (the union of its intervals), the kernels
launched, every device operation's seconds (the ten that took most time
again apart, for the result's ``breakdown``), and the longest idle gaps of
the card by what the host was doing then.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

import numpy as np
import torch

WINDOW = "bench_port.window"


def profiler() -> torch.profiler.profile:
    """A profiler over the host and, where there is one, the card."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _union(starts: np.ndarray, ends: np.ndarray):
    """Merged intervals of the given ones."""
    if starts.size == 0:
        return starts, ends
    o = np.argsort(starts, kind="stable")
    s, e = starts[o], ends[o]
    run_end = np.maximum.accumulate(e)
    new = np.ones(s.size, bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.nonzero(new)[0]
    return s[idx], np.append(run_end[idx[1:] - 1], run_end[-1])


def summarize(prof) -> Dict:
    """``window_s``, ``busy_s``, ``kernels``, ``device_op_s`` (seconds by
    full name, every operation) and the top ten ``device_ops`` and
    ``idle_gaps`` of the profiled window."""
    events = prof.profiler.kineto_results.events()
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    win = [e for e in events if e.name() == WINDOW and e.device_type() == cpu]
    if not win:
        raise RuntimeError("the profile holds no window annotation")
    w0 = min(e.start_ns() for e in win)
    w1 = max(e.start_ns() + e.duration_ns() for e in win)
    dev_s, dev_e, dev_names, host = [], [], [], []
    kernels = 0
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == cuda:
            if e.is_user_annotation() or e.name() == WINDOW:
                continue  # an annotation's range on the card is no work of its own
            lo, hi = max(s, w0), min(s + d, w1)
            if hi <= lo:
                continue
            dev_s.append(lo)
            dev_e.append(hi)
            dev_names.append(e.name())
            if not e.name().startswith(("Memcpy", "Memset")):
                kernels += 1
        elif e.name() != WINDOW and d > 0:
            host.append((s, s + d, e.name()))
    ds, de = np.asarray(dev_s, np.int64), np.asarray(dev_e, np.int64)
    us, ue = _union(ds, de)
    busy_ns = int((ue - us).sum())
    per_op: Dict[str, float] = defaultdict(float)
    for name, a, b in zip(dev_names, ds, de):
        per_op[name] += (b - a) * 1e-9
    # idle gaps: before the first, between, and after the last busy interval
    gs = np.concatenate([[w0], ue])
    ge = np.concatenate([us, [w1]])
    keep = ge > gs
    gs, ge = gs[keep], ge[keep]
    return {
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": busy_ns * 1e-9,
        "kernels": kernels,
        "device_op_s": dict(per_op),
        "device_ops": sorted(per_op.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": _gaps_by_host(gs, ge, host)[:10],
    }


def _gaps_by_host(gs: np.ndarray, ge: np.ndarray, host: List) -> List:
    """Idle seconds by the innermost host event that spans each gap's
    middle ("python" where none does), longest first."""
    mids = (gs + ge) // 2
    order = np.argsort(mids, kind="stable")
    mids_sorted = mids[order]
    label = np.full(mids.size, -1, np.int64)
    names: List[str] = []
    # longest events first, so that the shortest one spanning a gap wins
    for s, e, name in sorted(host, key=lambda t: t[0] - t[1]):
        lo = np.searchsorted(mids_sorted, s, side="left")
        hi = np.searchsorted(mids_sorted, e, side="right")
        if hi > lo:
            label[lo:hi] = len(names)
            names.append(name)
    per: Dict[str, float] = defaultdict(float)
    dur = (ge - gs)[order] * 1e-9
    for li, d in zip(label, dur):
        per["python" if li < 0 else names[li]] += float(d)
    return sorted(per.items(), key=lambda kv: -kv[1])
