"""The program's own spans and counters, on the clock of a profiled stretch.

The program records its spans and counts (``repro_torch.tracing``) while a
profiler runs, so the tracer holds them for every profiled stretch of a
traced run, and adds nothing to the profile itself. Inside each harness
span ``index.lookup`` or ``index.insert`` the program opens one top span,
``uplif.lookup`` or ``uplif.insert``. ``calls`` pairs the harness spans of
the final stretch (``run.profile.spans``) one to one with the last top
spans the tracer recorded, and moves each call's spans onto the profile's
clock by the start of its harness span. Where the profile is missing, the
program recorded nothing (a program without the tracer), or the two do
not pair up, it gives None, and so does every reader built on it.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from perfharness.trace import busy_intervals, idle_gaps

#: the program's top span -> the harness span around it
HARNESS = {"uplif.lookup": "index.lookup", "uplif.insert": "index.insert"}


@dataclasses.dataclass
class Call:
    """One call into the index, as the program recorded it."""

    name: str                               # its top span
    spans: List[Tuple[str, float, float]]   # its spans, profile clock (s)
    durations: Dict[str, List[float]]       # each span name's seconds
    counts: Dict[str, int]                  # summed over its spans


def _snapshot() -> Optional[dict]:
    try:
        tracing = importlib.import_module("repro_torch.tracing")
    except ImportError:             # a program without the tracer
        return None
    return tracing.snapshot()


def calls(run, snap: Optional[dict] = None) -> Optional[List[Call]]:
    """The final stretch's calls, in order, or None (see the module)."""
    p = run.profile
    if p is None:
        return None
    snap = _snapshot() if snap is None else snap
    if not snap or not snap["spans"]:
        return None
    harness = sorted((s for s in p.spans if s[0] in HARNESS.values()),
                     key=lambda s: s[1])
    spans = snap["spans"]
    tops = [i for i, s in enumerate(spans) if s[1] < 0 and s[0] in HARNESS]
    if not harness or len(tops) < len(harness):
        return None
    tops = tops[-len(harness):]
    if any(HARNESS[spans[i][0]] != h[0] for i, h in zip(tops, harness)):
        return None
    # every span under its top span (a parent opens before its children)
    root = []
    for i, s in enumerate(spans):
        root.append(i if s[1] < 0 else root[s[1]])
    members: Dict[int, List[int]] = {i: [] for i in tops}
    for i, r in enumerate(root):
        if r in members:
            members[r].append(i)
    out = []
    for i, (_, a, b) in zip(tops, harness):
        if any(spans[j][3] is None for j in members[i]):
            return None                         # a span still open
        offset = a - 1e-9 * spans[i][2]
        call = Call(name=spans[i][0], spans=[], durations={}, counts={})
        for j in members[i]:
            name, _, t0, t1, counts = spans[j]
            call.spans.append((name, min(max(1e-9 * t0 + offset, a), b),
                               min(max(1e-9 * t1 + offset, a), b)))
            call.durations.setdefault(name, []).append(1e-9 * (t1 - t0))
            for k, n in counts.items():
                call.counts[k] = call.counts.get(k, 0) + n
        out.append(call)
    return out


def span_ms_p50(run, name: str) -> Optional[float]:
    """The median duration of the program span ``name`` in the final
    stretch, in ms."""
    cs = calls(run)
    if cs is None:
        return None
    xs = [d for c in cs for d in c.durations.get(name, ())]
    return 1e3 * float(np.median(xs)) if xs else None


def total(run, name: str) -> Optional[int]:
    """The counter ``name`` summed over the final stretch's calls."""
    cs = calls(run)
    if cs is None:
        return None
    return sum(c.counts.get(name, 0) for c in cs)


def overlap_s(a, b) -> float:
    """Seconds that two lists of sorted, disjoint intervals share."""
    i = j = 0
    out = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def idle_in_spans_share(run, prefix: str) -> Optional[float]:
    """The share of the stretch's idle device seconds that fall inside the
    program's spans whose names start with ``prefix``, in %; nothing for a
    short stretch."""
    p = run.profile
    if p is None or p.short:
        return None
    cs = calls(run)
    if cs is None:
        return None
    gaps = idle_gaps(p)
    idle = sum(b - a for a, b in gaps)
    if idle <= 0:
        return None
    inside = busy_intervals([s for c in cs for s in c.spans
                             if s[0].startswith(prefix)])
    return 100.0 * overlap_s(gaps, inside) / idle
