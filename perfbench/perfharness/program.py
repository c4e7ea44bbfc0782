"""The program's own spans and counters, on the clock of a profiled stretch.

The program records its spans and counts (``repro_torch.tracing``) while a
profiler runs, so the tracer holds them for every profiled stretch of a
traced run, and adds nothing to the profile itself. Inside each harness
span around a call into the system, the program opens one top span. The
system under test declares which (``PROGRAM_SPANS`` in
``systems/<system>.py``: each program top span, the harness span around
it), and the run carries that map (``run.program_spans``).

``calls`` pairs the harness spans of the final stretch
(``run.profile.spans``) one to one with the last top spans of the map
that the tracer recorded, and moves each call's spans onto the profile's
clock by the start of its harness span. ``top_spans`` gives the top spans
of other names that ran while the final stretch did, such as those that
the program's worker threads open, where no harness span is around
them: it moves them by the offset of the stretch's first call. Where the
profile is missing, the system declares no map, the program recorded
nothing (a program without the tracer), or the two do not pair up, both
give None, and so does every reader built on them.

What ``top_spans`` can see: the tracer records a span only if it opened
while a profiler ran. A worker's span that opened while none did, such as
a build that straddles the start of the final stretch, is never recorded;
one that opened in an earlier profiled stretch of the run and runs into
the final one is read. Each span is cut to the stretch, and its
``durations`` are the seconds it ran inside it; a span still open when
the tracer is read runs to the stretch's end.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from perfharness.trace import busy_intervals, idle_gaps


@dataclasses.dataclass
class Call:
    """One top span of the program, as it recorded it."""

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


def _members(spans, tops) -> Dict[int, List[int]]:
    """Every span under each of the top spans ``tops`` (a parent opens
    before its children)."""
    root = []
    for i, s in enumerate(spans):
        root.append(i if s[1] < 0 else root[s[1]])
    members: Dict[int, List[int]] = {i: [] for i in tops}
    for i, r in enumerate(root):
        if r in members:
            members[r].append(i)
    return members


def _call(spans, top: int, members: List[int], offset: float, lo: float,
          hi: float, within: bool = False) -> Optional[Call]:
    """The top span ``top`` with its ``members``, moved onto the profile's
    clock by ``offset`` and clipped to ``[lo, hi]``. Its ``durations`` are
    as the tracer recorded them; None where one of them is still open.
    ``within``: the durations are the clipped seconds, and a span still
    open ends at ``hi``."""
    if not within and any(spans[j][3] is None for j in members):
        return None
    call = Call(name=spans[top][0], spans=[], durations={}, counts={})
    for j in members:
        name, _, t0, t1, counts = spans[j]
        a = min(max(1e-9 * t0 + offset, lo), hi)
        b = hi if t1 is None else min(max(1e-9 * t1 + offset, lo), hi)
        call.spans.append((name, a, b))
        call.durations.setdefault(name, []).append(
            b - a if within else 1e-9 * (t1 - t0))
        for k, n in counts.items():
            call.counts[k] = call.counts.get(k, 0) + n
    return call


def _paired(run, snap: Optional[dict]):
    """(the tracer's spans, the offset of the final stretch's first call,
    its calls), or None (see the module)."""
    p = run.profile
    pairs = run.program_spans
    if p is None or not pairs:
        return None
    snap = _snapshot() if snap is None else snap
    if not snap or not snap["spans"]:
        return None
    harness = sorted((s for s in p.spans if s[0] in pairs.values()),
                     key=lambda s: s[1])
    spans = snap["spans"]
    tops = [i for i, s in enumerate(spans) if s[1] < 0 and s[0] in pairs]
    if not harness or len(tops) < len(harness):
        return None
    tops = tops[-len(harness):]
    if any(pairs[spans[i][0]] != h[0] for i, h in zip(tops, harness)):
        return None
    members = _members(spans, tops)
    out = []
    for i, (_, a, b) in zip(tops, harness):
        call = _call(spans, i, members[i], a - 1e-9 * spans[i][2], a, b)
        if call is None:
            return None
        out.append(call)
    return spans, harness[0][1] - 1e-9 * spans[tops[0]][2], out


def calls(run, snap: Optional[dict] = None) -> Optional[List[Call]]:
    """The final stretch's calls, in order, or None (see the module)."""
    paired = _paired(run, snap)
    return None if paired is None else paired[2]


def top_spans(run, names: Iterable[str],
              snap: Optional[dict] = None) -> Optional[List[Call]]:
    """The top spans named in ``names`` that the tracer recorded on any
    thread while the final stretch ran, in the order they opened, each
    with its spans clipped to the stretch and its durations the seconds
    inside it (see the module); None where ``calls`` gives None."""
    paired = _paired(run, snap)
    if paired is None:
        return None
    spans, offset, _ = paired
    names = set(names)
    end = run.profile.window_s
    tops = [i for i, s in enumerate(spans) if s[1] < 0 and s[0] in names
            and 1e-9 * s[2] + offset < end
            and (s[3] is None or 1e-9 * s[3] + offset > 0)]
    members = _members(spans, tops)
    return [_call(spans, i, members[i], offset, 0.0, end, within=True)
            for i in tops]


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
