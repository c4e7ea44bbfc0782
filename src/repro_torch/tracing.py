"""Spans and counters of the index's host path.

The index shell and its op suite mark where a call spends its host time
(``span``) and count what happens there (``count``): the host's waits for
the card (``host_syncs``), the keys an insert was given and those it sent
to the BMAT. Nothing here touches a tensor: the tracer holds no device
memory, makes no device read and adds no event to a profiler's timeline
(no ``record_function``), so a profile of the card reads the same with it.

Operator API:

* ``enable()`` / ``disable()`` — record or not, whatever else runs;
* ``reset()`` — drop what was recorded (call it with no span open);
* ``snapshot()`` — what was recorded, as plain Python data (below).

The tracer is **on** while ``enable()`` holds or a torch profiler runs
(read on every call), so a profiled stretch records its calls with no
other set-up. **Off**, ``span`` is one flag check that returns a shared
no-op context: it allocates nothing, reads no clock and records nothing;
``count`` is the same check.

On, a span records its name, its parent (the innermost span open on the
same thread when it opened) and its start and end on
``time.perf_counter_ns``. A count is added to the innermost open span of
its thread, so a reader can sum the counts under any set of top spans, and
to the totals. The buffer holds ``CAPACITY`` spans; past that, spans are
dropped and counted, never stored, and the counts made inside them reach
only the totals.

``snapshot()`` returns ``{"spans": [(name, parent, t0_ns, t1_ns, counts),
...], "counts": {name: total}, "dropped": n}``: spans in the order they
opened, ``parent`` the index of the parent span or -1 (none, or not held),
``t1_ns`` None for a span still open, ``counts`` a dict of the counts made
directly inside the span.
"""
from __future__ import annotations

import threading
import time

import torch.autograd.profiler as _autograd_profiler

#: spans held before the tracer drops them
CAPACITY = 1 << 18

_clock = time.perf_counter_ns
_enabled = False
_lock = threading.Lock()
_local = threading.local()
_spans: list = []
_totals: dict = {}
_dropped = 0


class _Off:
    """The context ``span`` returns while the tracer is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "parent", "t0", "t1", "counts")

    def __init__(self, name: str):
        self.name = name
        self.counts = None
        self.t0 = self.t1 = None

    def __enter__(self):
        global _dropped
        stack = _stack()
        self.parent = stack[-1] if stack else None
        with _lock:
            if len(_spans) < CAPACITY:
                _spans.append(self)
            else:
                _dropped += 1
        stack.append(self)
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        self.t1 = _clock()
        _stack().pop()
        return False


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


def span(name: str):
    """A context that records the host time of its body as ``name``."""
    if not (_enabled or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``, in the innermost open span."""
    if not (_enabled or _autograd_profiler._is_profiler_enabled):
        return
    stack = _stack()
    with _lock:
        _totals[name] = _totals.get(name, 0) + n
        if stack:
            top = stack[-1]
            if top.counts is None:
                top.counts = {}
            top.counts[name] = top.counts.get(name, 0) + n


def enable() -> None:
    """Record from now on, with or without a profiler."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Record only while a profiler runs."""
    global _enabled
    _enabled = False


def reset() -> None:
    """Drop every recorded span, count and drop count."""
    global _dropped
    with _lock:
        _spans.clear()
        _totals.clear()
        _dropped = 0


def snapshot() -> dict:
    """What was recorded (see the module's docstring)."""
    with _lock:
        spans = list(_spans)
        totals = dict(_totals)
        dropped = _dropped
        at = {id(s): i for i, s in enumerate(spans)}
        out = [(s.name, -1 if s.parent is None else at.get(id(s.parent), -1),
                s.t0, s.t1, dict(s.counts or {})) for s in spans]
    return {"spans": out, "counts": totals, "dropped": dropped}
