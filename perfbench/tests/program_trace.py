"""A synthetic program trace for the readers' tests: calls recorded into
``repro_torch.tracing`` through its own API, on a scripted clock."""
from __future__ import annotations

import perfbench_testlib  # noqa: F401 — the import paths

from repro_torch import tracing


def lookup_call(t):
    """A lookup at ``t`` s: dispatch 5-25 ms in, three host syncs."""
    return ("uplif.lookup", t, t + 0.035, [
        ("uplif.h2d", t, t + 0.002, {"host_syncs": 1}),
        ("fops.lookup", t + 0.005, t + 0.025, {}),
        ("uplif.d2h", t + 0.028, t + 0.034, {"host_syncs": 2}),
    ], {})


def insert_call(t, place_s, merge_s, keys, overflow):
    """An insert at ``t`` s of ``keys`` keys, ``overflow`` of them to the
    BMAT: four host syncs."""
    m = t + 0.003 + place_s
    return ("uplif.insert", t, m + merge_s + 0.002, [
        ("uplif.reservoir", t, t + 0.001, {}),
        ("uplif.h2d", t + 0.001, t + 0.002, {"host_syncs": 2}),
        ("bmat.reserve", t + 0.002, t + 0.003, {"host_syncs": 1}),
        ("fops.insert.place", t + 0.003, m, {}),
        ("fops.insert.merge", m, m + merge_s, {}),
        ("uplif.d2h", m + merge_s, m + merge_s + 0.001, {"host_syncs": 1}),
    ], {"insert.keys": keys, "insert.overflow": overflow})


def play(calls):
    """Record ``calls`` into the tracer: each ``(top, start_s, end_s,
    children, counts)``, each child ``(name, start_s, end_s, counts)``."""
    times = []
    for _, t0, t1, children, _ in calls:
        times += [t0] + [t for _, a, b, _ in children for t in (a, b)] + [t1]
    clock = iter(int(t * 1e9) for t in times)
    saved, tracing._clock = tracing._clock, clock.__next__
    tracing.enable()
    try:
        for top, _, _, children, counts in calls:
            with tracing.span(top):
                for name, _, _, cc in children:
                    with tracing.span(name):
                        for k, n in cc.items():
                            tracing.count(k, n)
                for k, n in counts.items():
                    tracing.count(k, n)
    finally:
        tracing.disable()
        tracing._clock = saved
