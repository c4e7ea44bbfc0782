"""``perfharness/program.py``: the program's spans paired with the harness's
and moved onto a profiled stretch's clock, on synthetic data."""
import sys

import pytest
import perfbench_testlib  # noqa: F401 — the import paths

from perfharness import cell, program, spec, trace


def _snap(calls):
    """A tracer snapshot of calls ``(top, start_s, end_s, children)``, each
    child ``(name, start_s, end_s, counts)`` with times on the program's
    clock."""
    spans = []
    for top, a, b, children in calls:
        i = len(spans)
        spans.append((top, -1, int(a * 1e9), int(b * 1e9), {}))
        for name, ca, cb, counts in children:
            spans.append((name, i, int(ca * 1e9), int(cb * 1e9), counts))
    return {"spans": spans, "counts": {}, "dropped": 0}


def _lookup(t, dispatch=(0.002, 0.012)):
    return ("uplif.lookup", t, t + 0.018, [
        ("uplif.h2d", t, t + 0.001, {"host_syncs": 1}),
        ("fops.lookup", t + dispatch[0], t + dispatch[1], {}),
        ("uplif.d2h", t + 0.013, t + 0.017, {"host_syncs": 2}),
    ])


def _run(spans, device=(), short=False):
    p = trace.Profile(window_s=0.1, waves=len(spans), device=list(device),
                      spans=spans, launched={}, short=short, tries=1)
    return cell.RunRecord(window_s=10.0, waves=4, spans={}, profile=p,
                          kernel_bytes={})


HARNESS = [("index.lookup", 0.010, 0.030), ("gen", 0.030, 0.040),
           ("index.lookup", 0.060, 0.080)]


def test_the_matching_takes_only_the_final_stretchs_records():
    """An earlier stretch's calls stay in the tracer: the last top spans
    are the final stretch's."""
    older = ("uplif.insert", 5.0, 5.02, [
        ("fops.insert.place", 5.001, 5.01, {"host_syncs": 9})])
    snap = _snap([older, _lookup(7.0), _lookup(7.5)])
    cs = program.calls(_run(HARNESS), snap)
    assert [c.name for c in cs] == ["uplif.lookup", "uplif.lookup"]
    assert [c.counts for c in cs] == [{"host_syncs": 3}] * 2
    assert cs[0].durations["fops.lookup"] == pytest.approx([0.010])


def test_the_mapping_keeps_each_program_span_inside_its_harness_span():
    # the second call runs longer than its harness span: clipped to it
    snap = _snap([_lookup(7.0), ("uplif.lookup", 7.5, 7.53, [
        ("fops.lookup", 7.51, 7.529, {})])])
    cs = program.calls(_run(HARNESS), snap)
    for c, (_, a, b) in zip(cs, [HARNESS[0], HARNESS[2]]):
        assert all(a <= s0 <= s1 <= b for _, s0, s1 in c.spans)
    top, h2d, fl, d2h = cs[0].spans
    assert top[1:] == pytest.approx((0.010, 0.028))
    assert fl[1:] == pytest.approx((0.012, 0.022))
    assert cs[1].spans[1][1:] == pytest.approx((0.070, 0.080))


@pytest.mark.parametrize("a,b,want", [
    ([(0, 1), (2, 3)], [(0.5, 2.5)], 1.0),
    ([(0, 10)], [(1, 2), (3, 4), (9, 12)], 3.0),
    ([(0, 1)], [(1, 2)], 0.0),
    ([], [(0, 1)], 0.0),
])
def test_overlap_of_interval_lists(a, b, want):
    assert program.overlap_s(a, b) == pytest.approx(want)
    assert program.overlap_s(b, a) == pytest.approx(want)


def test_the_idle_seconds_inside_dispatch_spans_are_summed(monkeypatch):
    device = [("k", 0.013, 0.015), ("k", 0.020, 0.026), ("k", 0.065, 0.070)]
    snap = _snap([_lookup(7.0), _lookup(7.5)])
    # dispatch spans 0.012-0.022 and 0.062-0.072 on the profile's clock;
    # idle inside them: 1 + 5 ms, 3 + 2 ms; idle in all: 0.1 - 0.013 s
    monkeypatch.setattr(program, "_snapshot", lambda: snap)
    run = _run(HARNESS, device)
    assert program.idle_in_spans_share(run, "fops.") == pytest.approx(
        100 * 0.011 / 0.087)
    short = _run(HARNESS, device, short=True)
    assert program.idle_in_spans_share(short, "fops.") is None


@pytest.mark.parametrize("case", ["fewer", "names", "open", "none",
                                  "empty"])
def test_a_mismatch_reads_as_nothing(case, monkeypatch):
    snap = _snap([_lookup(7.0), _lookup(7.5)])
    run = _run(HARNESS)
    if case == "fewer":
        run = _run(HARNESS + [("index.lookup", 0.085, 0.095)])
    elif case == "names":
        run = _run([("index.insert", 0.010, 0.030), HARNESS[2]])
    elif case == "open":
        s = snap["spans"][-1]
        snap["spans"][-1] = s[:3] + (None,) + s[4:]
    elif case == "none":
        run = cell.RunRecord(window_s=1.0, waves=0, spans={}, profile=None,
                             kernel_bytes={})
    else:
        snap = {"spans": [], "counts": {}, "dropped": 0}
    monkeypatch.setattr(program, "_snapshot", lambda: snap)
    assert program.calls(run) is None
    assert program.total(run, "host_syncs") is None
    assert program.span_ms_p50(run, "fops.lookup") is None


def test_a_program_without_the_tracer_reads_as_nothing(monkeypatch):
    """The parent of the change that brought the tracer has no
    ``repro_torch.tracing``: the readers give nothing and raise nothing."""
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert program._snapshot() is None
    assert program.total(_run(HARNESS), "host_syncs") is None


HEAVY_EXPECTED = {
    "index.insert_place_ms_p50": 11.0,      # 10 and 12 ms
    "index.insert_merge_ms_p50": 5.0,       # 4 and 6 ms
    "index.overflow_share": 20.0,           # 160 of 800 keys
    "index.syncs_per_wave": 7.0,            # 3 a lookup, 4 an insert
}


@pytest.mark.parametrize("name", sorted(HEAVY_EXPECTED))
def test_program_readers_on_a_read_heavy_trace(name):
    """Two waves of a lookup and an insert, recorded by the tracer: the
    readers of BENCHMARK.json take the insert's spans and counts."""
    from program_trace import insert_call, lookup_call, play
    from repro_torch import tracing

    tracing.reset()
    try:
        play([lookup_call(1.0), insert_call(1.1, 0.010, 0.004, 400, 100),
              lookup_call(2.0), insert_call(2.1, 0.012, 0.006, 400, 60)])
        p = trace.Profile(
            window_s=0.1, waves=2, device=[("k", 0.010, 0.013)],
            spans=[("index.lookup", 0.0, 0.036), ("index.insert", 0.036, 0.05),
                   ("index.lookup", 0.05, 0.086), ("index.insert", 0.086, 0.1)],
            launched={}, short=False, tries=1)
        run = cell.RunRecord(window_s=10.0, waves=4, spans={}, profile=p,
                             kernel_bytes={})
        v = spec.metric_reader(name)(run)
    finally:
        tracing.reset()
    assert v == pytest.approx(HEAVY_EXPECTED[name], rel=1e-9)
