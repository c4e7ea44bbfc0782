"""Each per-layer metric's reader over a synthetic traced run.

Every reader ``metrics/<m>.py`` has its case, ``tests/cases/<m>.json``:
the trace it reads, ``tests/traces/<trace>.py`` (the run's record, and the
program's spans of that run, played into the program's tracer), and the
value it gives there. The read-heavy case of the program's readers is in
``test_perfbench_program.py``.
"""
import dataclasses
import json

import pytest
import perfbench_testlib

from perfharness import cell, spec, trace
from repro_torch import tracing

BENCH = json.loads((perfbench_testlib.ROOT / "BENCHMARK.json").read_text())
# every reader under perfbench/metrics/, those of BENCHMARK.json among them
PER_LAYER = sorted(p.stem for p in
                   (perfbench_testlib.BENCH_DIR / "metrics").glob("*.py"))
TWO_LOOKUPS = perfbench_testlib.load_trace("two_lookups")


@pytest.fixture(autouse=True)
def _program_trace_for_readers():
    """An empty tracer around each test. The name is that of the
    repository's root ``conftest.py`` fixture, which writes into an
    ``EXPECTED`` dict that this module no longer has: this one replaces it
    here until that file goes (PERF.md, Open questions)."""
    tracing.reset()
    yield
    tracing.reset()


def test_every_metric_of_the_benchmark_has_a_reader():
    assert {m["name"] for m in BENCH["per_layer"]} <= set(PER_LAYER)


@pytest.mark.parametrize("name", PER_LAYER)
def test_reader_on_a_full_trace(name):
    case = perfbench_testlib.reader_case(name)
    run = perfbench_testlib.load_trace(case["trace"])
    run.play()
    v = spec.metric_reader(name)(run.record())
    if case["value"] is None:
        assert v is None
    else:
        assert v == pytest.approx(case["value"], rel=1e-9)


DEVICE = [m for m in PER_LAYER if m.startswith("device.")
          or m.endswith("_roofline")]


@pytest.mark.parametrize("name", DEVICE)
def test_a_short_trace_reads_as_nothing(name):
    """The profiler dropped events: no number, never 0."""
    read = spec.metric_reader(name)
    TWO_LOOKUPS.play()
    short = TWO_LOOKUPS.record(short=True)
    assert read(short) is None
    assert read(dataclasses.replace(short, profile=None)) is None


@pytest.mark.parametrize("name", PER_LAYER)
def test_a_run_without_the_layer_reads_as_nothing(name):
    TWO_LOOKUPS.play()
    empty = cell.RunRecord(window_s=1.0, waves=0, spans={}, profile=None,
                           kernel_bytes={})
    assert spec.metric_reader(name)(empty) is None


def test_the_stretch_calls_a_dropped_launch_short():
    """A stretch is short when the profiler saw no device event, or under
    ``SEEN_SHARE`` of the launches the program counted of a kernel."""
    p = TWO_LOOKUPS.profile()
    assert trace.seen_kernels(p.device, p.launched) == {"fused_locate": 2,
                                                        "bmat_rank": 2}
    assert not trace.is_short(p.device, p.launched)
    assert trace.is_short([], {"fused_locate": 0})
    assert trace.is_short(p.device, {"fused_locate": 3, "bmat_rank": 2})
    many = [("fused_locate_kernel", i * 1e-3, i * 1e-3 + 1e-4)
            for i in range(99)]
    assert not trace.is_short(many, {"fused_locate": 100})    # 1% dropped
    assert trace.is_short(many[:90], {"fused_locate": 100})   # 10% dropped
    gaps = trace.idle_gaps(p)
    assert sum(b - a for a, b in gaps) == pytest.approx(0.087)
    assert trace.label_at(p.spans, 0.045) == "gen"


def test_breakdown_labels_idle_gaps_by_span():
    b = cell._breakdown(TWO_LOOKUPS.profile())
    names = [n for n, _ in b["device_ops"]]
    assert names[0].startswith("fused_locate_kernel")
    labels = dict(b["idle_gaps"])
    assert set(labels) <= {"index.lookup", "gen", "other"}
    assert sum(labels.values()) == pytest.approx(0.087)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
