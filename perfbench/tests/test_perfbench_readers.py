"""Each per-layer metric's reader over a synthetic traced run.

The readers built on ``perfharness/program.py`` also read the program's
tracer (``repro_torch.tracing``): for each test, ``_program_trace``
records into it the program's spans of the run's two lookup waves, after
an insert of an earlier stretch, and empties it afterwards. The
read-heavy case is in ``test_perfbench_program.py``.
"""
import json

import pytest
import perfbench_testlib  # noqa: F401 — the import paths
from program_trace import insert_call, lookup_call, play

from perfharness import cell, spec, trace
from repro_torch import tracing

BENCH = json.loads((perfbench_testlib.ROOT / "BENCHMARK.json").read_text())
# every reader under perfbench/metrics/, those of BENCHMARK.json among them
PER_LAYER = sorted(p.stem for p in
                   (perfbench_testlib.BENCH_DIR / "metrics").glob("*.py"))


def _profile(short=False, device=None):
    dev = device if device is not None else [
        ("fused_locate_kernel(long const*)", 0.010, 0.013),
        ("bmat_rank_kernel(long const*)", 0.020, 0.022),
        ("Memcpy DtoH (Device -> Pageable)", 0.030, 0.031),
        ("fused_locate_kernel(long const*)", 0.050, 0.054),
        ("bmat_rank_kernel(long const*)", 0.060, 0.063),
    ]
    return trace.Profile(
        window_s=0.1, waves=2, device=dev,
        spans=[("index.lookup", 0.0, 0.04), ("gen", 0.04, 0.05),
               ("index.lookup", 0.05, 0.09)],
        launched={"fused_locate": 2, "bmat_rank": 2}, short=short, tries=1)


def _record(profile):
    return cell.RunRecord(
        window_s=10.0, waves=4,
        spans={"index.lookup": [0.001, 0.002, 0.003],
               "index.insert": [0.010, 0.012, 0.011]},
        profile=profile,
        kernel_bytes={"k1": [335_000, 335_000], "k2": [67_000]},
        ops=16_384,
    )


EXPECTED = {
    "index.lookup_ms_p50": 2.0,
    "index.insert_ms_p50": 11.0,
    "device.ops_per_wave": 2.0,       # 4 kernels (the copy is not one)
    "device.idle_share": 87.0,        # 13 ms busy of 100
    "k1_roofline": 100 * (335_000 / 3.35e12) / 0.0035,
    "k2_roofline": 100 * (67_000 / 3.35e12) / 0.0025,
    # two lookups, three host syncs each
    "index.syncs_per_wave": 3.0,
    # idle inside the dispatch spans: 5 + 7 + 3 ms, 5 + 12 ms, of 87 ms
    "device.idle_in_dispatch_share": 100 * 0.032 / 0.087,
    # the stretch held no insert (the earlier stretch's is not read)
    "index.insert_place_ms_p50": None,
    "index.insert_merge_ms_p50": None,
    "index.overflow_share": None,
    "ops_per_s.read_only": 1638.4,   # 16,384 operations in 10 s
}


@pytest.fixture(autouse=True)
def _program_trace():
    tracing.reset()
    play([insert_call(0.5, 0.010, 0.004, 400, 100), lookup_call(1.0),
          lookup_call(2.0)])
    yield
    tracing.reset()


def test_every_metric_of_the_benchmark_has_a_reader():
    assert {m["name"] for m in BENCH["per_layer"]} <= set(PER_LAYER)


@pytest.mark.parametrize("name", PER_LAYER)
def test_reader_on_a_full_trace(name):
    v = spec.metric_reader(name)(_record(_profile()))
    assert v == pytest.approx(EXPECTED[name], rel=1e-9)


DEVICE = [m for m in PER_LAYER if m.startswith("device.")
          or m.endswith("_roofline")]


@pytest.mark.parametrize("name", DEVICE)
def test_a_short_trace_reads_as_nothing(name):
    """The profiler dropped events: no number, never 0."""
    read = spec.metric_reader(name)
    assert read(_record(_profile(short=True))) is None
    assert read(_record(None)) is None


@pytest.mark.parametrize("name", PER_LAYER)
def test_a_run_without_the_layer_reads_as_nothing(name):
    empty = cell.RunRecord(window_s=1.0, waves=0, spans={}, profile=None,
                           kernel_bytes={})
    assert spec.metric_reader(name)(empty) is None


def test_the_stretch_calls_a_dropped_launch_short():
    """A stretch is short when the profiler saw no device event, or under
    ``SEEN_SHARE`` of the launches the program counted of a kernel."""
    p = _profile()
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
    b = cell._breakdown(_profile())
    names = [n for n, _ in b["device_ops"]]
    assert names[0].startswith("fused_locate_kernel")
    labels = dict(b["idle_gaps"])
    assert set(labels) <= {"index.lookup", "gen", "other"}
    assert sum(labels.values()) == pytest.approx(0.087)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
