"""The benchmark is driven by data: a cell, a mix or a metric added as a
file (and an entry) runs with no edit to a file that is there; and the
benchmark's files keep to their contract."""
import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import perfbench_testlib  # noqa: F401 — the import paths

from perfharness import spec

ROOT = perfbench_testlib.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.fixture()
def copy(tmp_path):
    """A checkout of just the benchmark: BENCHMARK.json and perfbench/."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def test_a_cell_mix_and_metric_added_as_files(copy):
    bench_dir = copy / "perfbench"
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    (bench_dir / "traffic" / "write_heavy.json").write_text(json.dumps(
        {"loop": "waves", "write_rate": 0.5, "warmup_waves": 2}))
    (bench_dir / "metrics" / "index.insert_ms_p99.py").write_text(
        "from perfharness.readers import span_pct\n\n\n"
        "def read(run):\n    return span_pct(run, 'index.insert', 99)\n")
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": "uplif-wikits-16m.write_heavy", "config": "uplif-wikits-16m",
        "traffic": "write_heavy", "chips": 1, "why": "50% writes"})
    # a cell whose rate is steady adds the rate end to end, as an entry
    bench["end_to_end"].append({
        "name": "ops_per_s", "unit": "ops/s", "better": "higher",
        "bound": 0.25, "source": "host_clock",
        "workloads": ["uplif-wikits-16m.write_heavy"]})
    bench["per_layer"].append({
        "name": "index.insert_ms_p99", "unit": "ms", "better": "lower",
        "source": "program_span", "layer": "index shell and op suite",
        "moves": "ops_per_s", "workloads": ["uplif-wikits-16m.write_heavy"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    for p, data in before.items():
        assert p.read_bytes() == data          # nothing there was edited
    c = spec.find_cell("uplif-wikits-16m.write_heavy", root=copy,
                       bench_dir=bench_dir)
    assert c.traffic["write_rate"] == 0.5
    assert c.config["dataset"] == "wikits"
    assert "index.insert_ms_p99" in [m["name"] for m in c.per_layer]
    read = spec.metric_reader("index.insert_ms_p99", bench_dir=bench_dir)

    class Run:
        spans = {"index.insert": [0.001] * 99 + [0.1]}

    assert read(Run()) == pytest.approx(1.99)
    # the added cell runs on the CPU at a test's size
    c.config = spec.override(c.config, perfbench_testlib.SMALL)
    perfbench_testlib.small_waves(bench_dir)
    from perfharness import cell
    out = cell.run_cell(c, 21, 0.5, False, device="cpu")
    assert out["correct"] and out["metrics"]["ops_per_s"]["value"] > 0


def _add_cell(copy, system="uplif", loop="waves"):
    """A configuration naming ``system``, a mix naming ``loop`` and a cell
    of the two, added to ``copy`` as files and entries; returns the cell's
    name."""
    bench_dir = copy / "perfbench"
    cfg = json.loads((bench_dir / "configs" / "uplif-wikits-16m.json")
                     .read_text())
    cfg["name"], cfg["system"] = f"{system}-wikits", system
    (bench_dir / "configs" / f"{system}-wikits.json").write_text(
        json.dumps(cfg))
    mix = json.loads((bench_dir / "traffic" / "read_heavy.json").read_text())
    mix["loop"] = loop
    (bench_dir / "traffic" / f"{loop}_mix.json").write_text(json.dumps(mix))
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": f"{system}-wikits", "source": "a test",
        "file": f"perfbench/configs/{system}-wikits.json", "reduced": [],
        "why": "a test"})
    name = f"{system}-wikits.{loop}_mix"
    bench["workloads"].append({
        "name": name, "config": f"{system}-wikits",
        "traffic": f"{loop}_mix", "chips": 1, "why": "a test"})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    return name


SPANNED_SYSTEM = """from pathlib import Path

from perfharness import spec


def build(cfg, keys, vals, device, rec):
    with rec.span("system.build"):
        return spec.system("uplif", Path(__file__).resolve().parents[1]) \
            .build(cfg, keys, vals, device, rec)
"""

SPANNED_LOOP = """from pathlib import Path

from perfharness import spec

_waves = spec.loop("waves", Path(__file__).resolve().parents[1])


class Run(_waves.Run):
    def window(self, *args, **kwargs):
        with self.rec.span("loop.window"):
            return super().window(*args, **kwargs)
"""


def test_a_system_loop_and_cell_added_as_files(copy):
    """A deployment whose system and loop are new runs through ``run_cell``
    with every file that was there unchanged."""
    bench_dir = copy / "perfbench"
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    (bench_dir / "systems" / "uplif_spanned.py").write_text(SPANNED_SYSTEM)
    (bench_dir / "loops" / "waves_spanned.py").write_text(SPANNED_LOOP)
    name = _add_cell(copy, "uplif_spanned", "waves_spanned")
    for p, data in before.items():
        assert p.read_bytes() == data          # nothing there was edited
    c = spec.find_cell(name, root=copy, bench_dir=bench_dir)
    assert c.bench_dir == bench_dir
    c.config = spec.override(c.config, perfbench_testlib.SMALL)
    perfbench_testlib.small_waves(bench_dir)
    from perfharness import cell
    out = cell.run_cell(c, 22, 0.5, True, device="cpu")
    assert out["correct"], out["check"]
    spans = out["_record"].spans
    assert len(spans["system.build"]) == 1 and len(spans["loop.window"]) == 1
    assert spans["index.lookup"] and spans["index.insert"]


RELAY_SYSTEM = """import threading
from pathlib import Path

from perfharness import spec
from repro_torch import tracing

PROGRAM_SPANS = {"relay.serve": "relay.wave"}


def _side():
    with tracing.span("relay.side"):
        tracing.count("relay.side_waves")


class Relay:
    def __init__(self, inner, rec):
        self.inner, self.rec = inner, rec

    def wave(self, reads, ins, ins_vals):
        with self.rec.span("relay.wave", sync=True):
            with tracing.span("relay.serve"):
                with tracing.span("relay.route"):
                    tracing.count("relay.ops", len(reads) + len(ins))
                side = threading.Thread(target=_side)
                side.start()
                side.join()
                return self.inner.wave(reads, ins, ins_vals)

    def contents(self):
        return self.inner.contents()

    def close(self):
        self.inner.close()


def build(cfg, keys, vals, device, rec):
    uplif = spec.system("uplif", Path(__file__).resolve().parents[1])
    return Relay(uplif.build(cfg, keys, vals, device, rec), rec)
"""

RELAY_READERS = {
    "relay.route_ms_p50": """from perfharness.program import span_ms_p50


def read(run):
    return span_ms_p50(run, "relay.route")
""",
    "relay.side_per_wave": """from perfharness.program import top_spans


def read(run):
    side = top_spans(run, ["relay.side"])
    if side is None or not run.profile.waves:
        return None
    n = sum(c.counts.get("relay.side_waves", 0) for c in side)
    return n / run.profile.waves
""",
}

RELAY_TRACE = """import threading

from perfharness import cell, spec, trace
from repro_torch import tracing

# the tracer's clock, read as each span opens and closes: two waves, each
# routed (3 ms, then 5 ms) and with a span on a second thread
TICKS = [0.0, 0.001, 0.004, 0.010, 0.012, 0.040,
         5.0, 5.001, 5.006, 5.010, 5.012, 5.040]


def record():
    p = trace.Profile(window_s=10.0, waves=2, device=[],
                      spans=[("relay.wave", 0.0, 0.04),
                             ("relay.wave", 5.0, 5.04)],
                      launched={}, short=True, tries=1)
    return cell.RunRecord(window_s=10.0, waves=2, spans={}, profile=p,
                          kernel_bytes={},
                          program_spans=spec.system("relay").PROGRAM_SPANS)


def _side():
    with tracing.span("relay.side"):
        tracing.count("relay.side_waves")


def play():
    clock = iter(int(t * 1e9) for t in TICKS)
    saved, tracing._clock = tracing._clock, clock.__next__
    tracing.enable()
    try:
        for _ in range(2):
            with tracing.span("relay.serve"):
                with tracing.span("relay.route"):
                    tracing.count("relay.ops", 256)
                side = threading.Thread(target=_side)
                side.start()
                side.join()
    finally:
        tracing.disable()
        tracing._clock = saved
"""

RELAY_CASES = {"relay.route_ms_p50": 4.0, "relay.side_per_wave": 1.0}
RELAY_TEST = "test_a_system_with_its_own_program_spans_added_as_files"


def _copy_tests(copy, *args):
    """The copy's own tests, run from the copy in a process of its own,
    the port on its path."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return subprocess.run(
        [sys.executable, "-m", "pytest", "-v", "-p", "no:cacheprovider",
         "--confcutdir", str(copy), *args], cwd=copy / "perfbench", env=env,
        capture_output=True, text=True, timeout=300)


def test_a_system_with_its_own_program_spans_added_as_files(copy):
    """A system whose program opens top spans of its own names, and a span
    on a second thread each wave, is read by two new readers, each with
    its case and trace: files added, every file that was there unchanged,
    and the copy's tests all pass."""
    bench_dir = copy / "perfbench"
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    (bench_dir / "systems" / "relay.py").write_text(RELAY_SYSTEM)
    (bench_dir / "tests" / "traces" / "relay_waves.py").write_text(
        RELAY_TRACE)
    name = _add_cell(copy, "relay")
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    for metric, value in RELAY_CASES.items():
        (bench_dir / "metrics" / f"{metric}.py").write_text(
            RELAY_READERS[metric])
        (bench_dir / "tests" / "cases" / f"{metric}.json").write_text(
            json.dumps({"trace": "relay_waves", "value": value,
                        "why": "two waves"}))
        bench["per_layer"].append({
            "name": metric, "unit": "ms" if metric.endswith("_ms_p50")
            else "1/wave", "better": "lower", "source": "program_span",
            "layer": "relay", "moves": "bytes_per_key", "workloads": [name]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    for p, data in before.items():
        assert p.read_bytes() == data          # nothing there was edited
    # every test of the copy but this one, which would copy it again; the
    # port beside it, as in a checkout
    (copy / "src").symlink_to(ROOT / "src")
    p = _copy_tests(copy, "tests", "--deselect",
                    f"tests/test_perfbench_spec.py::{RELAY_TEST}")
    assert p.returncode == 0, p.stdout[-3000:]
    for metric in RELAY_CASES:
        for test in ("test_perfbench_readers.py::test_reader_on_a_full_trace",
                     "test_perfbench_program.py::"
                     "test_a_system_without_program_spans_reads_as_nothing"):
            assert f"{test}[{metric}] PASSED" in p.stdout
    # a traced run of the cell on the CPU, at a test's size
    c = spec.find_cell(name, root=copy, bench_dir=bench_dir)
    c.config = spec.override(c.config, perfbench_testlib.SMALL)
    perfbench_testlib.small_waves(bench_dir)
    from perfharness import cell
    out = cell.run_cell(c, 23, 1.0, True, device="cpu")
    assert out["correct"], out["check"]
    metrics = {k: v["value"] for k, v in out["metrics"].items()}
    # each route lies inside its wave's harness span
    profile = out["_record"].profile
    assert profile.waves > 0
    longest = max(b - a for n, a, b in profile.spans if n == "relay.wave")
    assert 0 < metrics["relay.route_ms_p50"] <= 1e3 * longest
    assert metrics["relay.side_per_wave"] == 1.0


def test_a_reader_without_its_case_fails_by_path(copy):
    bench_dir = copy / "perfbench"
    (bench_dir / "metrics" / "index.insert_ms_p99.py").write_text(
        "from perfharness.readers import span_pct\n\n\n"
        "def read(run):\n    return span_pct(run, 'index.insert', 99)\n")
    p = _copy_tests(copy, "tests/test_perfbench_readers.py", "-k",
                    "full_trace and insert_ms_p99")
    missing = bench_dir / "tests" / "cases" / "index.insert_ms_p99.json"
    assert p.returncode == 1, p.stdout[-3000:]
    assert "1 failed" in p.stdout and f"{missing} is missing" in p.stdout


@pytest.mark.parametrize("kind", ["systems", "loops"])
def test_a_cell_without_its_system_or_loop_fails_by_name(copy, kind):
    """``find_cell`` names the missing file, and ``run.py`` exits 2 with
    it before it looks for a card."""
    name = _add_cell(copy, **{kind[:-1]: "no_such"})
    missing = copy / "perfbench" / kind / "no_such.py"
    with pytest.raises(spec.SpecError, match=re.escape(str(missing))):
        spec.find_cell(name, root=copy, bench_dir=copy / "perfbench")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    p = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", name, "--seed",
         "1", "--seconds", "1", "--trace", "0"], cwd=copy, env=env,
        capture_output=True, text=True, timeout=120)
    assert p.returncode == 2 and p.stdout.strip() == ""
    assert str(missing) in p.stderr


def test_unknown_names_fail_plainly(copy):
    with pytest.raises(spec.SpecError, match="no cell"):
        spec.find_cell("nothing.here", root=copy, bench_dir=copy / "perfbench")
    with pytest.raises(spec.SpecError, match="no reader"):
        spec.metric_reader("no.such_metric", bench_dir=copy / "perfbench")
    (copy / "BENCHMARK.json").unlink()
    with pytest.raises(spec.SpecError, match="missing"):
        spec.find_cell("uplif-wikits-16m.read_only", root=copy)


def test_benchmark_json_keeps_its_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        f = json.loads((ROOT / c["file"]).read_text())
        for k in c["reduced"]:
            assert NAME.match(k) and k in f and k in f["published"]
            assert not k.endswith(("_dim", "_rank"))
        for k in ("source", "reduced", "assumed", "guarantees"):
            assert k in f
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").is_file()
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in [m["name"] for m in BENCH["end_to_end"]]
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert m["better"] in ("lower", "higher")
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
    for x in BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] \
            + BENCH["per_layer"]:
        assert NAME.match(x["name"]) and x["name"] not in names
        names.add(x["name"])
    # every cell reports setup_s, another end-to-end metric and a per-layer
    for w in BENCH["workloads"]:
        c = spec.find_cell(w["name"])
        assert len(c.end_to_end) >= 2 and c.per_layer
        for m in c.per_layer:
            assert m["moves"] in [e["name"] for e in c.end_to_end]
    assert len(json.dumps(BENCH)) < 64 * 1024
