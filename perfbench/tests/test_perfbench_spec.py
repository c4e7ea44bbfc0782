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
    for m in bench["end_to_end"]:
        if m["name"] == "ops_per_s":
            m["workloads"].append("uplif-wikits-16m.write_heavy")
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
