"""What the benchmark's CPU tests share: the import paths, and a cell cut
to a size that a test can hold, run on the CPU."""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
for _p in (str(ROOT / "src"), str(BENCH_DIR)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from perfharness import spec  # noqa: E402

SMALL = {"keys": 40_000, "init_keys": 20_000, "batch": 256}


def small_waves(bench_dir: Path = BENCH_DIR):
    """A test's window holds a few waves: the waves loop under
    ``bench_dir`` reads bytes_per_key after the fourth."""
    spec.loop("waves", bench_dir).MEMORY_WAVE = 4


small_waves()
SEED = 3_000_000_019          # above 2**31, as a run's seed may be


def load_trace(name: str):
    """``tests/traces/<name>.py``: the run a reader's case reads,
    ``record()``, and its program's spans, ``play()``."""
    path = BENCH_DIR / "tests" / "traces" / f"{name}.py"
    if not path.is_file():
        raise spec.SpecError(f"{path} is missing: no trace {name!r}")
    return spec._module(path, "perfbench_trace")


def reader_case(name: str) -> dict:
    """``tests/cases/<name>.json``, the case of the reader
    ``metrics/<name>.py``; the test fails naming the path where it is
    missing."""
    path = BENCH_DIR / "tests" / "cases" / f"{name}.json"
    if not path.is_file():
        pytest.fail(f"{path} is missing: the case of the reader "
                    f"metrics/{name}.py")
    return json.loads(path.read_text())


def cell(name: str):
    """A cell of BENCHMARK.json, or ``<config>.<traffic>`` made from the
    files under ``perfbench/`` (a deployment with no cell yet)."""
    bench = spec.load_benchmark()
    if name in [w["name"] for w in bench["workloads"]]:
        return spec.find_cell(name)
    config, traffic = name.rsplit(".", 1)
    return spec.make_cell(name, BENCH_DIR / "configs" / f"{config}.json",
                          traffic, 1, bench)


def small_cell(name: str, locate: str = None):
    """The cell ``name`` at a test's size (widths and mix unchanged)."""
    c = cell(name)
    scale = dict(SMALL)
    if locate is not None:
        scale["index"] = {"locate": locate}
    c.config = spec.override(c.config, scale)
    return c


def run_small(name: str, seconds: float = 1.0, trace: bool = False,
              factory=None, seed: int = SEED, locate: str = None):
    from perfharness import cell

    return cell.run_cell(small_cell(name, locate), seed, seconds, trace,
                         device="cpu", factory=factory,
                         t_process=time.perf_counter())
