"""What a run is made of, found by name.

``BENCHMARK.json`` at the checkout's root names the cells, their
configuration and traffic, and the metrics. Everything that belongs to
one configuration, one traffic mix, one per-layer metric or one kernel is
a file of its own under ``perfbench/``, found by the name it has there:

  configs/<config>.json    the deployment: dataset, scale, index knobs,
                           guarantees
  traffic/<mix>.json       the loop (``waves``) and its parameters
  metrics/<metric>.py      ``read(run)``: the metric from the traced run,
                           or None where it finds nothing to read
  kernels/<kernel>.py      ``bytes_of(args, kwargs)``: a launch's bytes

A later cell, mix, metric or kernel is one more file and one more entry.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class SpecError(RuntimeError):
    """The benchmark's files do not describe the run asked for."""


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise SpecError(f"{path} is missing")
    return json.loads(path.read_text())


def _json(path: Path) -> dict:
    if not path.is_file():
        raise SpecError(f"{path} is missing")
    return json.loads(path.read_text())


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: Path = ROOT,
              bench_dir: Path = BENCH_DIR) -> Cell:
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SpecError(f"no cell {name!r} in BENCHMARK.json "
                        f"(cells: {', '.join(sorted(cells))})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise SpecError(f"cell {name!r} names an unknown config "
                        f"{w['config']!r}")
    return make_cell(name, root / configs[w["config"]]["file"],
                     w["traffic"], int(w["chips"]), bench, bench_dir)


def make_cell(name: str, config_file: Path, traffic: str, chips: int,
              bench: dict, bench_dir: Path = BENCH_DIR) -> Cell:
    """A cell from its configuration file and its traffic mix's name."""
    return Cell(
        name=name,
        config=_json(Path(config_file)),
        traffic=_json(bench_dir / "traffic" / f"{traffic}.json"),
        chips=chips,
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)],
    )


def _module(path: Path, prefix: str):
    mod_name = prefix + "_" + "".join(
        c if c.isalnum() else "_" for c in path.stem)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise SpecError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The ``read(run)`` of ``metrics/<name>.py``."""
    path = bench_dir / "metrics" / f"{name}.py"
    if not path.is_file():
        raise SpecError(f"no reader {path} for the metric {name!r}")
    return _module(path, "perfbench_metric").read


def kernel_modules(bench_dir: Path = BENCH_DIR) -> Dict[str, object]:
    """Every ``kernels/<kernel>.py``, by its ``NAME``."""
    out = {}
    for path in sorted((bench_dir / "kernels").glob("*.py")):
        if path.name.startswith("_"):
            continue
        mod = _module(path, "perfbench_kernel")
        out[mod.NAME] = mod
    return out


def kernel_module(name: str, bench_dir: Path = BENCH_DIR):
    mods = kernel_modules(bench_dir)
    if name not in mods:
        raise SpecError(f"no kernels/<file>.py with NAME {name!r}")
    return mods[name]


def override(cfg: dict, scale: Optional[dict]) -> dict:
    """A copy of ``cfg`` with the top-level keys of ``scale`` replaced
    (the CPU tests run the cells' code at a size a test can hold)."""
    out = json.loads(json.dumps(cfg))
    for k, v in (scale or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k].update(v)
        else:
            out[k] = v
    return out
