"""What a run is made of, found by name.

``BENCHMARK.json`` at the checkout's root names the cells, their
configuration and traffic, and the metrics. Everything that belongs to
one configuration, one traffic mix, one per-layer metric or one kernel is
a file of its own under ``perfbench/``, found by the name it has there:

  configs/<config>.json    the deployment: its system (``"system"``),
                           dataset, scale, index knobs, guarantees
  traffic/<mix>.json       its loop (``"loop"``) and the loop's parameters
  systems/<system>.py      ``build(cfg, keys, vals, device, rec)``: the
                           system under test as the configuration deploys
                           it, with ``wave(reads, ins, ins_vals) -> (found,
                           vals)``, ``contents() -> (keys, vals)`` and
                           ``close()``; it opens the harness's spans
                           (``rec.span``) around each call into a layer,
                           and declares ``PROGRAM_SPANS``: the program's
                           top span inside each harness span (none: the
                           program's spans are not read)
  loops/<loop>.py          ``Run(cell, seed, device, rec, dev, factory)``:
                           set-up from the seed, the system built by
                           ``factory(cfg, keys, vals, device, rec)``, the
                           warm-up; then ``window(seconds, stretch,
                           profile_s, trace)``, ``extra_stretch(stretch,
                           profile_s)``, ``probe(kmods, out)``,
                           ``metrics(w)`` (the end-to-end metrics of the
                           window ``w``), ``check(keys, vals)`` (the
                           numbers compared, and ``bytes_per_key``), and
                           the attributes ``system`` and ``examples``
  metrics/<metric>.py      ``read(run)``: the metric from the traced run,
                           or None where it finds nothing to read
  kernels/<kernel>.py      ``bytes_of(args, kwargs)``: a launch's bytes
  tests/cases/<metric>.json  the reader's test case: ``{"trace": <trace>,
                           "value": <number or null>, "why": <one line>}``
  tests/traces/<trace>.py  ``record()``: a ``cell.RunRecord``, and
                           ``play()``: the program's spans of that run,
                           recorded into ``repro_torch.tracing`` through
                           its API

A later cell, mix, metric, kernel, system or loop is one more file and one
more entry; a metric also brings its case (and a trace, where no trace
there holds what it reads). A cell whose system or loop has no file fails
by name, before any card is touched, and a reader with no case fails the
readers' test by name.
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
    bench_dir: Path = BENCH_DIR     # where its system and loop are found


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
    """A cell from its configuration file and its traffic mix's name; its
    system's and its loop's files have to be there."""
    config = _json(Path(config_file))
    mix = _json(bench_dir / "traffic" / f"{traffic}.json")
    _part("systems", config["system"], bench_dir)
    _part("loops", mix["loop"], bench_dir)
    return Cell(
        name=name,
        config=config,
        traffic=mix,
        chips=chips,
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)],
        bench_dir=bench_dir,
    )


#: each file loaded by ``_module``, by its path: a loop that subclasses
#: another, and a test that sets a loop's constant, see the module the
#: run uses
_LOADED: Dict[Path, object] = {}


def _module(path: Path, prefix: str):
    path = path.resolve()
    if path in _LOADED:
        return _LOADED[path]
    mod_name = prefix + "_" + "".join(
        c if c.isalnum() else "_" for c in path.stem)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise SpecError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _LOADED[path] = mod
    return mod


def _part(kind: str, name: str, bench_dir: Path) -> Path:
    path = bench_dir / kind / f"{name}.py"
    if not path.is_file():
        raise SpecError(f"{path} is missing: no {kind[:-1]} {name!r}")
    return path


def system(name: str, bench_dir: Path = BENCH_DIR):
    """``systems/<name>.py``, whose ``build`` makes the system under test."""
    return _module(_part("systems", name, bench_dir), "perfbench_system")


def loop(name: str, bench_dir: Path = BENCH_DIR):
    """``loops/<name>.py``, whose ``Run`` drives one run of a cell."""
    return _module(_part("loops", name, bench_dir), "perfbench_loop")


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
