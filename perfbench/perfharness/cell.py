"""One run of one cell: set-up, the measured window, the check, the line.

``run_cell`` is everything ``run.py`` does after it has found a card. The
CPU tests call it with ``device="cpu"`` at a small scale, and with the
program's timed path broken underneath, to see ``correct`` come out
false. The cell's loop (``perfbench/loops/<loop>.py``, by the mix's
``"loop"``) drives the run; its system (``perfbench/systems/<system>.py``,
by the configuration's ``"system"``) is what it drives.

Set-up (``setup_s``) runs from process start to the window's start: the
imports, the kernel library's load and the loop's set-up (for ``waves``:
the key generation, the bulk load and the warm-up waves of the cell's own
mix). The window runs for ``seconds``. After the window: the traced run's
kernel probe and the comparison with the reference.
"""
from __future__ import annotations

import dataclasses
import functools
import gc
import sys
import time
from typing import Dict, List, Optional

from perfharness import spec, systems
from perfharness.trace import Profile, Recorder, Stretch, idle_gaps, label_at

#: modules that may not be loaded by the end of a run (top-level names)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
PROFILE_TRIES = 3


@dataclasses.dataclass
class RunRecord:
    """What a metric reader sees of a traced run."""

    window_s: float
    waves: int
    spans: Dict[str, List[float]]
    profile: Optional[Profile]
    kernel_bytes: Dict[str, List[int]]
    ops: int = 0            # operations finished in the window
    #: the system's ``PROGRAM_SPANS``: each program top span, the harness
    #: span around it (``perfharness/program.py``)
    program_spans: Dict[str, str] = dataclasses.field(default_factory=dict)


def forbidden_modules(names=None) -> List[str]:
    """The top-level names of ``FORBIDDEN`` among the loaded modules (or
    ``names``), each compared whole: ``repro_torch`` is not ``repro``."""
    tops = {n.split(".")[0] for n in list(sys.modules if names is None
                                          else names)}
    return sorted(t for t in tops if t in FORBIDDEN)


class _Device:
    """The torch calls the harness makes, a no-op off CUDA."""

    def __init__(self, torch, device):
        self.torch = torch
        self.cuda = torch.device(device).type == "cuda"

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def launch_counts(self):
        from repro_torch.kernels import ops
        return ops.launch_counts()

    def allocated(self) -> int:
        return int(self.torch.cuda.memory_allocated()) if self.cuda else 0

    def peak(self) -> int:
        return int(self.torch.cuda.max_memory_allocated()) if self.cuda else 0

    def info(self) -> dict:
        if not self.cuda:
            return {"platform": "cpu", "kind": "cpu", "count": 0}
        return {"platform": "gpu",
                "kind": self.torch.cuda.get_device_name(0),
                "count": 1}


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

#: the numbers compared, each with its limit (exact answers: 0)
LIMITS = {"lookups_wrong": 0, "contents_wrong": 0, "answers_wrong": 0}


def _breakdown(p: Profile) -> dict:
    by_name: Dict[str, float] = {}
    for name, a, b in p.device:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps: Dict[str, float] = {}
    for a, b in idle_gaps(p):
        lab = label_at(p.spans, 0.5 * (a + b))
        gaps[lab] = gaps.get(lab, 0.0) + (b - a)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:200], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in idle]}


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda",
             factory=None, t_process: Optional[float] = None) -> dict:
    """One run; returns the result line's object (``correct`` last but for
    ``check``)."""
    import torch

    t_process = time.perf_counter() if t_process is None else t_process
    imports_s = time.perf_counter() - t_process
    dev = _Device(torch, device)
    rec = Recorder(trace, sync=dev.sync)
    factory = factory or functools.partial(systems.build,
                                           bench_dir=cell.bench_dir)
    loop = spec.loop(cell.traffic["loop"], cell.bench_dir)
    if dev.cuda:
        from repro_torch.kernels import build as kbuild
        with rec.phase("kernels"):
            kbuild.library()
    run = loop.Run(cell, seed, device, rec, dev, factory)
    dev.sync()

    stretch = None
    profile_s = float(cell.traffic.get("profile_seconds", 1.0))
    if trace:
        # off the card the profiler sees the host alone: one try, short
        stretch = Stretch(rec, dev, PROFILE_TRIES if dev.cuda else 1)
        with rec.phase("profiler"):
            stretch.warm_up()
    setup_s = time.perf_counter() - t_process
    w = run.window(seconds, stretch, profile_s, trace)
    if stretch is not None:
        # a window that closed before its stretch began is profiled past it
        while not stretch.n_tries or (stretch.result().short
                                      and stretch.n_tries < stretch.tries):
            run.extra_stretch(stretch, profile_s)

    kernel_bytes: Dict[str, List[int]] = {}
    if trace:
        run.probe(spec.kernel_modules(cell.bench_dir), kernel_bytes)
    peak = dev.peak()
    prog_keys, prog_vals = run.system.contents()
    run.system.close()
    run.system = None
    gc.collect()
    if dev.cuda:
        torch.cuda.empty_cache()

    check = run.check(prog_keys, prog_vals)
    bytes_per_key = check.pop("bytes_per_key")
    compared = {k: v for k, v in check.items() if k in LIMITS}
    correct = all(v <= LIMITS[k] for k, v in compared.items())

    metrics = {}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if not trace:
        e2e = run.metrics(w)
        e2e["bytes_per_key"] = bytes_per_key
        e2e["setup_s"] = setup_s
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    record = RunRecord(
        window_s=w["window_s"], waves=w["waves"],
        spans=rec.spans,
        profile=rec.profiles[-1] if rec.profiles else None,
        kernel_bytes=kernel_bytes,
        ops=int(w.get("ops", 0)),
        program_spans=dict(getattr(
            spec.system(cell.config["system"], cell.bench_dir),
            "PROGRAM_SPANS", {})),
    )
    if trace:
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"], cell.bench_dir)(record)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": units[m["name"]]}

    info = dev.info()
    info["memory_peak_bytes"] = peak
    out = {"correct": bool(correct), "attempted": int(w["attempted"]),
           "failed": int(w["failed"]), "metrics": metrics, "device": info}
    if trace and record.profile is not None:
        p = record.profile
        info["busy_s"] = p.busy_s()
        info["window_s"] = p.window_s
        info["trace_short"] = p.short
        out["breakdown"] = _breakdown(p)
    out["setup_split"] = {"imports": imports_s, **rec.setup}
    out["check"] = {k: {"value": int(v), "limit": LIMITS[k]}
                    for k, v in compared.items()}
    out["check"].update({k: {"value": int(v)} for k, v in check.items()
                         if k not in LIMITS})
    out["_examples"] = getattr(run, "examples", [])
    out["_record"] = record
    return out
