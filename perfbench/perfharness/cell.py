"""One run of one cell: set-up, the measured window, the check, the line.

``run_cell`` is everything ``run.py`` does after it has found a card. The
CPU tests call it with ``device="cpu"`` at a small scale, and with the
program's timed path broken underneath, to see ``correct`` come out
false.

Set-up (``setup_s``) runs from process start to the window's start: the
imports, the key generation, the kernel library's load, the bulk load and
two warm-up waves of the cell's own mix. The window runs for ``seconds``;
its rate counts every operation finished in it over all of its time, key
generation between waves included. ``bytes_per_key`` is read after the
window's ``MEMORY_WAVE``-th wave (driven past the window's end, untimed,
where the window held fewer), so that every run reads it after the same
operations. After the window: the traced run's kernel probe and the
comparison with the reference.
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from perfharness import keys as keygen
from perfharness import probe, spec, systems
from perfharness.trace import Profile, Recorder, Stretch, idle_gaps, label_at
from reference import (Reference, contents_examples, contents_mismatch,
                       count_wrong)

#: modules that may not be loaded by the end of a run (top-level names)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
CHECK_EVERY = 8          # a wave's answers are checked with this odds (1 in)
PROBE_WAVES = 4          # waves past the window that read the kernels' bytes
PROFILE_TRIES = 3
MEMORY_WAVE = 1000       # bytes_per_key is read after this wave of the window


@dataclasses.dataclass
class RunRecord:
    """What a metric reader sees of a traced run."""

    window_s: float
    waves: int
    spans: Dict[str, List[float]]
    profile: Optional[Profile]
    kernel_bytes: Dict[str, List[int]]


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


def _pct(values, q) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


# ---------------------------------------------------------------------------
# wave cells
# ---------------------------------------------------------------------------


class WaveRun:
    """Closed-loop waves (``WorkloadRunner``'s mix) through the system."""

    def __init__(self, cell, seed, device, rec, dev, factory):
        cfg, tr = cell.config, cell.traffic
        with rec.phase("gen"):
            all_keys = keygen.DATASETS[cfg["dataset"]](
                int(cfg["keys"]), seed, device)
            self.tape = keygen.WaveTape(
                all_keys, init_frac=cfg["init_keys"] / cfg["keys"],
                batch=int(cfg["batch"]), write_rate=float(tr["write_rate"]),
                seed=seed, device=device,
                distribution_shift=bool(tr.get("distribution_shift", False)),
            )
            del all_keys
            init = self.tape.init_keys
            init_vals = keygen.loaded_value(init)
        with rec.phase("load"):
            self.system = factory(cfg, init, init_vals, device, rec)
            dev.sync()
        self.ref = Reference(init, init_vals)
        self.rec, self.dev = rec, dev
        self.check_rng = np.random.default_rng([seed, 2])
        self.checks = []            # (reads, found, vals, seq)
        self.seq = 0
        self.memory = None          # (bytes allocated, reference sequence)
        with rec.phase("warmup"):
            for _ in range(int(tr.get("warmup_waves", 2))):
                self.wave(check=True)
            dev.sync()

    def wave(self, check: Optional[bool] = None):
        """One wave: draw it, serve it (timed to its synchronised result).
        Returns (ops, latency)."""
        with self.rec.span("gen"):
            reads, ins = self.tape.next_wave()
            ins_vals = keygen.inserted_value(ins)
        t0 = time.perf_counter()
        found, vals = self.system.wave(reads, ins, ins_vals)
        self.dev.sync()
        dt = time.perf_counter() - t0
        n = len(reads) + len(ins)
        # the reads of wave w see the writes of waves before it
        s = self.seq
        self.seq += 1
        if len(ins):
            self.ref.insert(ins, ins_vals, 2 * s + 1)
        if check is None:
            check = self.check_rng.integers(CHECK_EVERY) == 0
        if check and len(reads):
            self.checks.append((reads, found, vals, 2 * s))
        return n, dt

    def window(self, seconds, stretch: Optional[Stretch], profile_s, trace):
        lat, n_ops = [], 0
        t_start = time.perf_counter()
        t_end = t_start + seconds
        t_prof = t_start + 0.4 * seconds
        while True:
            now = time.perf_counter()
            if now >= t_end:
                break
            if stretch is not None:
                if not stretch.n_tries and not stretch.active and now >= t_prof:
                    stretch.start()
                    t_stop = time.perf_counter() + profile_s
                elif stretch.active and now >= t_stop:
                    stretch.stop()
            n, dt = self.wave(check=None)
            if stretch is not None and stretch.active:
                stretch.wave()
            lat.append(dt)
            n_ops += n
            if len(lat) == MEMORY_WAVE:
                self._read_memory()
        if stretch is not None and stretch.active:
            stretch.stop()
        window_s = time.perf_counter() - t_start
        for _ in range(len(lat), MEMORY_WAVE):
            self.wave(check=None)
        if self.memory is None:
            self._read_memory()
        return dict(window_s=window_s, ops=n_ops, waves=len(lat),
                    lat_s=lat, attempted=n_ops, failed=0)

    def _read_memory(self):
        """The device bytes the index holds, and the reference's sequence
        that they hold the writes before (the harness holds no device
        tensor: its keys and answers are on the host)."""
        self.memory = (self.dev.allocated(), 2 * self.seq)

    def extra_stretch(self, stretch: Stretch, profile_s: float):
        """Profile ``profile_s`` more of the cell's waves past the window;
        their spans are marked in the trace but not kept as samples."""
        kept = {k: len(v) for k, v in self.rec.spans.items()}
        stretch.start()
        t_stop = time.perf_counter() + profile_s
        while time.perf_counter() < t_stop:
            self.wave(check=True)
            stretch.wave()
        stretch.stop()
        _truncate(self.rec.spans, kept)

    def probe(self, kmods, out):
        enabled, self.rec.enabled = self.rec.enabled, False
        try:
            with probe.observe(kmods, out):
                for _ in range(PROBE_WAVES):
                    self.wave(check=True)
                self.dev.sync()
        finally:
            self.rec.enabled = enabled

    def metrics(self, w) -> dict:
        return {
            "ops_per_s": w["ops"] / w["window_s"],
            "op_ms_p99": _pct(w["lat_s"], 99) * 1e3,
        }

    def check(self, prog_keys, prog_vals) -> dict:
        wrong = checked = 0
        self.examples = []
        for reads, found, vals, s in self.checks:
            wf, wv = self.ref.lookup(reads, s)
            n_bad = count_wrong(found, vals, wf, wv)
            wrong += n_bad
            checked += len(reads)
            if n_bad and len(self.examples) < 8:
                bad = np.nonzero((found != wf) | (found & wf & (vals != wv)))[0]
                for i in bad[:8 - len(self.examples)]:
                    self.examples.append(
                        f"wave {s // 2}: lookup {int(reads[i])} gave "
                        f"({bool(found[i])}, {int(vals[i])}), the reference "
                        f"({bool(wf[i])}, {int(wv[i])})")
        want_k, want_v = self.ref.contents()
        cw = contents_mismatch(prog_keys, prog_vals, want_k, want_v)
        if cw:
            self.examples += contents_examples(prog_keys, prog_vals,
                                               want_k, want_v)
        mem, seq = self.memory
        return {
            "lookups_checked": checked,
            "lookups_wrong": wrong,
            "contents_wrong": cw,
            "bytes_per_key": mem / max(self.ref.size(before=seq), 1),
        }


def _truncate(store: Dict[str, list], kept: Dict[str, int]):
    """Drop the samples recorded in ``store`` since ``kept`` (each list's
    length) was taken."""
    for k in list(store):
        if k in kept:
            del store[k][kept[k]:]
        else:
            del store[k]


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
    factory = factory or systems.build
    kind = cell.traffic["loop"]
    if dev.cuda:
        from repro_torch.kernels import build as kbuild
        with rec.phase("kernels"):
            kbuild.library()
    if kind != "waves":
        raise spec.SpecError(f"unknown loop {kind!r}")
    run = WaveRun(cell, seed, device, rec, dev, factory)
    dev.sync()

    stretch = None
    profile_s = float(cell.traffic.get("profile_seconds", 1.0))
    if trace and dev.cuda:
        stretch = Stretch(rec, torch, dev.launch_counts, PROFILE_TRIES)
        with rec.phase("profiler"):
            stretch.warm_up()
    setup_s = time.perf_counter() - t_process
    w = run.window(seconds, stretch, profile_s, trace)
    if stretch is not None:
        while stretch.result().short and stretch.n_tries < PROFILE_TRIES:
            run.extra_stretch(stretch, profile_s)

    kernel_bytes: Dict[str, List[int]] = {}
    if trace:
        run.probe(spec.kernel_modules(), kernel_bytes)
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
    )
    if trace:
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"])(record)
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
