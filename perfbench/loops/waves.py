"""``"loop": "waves"``: closed-loop waves of the configuration's batch.

Each wave draws its reads and inserts from the seed's tape (the mix's
``write_rate``, and ``distribution_shift``), serves them through the
system and waits for the synchronised result. Set-up draws the keys, loads
the system and runs ``warmup_waves`` waves of the mix. The window's rate
counts every operation finished in it over all of its time, key generation
between waves included. ``bytes_per_key`` is read after the window's
``MEMORY_WAVE``-th wave (driven past the window's end, untimed, where the
window held fewer), so that every run reads it after the same operations.
About one wave in ``CHECK_EVERY``, drawn from the seed, has its answers
checked against the reference, and so have the contents after the window.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np

from perfharness import keys as keygen
from perfharness import probe
from perfharness.trace import Stretch
from reference import (Reference, contents_examples, contents_mismatch,
                       count_wrong)

CHECK_EVERY = 8          # a wave's answers are checked with this odds (1 in)
PROBE_WAVES = 4          # waves past the window that read the kernels' bytes
MEMORY_WAVE = 1000       # bytes_per_key is read after this wave of the window


def _pct(values, q) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


class Run:
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
