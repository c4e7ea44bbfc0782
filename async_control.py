#!/usr/bin/env python3
"""Controls for the threaded maintenance path: what makes a shard build on
a worker thread, its commit and the insert waves beside it slower than the
same work with no other thread running?

    python3 async_control.py [--out PATH] [--rounds N]

On a 4-shard router of ``chip_smoke.py``'s 4M loaded wikits keys (values
2k+1) on one GPU, each condition below times one shard-0 retrain build with
a fixed GMM (as ``chip_smoke.py``'s async-maintenance phase), its commit,
and then four 4096-key insert waves of fresh keys:

  * ``inline``: the build on the main thread, no other thread;
  * ``worker``: the build on a ``MaintenanceExecutor`` worker while the
    main thread waits, no other thread;
  * ``readers1`` / ``readers4``: plus 1 / 4 threads looking up a 512-key
    probe back to back (``chip_smoke.py``'s async readers; each lookup
    copies its result to the host);
  * ``readers4_side``: 4 such readers, each launching on a CUDA stream of
    its own (no insert waves here: the main thread's inserts free tensors
    that a side-stream reader may still read);
  * ``readers4_threads1``: 4 readers with ``torch.set_num_threads(1)``;
  * ``readers4_switch05``: 4 readers with the interpreter's switch
    interval at 0.5 ms (``sys.setswitchinterval``; the default is 5 ms),
    which changes only how long a thread waiting for the interpreter lock
    waits before the holder is asked to give it up;
  * ``readers4_procs``: the same 4 readers' work in 4 other processes
    (each loads its own copy of the router on the card, then looks up the
    probe back to back), which share the card, the driver and the CPU
    cores with the build but not its interpreter lock.

The conditions run in this order, then in reverse, ``--rounds`` times in
all. Every reader checks its answers and the final contents are checked.
Each condition prints one JSON line; the whole record goes to ``--out``
(default ``chiprun_out/async_control.json``) beside the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import json
import queue
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402  (the card line, require and the key set)
from chip_smoke import BATCH, N_KEYS, N_SHARDS, require  # noqa: E402

CONDITIONS = ("inline", "worker", "readers1", "readers4", "readers4_side",
              "readers4_threads1", "readers4_switch05", "readers4_procs")
WAVES = 4


def _reader(torch, router, probe, stop, failures, rounds, side):
    stream = torch.cuda.Stream() if side else None
    try:
        with torch.cuda.stream(stream):  # no-op for None
            while not stop.is_set():
                f, v = router.lookup(probe)
                if not (f.all() and np.array_equal(v, 2 * probe + 1)):
                    failures.append("probe mismatch")
                    return
                rounds[0] += 1
    except Exception as e:  # noqa: BLE001 — reported as a failure
        failures.append(repr(e))


def _proc_reader(stop, ready, rounds):
    """A reader in a process of its own (spawned): its own router of the
    same loaded keys, then the probe looked up back to back until
    ``stop``."""
    import torch
    from repro_torch.core import ShardedUpLIF
    from repro_torch.data import WorkloadRunner, make_dataset

    loaded = WorkloadRunner(make_dataset("wikits", N_KEYS), init_frac=0.5,
                            batch=BATCH, seed=0).init_keys
    router = ShardedUpLIF(loaded, 2 * loaded + 1, n_shards=N_SHARDS)
    probe = loaded[:: len(loaded) // 512][:512]
    torch.cuda.synchronize()
    ready.put(True)
    while not stop.is_set():
        f, v = router.lookup(probe)
        if not (f.all() and np.array_equal(v, 2 * probe + 1)):
            ready.put(False)
            return
        with rounds.get_lock():
            rounds.value += 1


class _Procs:
    """``n`` spawned ``_proc_reader`` processes; ``rounds`` reads like the
    threads' shared counter."""

    def __init__(self, n):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.stop, self.ready = ctx.Event(), ctx.Queue()
        self.count = ctx.Value("q", 0)
        self.procs = [ctx.Process(target=_proc_reader, daemon=True,
                                  args=(self.stop, self.ready, self.count))
                      for _ in range(n)]

    def __getitem__(self, i):
        return self.count.value

    def start(self):
        for p in self.procs:
            p.start()
        ok = [self.ready.get(timeout=600.0) for _ in self.procs]
        require(all(ok), "a reader process read a wrong answer")

    def close(self):
        """Stop and join every process; True if one failed: read a wrong
        answer, ended with an error, or had to be terminated."""
        self.stop.set()
        bad = False
        for p in self.procs:
            p.join(60.0)
            if p.is_alive():
                bad = True
                p.terminate()
                p.join(10.0)
            bad |= p.exitcode != 0
        while True:
            try:
                bad |= not self.ready.get_nowait()
            except queue.Empty:
                return bad


def run_condition(torch, router, name, gmm, probe, fresh):
    from repro_torch.tuning import (
        A_RETRAIN_SHARD, MaintenanceExecutor, MaintenancePlan, build,
    )

    n_threads = 0 if name in ("inline", "worker") else \
        1 if name == "readers1" else 4
    stop = threading.Event()
    failures, rounds = [], [0]
    procs = _Procs(n_threads) if name == "readers4_procs" else None
    threads = [] if procs else [threading.Thread(
        target=_reader, daemon=True,
        args=(torch, router, probe, stop, failures, rounds,
              name == "readers4_side")) for _ in range(n_threads)]
    rounds = procs if procs else rounds
    old_threads, old_switch = torch.get_num_threads(), sys.getswitchinterval()
    if name == "readers4_threads1":
        torch.set_num_threads(1)
    if name == "readers4_switch05":
        sys.setswitchinterval(0.0005)
    executor = MaintenanceExecutor(n_workers=1)
    plan = MaintenancePlan(plan_id=1, epoch=-1, wave=0,
                           action=A_RETRAIN_SHARD, shard=0, gmm=gmm,
                           cost_estimate=0.0)
    rec = {"condition": name, "threads": n_threads}
    try:
        for t in threads:
            t.start()
        if procs:
            procs.start()
        time.sleep(0.5)  # let the threads reach their loops
        r0 = rounds[0]
        t0 = time.perf_counter()
        snap = router.snapshot((0,))
        if name == "inline":
            delta, build_s = build(plan, snap), None
            torch.cuda.synchronize()
        else:
            executor.submit(plan, snap)
            res = executor.wait(timeout=600.0)
            require(len(res) == 1 and res[0].error is None
                    and res[0].delta is not None,
                    f"{name}: the build failed: {res}")
            delta, build_s = res[0].delta, res[0].build_seconds
        rec["build_s"] = time.perf_counter() - t0
        rec["build_s_worker"] = build_s
        rec["thread_rounds_per_s"] = (rounds[0] - r0) / rec["build_s"]
        t0 = time.perf_counter()
        require(router.commit(delta), f"{name}: the commit was refused")
        torch.cuda.synchronize()
        rec["commit_s"] = time.perf_counter() - t0
        waves = []
        if name != "readers4_side":
            for w in range(WAVES):
                new = fresh[w * BATCH:(w + 1) * BATCH]
                require(len(new) == BATCH, "out of fresh keys")
                t0 = time.perf_counter()
                router.insert(new, 2 * new + 1)
                torch.cuda.synchronize()
                waves.append((time.perf_counter() - t0) * 1e3)
        rec["insert_wave_ms"] = waves
    finally:
        stop.set()
        for t in threads:
            t.join(60.0)
        if procs and procs.close():
            failures.append("a reader process read a wrong answer")
        executor.close()
        torch.set_num_threads(old_threads)
        sys.setswitchinterval(old_switch)
    require(not any(t.is_alive() for t in threads), f"{name}: a thread hung")
    require(not failures, f"{name}: {failures[:3]}")
    return rec


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "async_control.json"))
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("async_control: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.core import ShardedUpLIF
    from repro_torch.core.types import GMMState
    from repro_torch.data import WorkloadRunner, make_dataset
    from repro_torch.kernels import build

    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    build.library()
    keys = make_dataset("wikits", N_KEYS)
    runner = WorkloadRunner(keys, init_frac=0.5, batch=BATCH, seed=0)
    loaded, unloaded = runner.init_keys, runner.insert_keys
    lo, hi = float(loaded[0]), float(loaded[-1])
    gmm = GMMState(
        weights=torch.tensor([0.7, 0.3], dtype=torch.float64),
        means=torch.tensor([lo + 0.1 * (hi - lo), lo + 0.6 * (hi - lo)],
                           dtype=torch.float64),
        stds=torch.tensor([0.05 * (hi - lo), 0.2 * (hi - lo)],
                          dtype=torch.float64),
    )
    router = ShardedUpLIF(loaded, 2 * loaded + 1, n_shards=N_SHARDS)
    probe = loaded[:: len(loaded) // 512][:512]
    order = []
    for r in range(args.rounds):
        order += list(CONDITIONS if r % 2 == 0 else reversed(CONDITIONS))
    records, used = [], 0
    for name in order:
        fresh = unloaded[used:used + WAVES * BATCH]
        rec = run_condition(torch, router, name, gmm, probe, fresh)
        used += len(fresh) if rec["insert_wave_ms"] else 0
        records.append(rec)
        print("control " + json.dumps(rec), flush=True)
    new = unloaded[:used]
    f, v = router.lookup(new)
    require(f.all() and np.array_equal(v, 2 * new + 1),
            "an acknowledged insert is not readable")
    f, v = router.lookup(loaded[::97])
    require(f.all() and np.array_equal(v, 2 * loaded[::97] + 1),
            "a loaded key is not readable")
    out = {"card": card, "keys": len(loaded), "shards": N_SHARDS,
           "torch_threads": torch.get_num_threads(),
           "switch_interval_s": sys.getswitchinterval(), "records": records}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    summary = {}
    for name in CONDITIONS:
        rs = [r for r in records if r["condition"] == name]
        summary[name] = {
            "build_s": [r["build_s"] for r in rs],
            "commit_s": [r["commit_s"] for r in rs],
            "insert_wave_ms_p50": float(np.median(
                [w for r in rs for w in r["insert_wave_ms"]]))
            if rs[0]["insert_wave_ms"] else None,
        }
    print("summary " + json.dumps(summary), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
