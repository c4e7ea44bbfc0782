"""Background maintenance executor (port of ``repro/tuning/executor.py``).

The middle phase of the plan/build/commit pipeline: ``build`` turns one
declarative ``MaintenancePlan`` into a ``StateDelta`` by running the
host-side unstack/retrain/split/merge machinery against an immutable
``RouterSnapshot``: it never touches the live router's tensors, so it can
run on any thread. ``MaintenanceExecutor`` runs it on a pool of daemon
worker threads: the scheduler submits (plan, snapshot) pairs after a
decision, serving waves go on, and finished deltas are collected with
``poll()`` at the next wave boundary, where the scheduler commits them.
The synchronous scheduler calls ``build`` and ``commit`` back to back, so
the two modes differ only in where the build runs, never in what it
produces.

Why threads: builds are mostly host numpy (sorts, the nullifier, the
spline fit) and small torch ops, both of which release the GIL, so the
workers overlap with serving on spare cores; and the delta must share the
live process's tensors for the commit's row write. The router keeps one
op-log per build keyed by interval, so builds for disjoint shard sets run
(and commit) independently.

Why one CUDA stream: every thread here (the gateway's flusher, client
threads, these workers) launches on the device's default stream, which is
a new thread's current stream. A snapshot's tensors and a build's new
tensors are then ordered by the stream itself, and since no op writes into
a tensor it was given, no event or ``record_stream`` is needed for a
tensor to outlive the thread that made it. A side stream for builds would
let a build's device work overlap a serving wave's, but the build's
tensors would then need events before the commit reads them and
``record_stream`` before another stream frees them. It is not used yet:
the time goes on the host (the device idles over 90% of a write wave), so
a second stream has little device work to overlap. One cost of the shared
stream: a serving wave's device-to-host copy also waits for build work
queued before it.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import List, Optional

import numpy as np

from repro_torch.core.sharded import (
    RouterSnapshot,
    StateDelta,
    merge_shells,
    retrain_shell_fitted,
    split_point,
    split_shells,
)
from repro_torch.tuning.controller import (
    A_MERGE_SHARDS,
    A_RETRAIN_SHARD,
    A_SPLIT_SHARD,
)

#: plan actions that require a build phase (everything else — switch-BMAT,
#: presize — is metadata/capacity-only and executes directly at plan time)
BUILD_ACTIONS = (A_RETRAIN_SHARD, A_SPLIT_SHARD, A_MERGE_SHARDS)


@dataclasses.dataclass
class BuildResult:
    """One finished build: the delta to commit, or why there is none.

    ``delta is None`` with ``error is None`` means the build concluded the
    action is a structural no-op (e.g. a split of a shard whose live keys
    collapsed to one value) — the plan is abandoned, not failed."""

    plan: object                    # the MaintenancePlan that was built
    delta: Optional[StateDelta]
    build_seconds: float
    error: Optional[Exception] = None


def build(plan, snapshot: RouterSnapshot) -> Optional[StateDelta]:
    """Plan + immutable snapshot -> StateDelta (a pure host build).

    Reads only the snapshot; every tensor it produces is new. Returns None
    when the action degenerates (unsplittable or unmergeable shards) — the
    same conditions under which the live entry points return False."""
    t0 = time.perf_counter()
    s = plan.shard
    if plan.action == A_RETRAIN_SHARD:
        shell = snapshot.shell(s)
        retrain_shell_fitted(
            shell, int(snapshot.state.slots.keys.shape[1]), gmm=plan.gmm
        )
        lo, hi = snapshot.shard_bounds(s)
        return StateDelta(
            epoch=snapshot.epoch, kind="retrain", shard=s,
            key_lo=lo, key_hi=hi, shells=(shell,),
            build_seconds=time.perf_counter() - t0,
            build_id=snapshot.build_id,
        )
    if plan.action == A_SPLIT_SHARD:
        shell = snapshot.shell(s)
        keys, vals = shell.extract_live()
        mid = split_point(keys)
        if mid is None:
            return None
        left, right = split_shells(shell, keys, vals, mid, snapshot.cfg)
        lo, hi = snapshot.shard_bounds(s)
        return StateDelta(
            epoch=snapshot.epoch, kind="split", shard=s,
            key_lo=lo, key_hi=hi, shells=(left, right),
            boundary=int(keys[mid]),
            build_seconds=time.perf_counter() - t0,
            build_id=snapshot.build_id,
        )
    if plan.action == A_MERGE_SHARDS:
        if snapshot.n_shards < 2 or not (0 <= s < snapshot.n_shards - 1):
            return None
        sh1, sh2 = snapshot.shell(s), snapshot.shell(s + 1)
        k1, v1 = sh1.extract_live()
        k2, v2 = sh2.extract_live()
        keys = np.concatenate([k1, k2])
        vals = np.concatenate([v1, v2])
        if len(keys) == 0:
            return None
        merged = merge_shells(
            sh1, sh2, keys, vals, snapshot.cfg,
            np.random.default_rng(snapshot.epoch),
        )
        lo, _ = snapshot.shard_bounds(s)
        _, hi = snapshot.shard_bounds(s + 1)
        return StateDelta(
            epoch=snapshot.epoch, kind="merge", shard=s,
            key_lo=lo, key_hi=hi, shells=(merged,),
            build_seconds=time.perf_counter() - t0,
            build_id=snapshot.build_id,
        )
    raise ValueError(f"action {plan.action} has no build phase")


class MaintenanceExecutor:
    """A pool of daemon workers draining a (plan, snapshot) queue through
    ``build``. ``n_workers`` bounds how many builds run concurrently — the
    scheduler's ``max_concurrent_builds`` maps straight onto it."""

    def __init__(self, n_workers: int = 1):
        self.n_workers = max(1, int(n_workers))
        self._in: "queue.Queue" = queue.Queue()
        self._out: "queue.Queue" = queue.Queue()
        self._inflight = 0
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()

    # -- lifecycle -----------------------------------------------------------
    def _ensure_threads(self):
        self._threads = [t for t in self._threads if t.is_alive()]
        if not self._threads:
            self._stop.clear()
        while len(self._threads) < self.n_workers:
            t = threading.Thread(
                target=self._worker,
                name=f"uplif-maintenance-{len(self._threads)}",
                daemon=True,
            )
            t.start()
            self._threads.append(t)

    def _worker(self):
        while not self._stop.is_set():
            try:
                item = self._in.get(timeout=0.1)
            except queue.Empty:
                continue
            if item is None:
                break
            plan, snapshot = item
            t0 = time.perf_counter()
            try:
                delta = build(plan, snapshot)
                err = None
            except Exception as e:  # noqa: BLE001 — surfaced on the serving thread
                delta, err = None, e
            self._out.put(BuildResult(
                plan=plan, delta=delta,
                build_seconds=time.perf_counter() - t0, error=err,
            ))

    def close(self):
        alive = [t for t in self._threads if t.is_alive()]
        if alive:
            self._stop.set()
            for _ in alive:
                self._in.put(None)
            for t in alive:
                t.join(timeout=5.0)
        self._threads = []
        # drain leftovers (stop sentinels included): a submit() after close
        # revives the pool, which must not inherit a stale None or build a
        # plan queued before the close
        while True:
            try:
                item = self._in.get_nowait()
            except queue.Empty:
                break
            if item is not None:  # sentinels were never counted
                self._inflight = max(self._inflight - 1, 0)

    # -- the scheduler-facing API --------------------------------------------
    def submit(self, plan, snapshot: RouterSnapshot):
        """Queue one build. The caller must hold the build's op-log
        (``snapshot`` came from ``router.snapshot(shards)``) and must not
        submit a build overlapping an in-flight build's key interval."""
        self._ensure_threads()
        self._inflight += 1
        self._in.put((plan, snapshot))

    def poll(self) -> List[BuildResult]:
        """All builds finished since the last poll (non-blocking)."""
        out = []
        while True:
            try:
                out.append(self._out.get_nowait())
            except queue.Empty:
                break
        self._inflight -= len(out)
        return out

    @property
    def inflight(self) -> int:
        return self._inflight

    def wait(self, timeout: float = 30.0) -> List[BuildResult]:
        """Block until every submitted build finished, or ``timeout``
        seconds passed; return the results (a drain helper — serving code
        uses ``poll``)."""
        results = []
        deadline = time.monotonic() + timeout
        while self._inflight > 0 and time.monotonic() < deadline:
            try:
                results.append(self._out.get(timeout=0.05))
                self._inflight -= 1
            except queue.Empty:
                continue
        return results
