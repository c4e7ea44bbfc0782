"""Request gateway: async ingestion -> continuous micro-batching -> waves
(port of ``repro/serve/gateway.py``).

The versioned router, the budgeted maintenance scheduler and the fused
locate path all assume someone hands them fixed-shape batches. This module
is that someone: it turns a live stream of single lookup/insert/delete/
range requests from many client threads into padded ``MixedWave``s:

  client threads --> per-op queues --> flusher thread --> apply_wave
        |   (RequestFuture      (size-OR-deadline        (one dispatch
        |    per request)        trigger)                 per op kind)
        <-----------------------  results + queue/service latency

Three disciplines:

* **micro-batching** — a flush fires when any op queue reaches
  ``max_batch`` OR the oldest queued request ages past ``max_delay_s``,
  whichever comes first. ``passthrough=True`` is the batch-size-1
  baseline: ``max_batch`` 1 and no delay.
* **shape quantization** — every flush pads to the power-of-two family
  (``core/shapes.padded_width``) in [``min_pad``, ``max_batch``], so a
  sweep of offered loads reaches only the widths ``warmup()`` primed. The
  port has no jit cache; what warmup settles is the kernel library (built
  and loaded once) and the caching allocator's blocks for those widths.
* **load shedding** — admission control over total backlog, shedding
  maintenance first (``set_pressure`` pauses plan admission, stops budget
  refill and slows drains) and clients only at the last rung, with an
  explicit ``RetryAfter`` hint.

Threading contract: client threads only touch the queues (under one
condition lock); the flusher thread is the router's single writer — index
mutations, tuner hooks and maintenance commits all run there. A wave's
results come back as numpy arrays (one device-to-host copy per op kind),
and each future is completed by indexing them: no per-request device
sync. Every thread launches on the device's default stream (see
``tuning/executor.py``).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

import torch

from repro_torch.core.shapes import padded_width, pow2_at_least
from repro_torch.core.sharded import MixedWave, ShardedUpLIF
from repro_torch.core.types import KEY_MAX
from repro_torch.serve.admission import AdmissionController, RetryAfter
from repro_torch.serve.queues import OPS, GatewayClosed, OpQueue, RequestFuture

#: range flushes stay below the router's 256 bucket floor so every range
#: wave has the one warmed width regardless of offered load
_RANGE_FLUSH = 256


@dataclasses.dataclass
class GatewayConfig:
    max_batch: int = 2048          # size-flush trigger per op queue (pow2)
    max_delay_s: float = 0.002     # deadline-flush trigger (oldest request)
    min_pad: int = 256             # smallest padded flush width (pow2)
    max_pending: int = 1 << 15     # admission capacity: total queued reqs
    shed_maintenance_at: float = 0.5   # backlog fraction → pressure 1
    shed_requests_at: float = 0.9      # backlog fraction → RetryAfter
    range_max_out: int = 256
    # batch-size-1 baseline: flush every request immediately (a wave then
    # holds at most one request of each op kind)
    passthrough: bool = False
    # per-completed-request hook, called on the flusher thread once every
    # future of a successful wave holds its result (keep it tiny)
    on_complete: Optional[Callable[[RequestFuture], None]] = None

    def __post_init__(self):
        if self.passthrough:
            self.max_batch = 1
            self.max_delay_s = 0.0
        if self.min_pad < 1 or self.min_pad & (self.min_pad - 1):
            raise ValueError(f"min_pad must be a power of two, got {self.min_pad}")


class RequestGateway:
    """Async ingestion gateway over a ``ShardedUpLIF`` (± ``SelfTuner``).

    ``submit_*`` are safe from any thread and return a ``RequestFuture``;
    the flusher owns the index. ``close()`` drains once, idempotently —
    late submissions raise ``GatewayClosed`` instead of hanging."""

    def __init__(
        self,
        index: ShardedUpLIF,
        tuner=None,
        config: GatewayConfig = None,
    ):
        self.index = index
        self.tuner = tuner
        self.cfg = config or GatewayConfig()
        self.admission = AdmissionController(
            capacity=self.cfg.max_pending,
            shed_maintenance_at=self.cfg.shed_maintenance_at,
            shed_requests_at=self.cfg.shed_requests_at,
        )
        self._cond = threading.Condition()
        self._io_lock = threading.Lock()   # serializes apply_wave (warmup)
        self.queues: Dict[str, OpQueue] = {op: OpQueue(op) for op in OPS}
        self._backlog = 0
        self._closed = False
        self._pressure = 0
        self._rate_ewma = 0.0              # drained ops/s (retry-after input)
        # -- observability -------------------------------------------------
        self.n_waves = 0
        self.n_ops = 0
        self.n_rejected = 0
        self.flush_triggers = {"size": 0, "deadline": 0, "close": 0}
        self.pad_widths: Dict[str, Dict[int, int]] = {op: {} for op in OPS}
        self.pressure_events: List[tuple] = []   # (t, level)
        self.first_reject_t: Optional[float] = None
        self.last_error: Optional[str] = None
        self._thread = threading.Thread(
            target=self._run, name="gateway-flusher", daemon=True
        )
        self._thread.start()

    # -- client API (any thread) ----------------------------------------------
    def submit_lookup(self, key: int) -> RequestFuture:
        """Future resolves to ``(found: bool, value: int)``."""
        return self._submit("lookup", key)

    def submit_insert(self, key: int, val: int) -> RequestFuture:
        """Future resolves to ``True`` once the write is applied (from that
        moment every later lookup through the gateway observes it)."""
        return self._submit("insert", key, val)

    def submit_delete(self, key: int) -> RequestFuture:
        """Future resolves to ``hit: bool``."""
        return self._submit("delete", key)

    def submit_range(self, lo: int, hi: int) -> RequestFuture:
        """Future resolves to ``(keys, vals)`` arrays."""
        return self._submit("range", lo, hi)

    def _submit(self, op: str, key: int, val: int = 0) -> RequestFuture:
        fut = RequestFuture(op)
        with self._cond:
            if self._closed:
                raise GatewayClosed("gateway is closed")
            lvl = self.admission.level(self._backlog + 1)
            if lvl >= 1:
                # shed maintenance BEFORE any client is turned away — the
                # submit-time check makes the ordering exact even when a
                # burst crosses both thresholds inside one flush interval
                self._apply_pressure(lvl)
            if lvl >= 2:
                self.n_rejected += 1
                if self.first_reject_t is None:
                    self.first_reject_t = time.perf_counter()
                raise RetryAfter(
                    self.admission.retry_after(
                        self._backlog + 1, self._rate_ewma
                    ),
                    self._backlog + 1,
                )
            self.queues[op].append(fut, key, val)
            self._backlog += 1
            self._cond.notify()
        return fut

    @property
    def backlog(self) -> int:
        return self._backlog

    @property
    def pressure(self) -> int:
        return self._pressure

    # -- overload ladder -------------------------------------------------------
    def _apply_pressure(self, lvl: int):
        """Record + propagate a pressure change (idempotent per level)."""
        if lvl == self._pressure:
            return
        self._pressure = lvl
        self.pressure_events.append((time.perf_counter(), lvl))
        if self.tuner is not None:
            self.tuner.set_pressure(lvl)

    # -- flush state machine ---------------------------------------------------
    def _flush_threshold(self, op: str) -> int:
        return min(self.cfg.max_batch, _RANGE_FLUSH) if op == "range" \
            else self.cfg.max_batch

    def _due_trigger(self, now: float) -> Optional[str]:
        """Which trigger fires, if any (condition lock held)."""
        if self._backlog == 0:
            return None
        for op, q in self.queues.items():
            if len(q) >= self._flush_threshold(op):
                return "size"
        oldest = min(
            (q.oldest_t for q in self.queues.values() if len(q)),
        )
        if now - oldest >= self.cfg.max_delay_s:
            return "deadline"
        return None

    def _wait_timeout(self, now: float) -> Optional[float]:
        if self._backlog == 0:
            return None
        oldest = min(
            (q.oldest_t for q in self.queues.values() if len(q)),
        )
        return max(oldest + self.cfg.max_delay_s - now, 0.0)

    def _drain_wave(self, trigger: str):
        """Pop up to one flush's worth of every op queue into a MixedWave
        (condition lock held). Every drained future is stamped with its
        dispatch time — queue latency ends here."""
        now = time.perf_counter()
        futs: Dict[str, List[RequestFuture]] = {}
        batches = {}
        for op, q in self.queues.items():
            f, keys, vals = q.drain(self._flush_threshold(op))
            futs[op], batches[op] = f, (keys, vals)
            self._backlog -= len(f)
            for fu in f:
                fu.t_dispatch = now
        self.flush_triggers[trigger] += 1

        def _pad(op: str) -> Optional[int]:
            n = len(futs[op])
            if n == 0:
                return None
            w = padded_width(
                n, floor=self.cfg.min_pad,
                ceiling=pow2_at_least(
                    max(self._flush_threshold(op), self.cfg.min_pad)
                ),
            )
            self.pad_widths[op][w] = self.pad_widths[op].get(w, 0) + 1
            return w

        wave = MixedWave(
            insert_keys=batches["insert"][0],
            insert_vals=batches["insert"][1],
            delete_keys=batches["delete"][0],
            lookup_keys=batches["lookup"][0],
            range_lo=batches["range"][0],
            range_hi=batches["range"][1],
            pad_insert=_pad("insert"),
            pad_delete=_pad("delete"),
            pad_lookup=_pad("lookup"),
            range_max_out=self.cfg.range_max_out,
        )
        return wave, futs

    def _dispatch(self, wave: MixedWave, futs: Dict[str, List[RequestFuture]]):
        """Run one wave on the router and complete its futures (flusher
        thread — the single writer). Maintenance runs AFTER the futures
        resolve: clients never wait on the tuner."""
        n = wave.n_ops
        t0 = time.perf_counter()
        try:
            with self._io_lock:
                res = self.index.apply_wave(wave)
        except Exception as e:  # noqa: BLE001 — fail the wave, keep serving
            self.last_error = repr(e)
            for fs in futs.values():
                for fu in fs:
                    fu.set_exception(e)
            return
        dt = time.perf_counter() - t0
        for i, fu in enumerate(futs["insert"]):
            fu.set_result(True)
        for i, fu in enumerate(futs["delete"]):
            fu.set_result(bool(res.delete_hit[i]))
        for i, fu in enumerate(futs["lookup"]):
            fu.set_result(
                (bool(res.lookup_found[i]), int(res.lookup_vals[i]))
            )
        for i, fu in enumerate(futs["range"]):
            fu.set_result((res.range_keys[i], res.range_vals[i]))
        if self.cfg.on_complete is not None:
            for fs in futs.values():
                for fu in fs:
                    self.cfg.on_complete(fu)
        self.n_waves += 1
        self.n_ops += n
        if dt > 0 and n > 0:
            self._rate_ewma = 0.7 * self._rate_ewma + 0.3 * (n / dt)
        # -- between-wave maintenance, pressure-gated --------------------------
        with self._cond:
            self._apply_pressure(self.admission.level(self._backlog))
        if self.tuner is not None:
            ik = wave.insert_keys
            if ik is not None and len(ik):
                self.tuner.observe_inserts(ik)
            self.tuner.after_wave(n, dt)

    def _run(self):
        while True:
            with self._cond:
                now = time.perf_counter()
                trigger = self._due_trigger(now)
                while not self._closed and trigger is None:
                    self._cond.wait(self._wait_timeout(now))
                    now = time.perf_counter()
                    trigger = self._due_trigger(now)
                if self._closed:
                    if self._backlog == 0:
                        return
                    trigger = "close"  # final drain: flush whatever is left
                wave, futs = self._drain_wave(trigger)
            self._dispatch(wave, futs)

    # -- warmup ----------------------------------------------------------------
    def _first_slot_key(self) -> Optional[int]:
        """The first slot key below KEY_MAX, in the stacked array's order,
        found on the device: one element comes back, not the slot array."""
        keys = self.index.state.slots.keys.reshape(-1)
        below = keys < KEY_MAX
        pos = torch.argmax(below.to(torch.uint8))  # the first True
        k, ok = torch.stack([keys[pos], below[pos].to(torch.int64)]).tolist()
        return int(k) if ok else None

    def warmup(self) -> Dict[str, List[int]]:
        """Run every (op kind, pad width) the flush family can reach once,
        so the kernel library is built and loaded, and the allocator holds
        blocks of every width, before serving starts. Contents are no-ops:
        inserts re-upsert one live (key, value) pair, deletes target a
        probed absent key, lookups are reads. Returns the widths primed per
        op."""
        widths = []
        w = self.cfg.min_pad
        cap = pow2_at_least(max(self.cfg.max_batch, self.cfg.min_pad))
        while w <= cap:
            widths.append(w)
            w *= 2
        # one live pair for idempotent insert warmup
        k = self._first_slot_key()
        live = None
        if k is not None:
            f, v = self.index.lookup(np.asarray([k]))
            if f[0]:
                live = (k, int(v[0]))
        # one absent key for no-op delete warmup
        rng = np.random.default_rng(0xB00)
        absent = None
        for _ in range(8):
            cand = int(rng.integers(0, KEY_MAX - 1))
            f, _v = self.index.lookup(np.asarray([cand]))
            if not f[0]:
                absent = cand
                break
        primed: Dict[str, List[int]] = {op: [] for op in OPS}
        for w in widths:
            wave = MixedWave(
                lookup_keys=np.asarray(
                    [live[0] if live else 0], dtype=np.int64
                ),
                pad_lookup=w,
                insert_keys=(
                    np.asarray([live[0]], dtype=np.int64) if live else None
                ),
                insert_vals=(
                    np.asarray([live[1]], dtype=np.int64) if live else None
                ),
                pad_insert=w if live else None,
                delete_keys=(
                    np.asarray([absent], dtype=np.int64)
                    if absent is not None
                    else None
                ),
                pad_delete=w if absent is not None else None,
                range_max_out=self.cfg.range_max_out,
            )
            with self._io_lock:
                self.index.apply_wave(wave)
            primed["lookup"].append(w)
            if live:
                primed["insert"].append(w)
            if absent is not None:
                primed["delete"].append(w)
        # the one range variant (range flushes stay under the 256 floor)
        if live:
            with self._io_lock:
                self.index.apply_wave(
                    MixedWave(
                        range_lo=np.asarray([live[0]], dtype=np.int64),
                        range_hi=np.asarray([live[0]], dtype=np.int64),
                        range_max_out=self.cfg.range_max_out,
                    )
                )
            primed["range"].append(_RANGE_FLUSH)
        return primed

    # -- shutdown --------------------------------------------------------------
    def close(self, timeout: float = 30.0):
        """Stop accepting, drain once, stop the flusher. Idempotent and
        safe to call concurrently (with in-flight flushes and with other
        closers): the flusher performs exactly one final drain, every
        already-queued future completes, and any submission racing the
        close gets ``GatewayClosed`` — never a hung future."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if threading.current_thread() is not self._thread:
            self._thread.join(timeout)
        # defensive: if the flusher died abnormally, fail—don't strand—
        # whatever is still queued (normal shutdown leaves nothing here)
        leftovers: List[RequestFuture] = []
        with self._cond:
            for q in self.queues.values():
                f, _k, _v = q.drain(len(q))
                leftovers.extend(f)
            self._backlog = 0
        for fu in leftovers:
            fu.set_exception(GatewayClosed("gateway closed before dispatch"))

    @property
    def closed(self) -> bool:
        return self._closed

    # -- introspection ---------------------------------------------------------
    def stats(self) -> dict:
        return {
            "waves": self.n_waves,
            "ops": self.n_ops,
            "backlog": self._backlog,
            "rejected": self.n_rejected,
            "pressure": self._pressure,
            "pressure_events": len(self.pressure_events),
            "flush_triggers": dict(self.flush_triggers),
            "pad_widths": {
                op: dict(sorted(w.items()))
                for op, w in self.pad_widths.items()
            },
            "drain_rate_ops_s": self._rate_ewma,
            "closed": self._closed,
            "last_error": self.last_error,
        }
