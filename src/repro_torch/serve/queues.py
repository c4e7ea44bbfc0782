"""Per-request futures and per-op micro-batch queues (gateway substrate;
port of ``repro/serve/queues.py``).

The gateway (serve/gateway.py) turns a live stream of single requests
from many client threads into the fixed-shape waves the router serves.
This module holds the two passive pieces, host Python only:

* ``RequestFuture`` — the per-request handle a client blocks on. It
  carries the result AND the request's latency decomposition: queue
  latency (submit → dispatch, the batching delay admission control
  manages) and service latency (dispatch → done, the wave on the
  router). Completion runs on the flusher thread;
  ``done``/``result`` are safe from any thread.
* ``OpQueue`` — one op kind's accumulation buffer. Deliberately dumb:
  plain python lists under the GATEWAY's lock (one lock for all four
  queues — submit contends with drain only for list appends, and a
  single lock keeps the flush trigger's "total backlog" reads exact).

Locking contract: every ``OpQueue`` method must be called with the
owning gateway's condition lock held. ``RequestFuture`` methods are
internally synchronized.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, List, Optional, Tuple

import numpy as np

#: op kinds in CANONICAL WAVE ORDER — writes land before reads (see
#: ShardedUpLIF.apply_wave; read-your-writes through the gateway).
OPS = ("insert", "delete", "lookup", "range")


class GatewayClosed(RuntimeError):
    """Submission after (or during) gateway shutdown — never silently
    queued: a closed gateway has no flusher left to complete the future."""


class RequestFuture:
    """Completion handle for one gateway request.

    Timestamps: ``t_submit`` (client enqueued), ``t_dispatch`` (flusher
    drained it into a wave), ``t_done`` (result set). ``queue_latency_s``
    and ``service_latency_s`` decompose the total — the two quantities
    the bench's tail-latency story is about."""

    __slots__ = (
        "op", "t_submit", "t_dispatch", "t_done",
        "_event", "_value", "_error", "_callbacks", "_lock",
    )

    def __init__(self, op: str):
        self.op = op
        self.t_submit = time.perf_counter()
        self.t_dispatch = 0.0
        self.t_done = 0.0
        self._event = threading.Event()
        self._value: Any = None
        self._error: Optional[BaseException] = None
        self._callbacks: List[Callable[["RequestFuture"], None]] = []
        self._lock = threading.Lock()

    # -- completion (flusher thread) ----------------------------------------
    def _finish(self):
        self.t_done = time.perf_counter()
        with self._lock:
            self._event.set()
            cbs, self._callbacks = self._callbacks, []
        for cb in cbs:
            cb(self)

    def set_result(self, value: Any):
        self._value = value
        self._finish()

    def set_exception(self, err: BaseException):
        self._error = err
        self._finish()

    # -- client side ---------------------------------------------------------
    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> Any:
        """Block until complete; raises the gateway-side error if any."""
        if not self._event.wait(timeout):
            raise TimeoutError(f"gateway {self.op} not done in {timeout}s")
        if self._error is not None:
            raise self._error
        return self._value

    def add_done_callback(self, fn: Callable[["RequestFuture"], None]):
        """Run ``fn(self)`` when complete (immediately if already done).
        Callbacks fire on the completing thread — keep them tiny."""
        with self._lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    # -- latency decomposition ------------------------------------------------
    @property
    def queue_latency_s(self) -> float:
        return max(self.t_dispatch - self.t_submit, 0.0)

    @property
    def service_latency_s(self) -> float:
        return max(self.t_done - self.t_dispatch, 0.0)

    @property
    def total_latency_s(self) -> float:
        return max(self.t_done - self.t_submit, 0.0)


class OpQueue:
    """Accumulation buffer for one op kind (gateway-locked; see module
    docstring). ``keys``/``vals`` double as (lo, hi) for range requests."""

    def __init__(self, kind: str):
        self.kind = kind
        self.futures: List[RequestFuture] = []
        self.keys: List[int] = []
        self.vals: List[int] = []

    def __len__(self) -> int:
        return len(self.futures)

    def append(self, fut: RequestFuture, key: int, val: int = 0):
        self.futures.append(fut)
        self.keys.append(int(key))
        self.vals.append(int(val))

    @property
    def oldest_t(self) -> Optional[float]:
        """Submit time of the head request (deadline-flush input)."""
        return self.futures[0].t_submit if self.futures else None

    def drain(
        self, max_n: int
    ) -> Tuple[List[RequestFuture], np.ndarray, np.ndarray]:
        """Pop the oldest ``max_n`` requests as (futures, keys, vals)."""
        n = min(len(self.futures), max_n)
        futs = self.futures[:n]
        keys = np.asarray(self.keys[:n], dtype=np.int64)
        vals = np.asarray(self.vals[:n], dtype=np.int64)
        del self.futures[:n], self.keys[:n], self.vals[:n]
        return futs, keys, vals
