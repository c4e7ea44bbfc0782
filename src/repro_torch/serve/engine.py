"""The serving engine's UpLIF-backed prefix-cache index (the non-LM part
of ``repro/serve/engine.py``).

The engine memoizes decode states for previously seen prompt prefixes.
Prefix fingerprints (a rolling hash of token prefixes) form a heavily
updated sparse key space — every admitted request inserts new
fingerprints, evictions delete them — the updatable-index workload UpLIF
targets. Lookups run batched once per admission wave.

``ServeEngine`` itself (continuous-batching decode over the LM substrate)
is not ported yet: it needs the port's models (``models/``), which come
with a later slice. ``PrefixCacheIndex`` and the gateway it opens work
without it.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.core.sharded import ShardedUpLIF
from repro_torch.core.uplif import UpLIFConfig
from repro_torch.serve.gateway import GatewayConfig, RequestGateway

_MASK = (1 << 52) - 1
_P = 1000003


def prefix_fingerprints(tokens: np.ndarray, every: int = 16) -> np.ndarray:
    """Rolling-hash fingerprints of prefixes at multiples of ``every``."""
    h = np.int64(1469598103)
    out = []
    for i, t in enumerate(tokens.tolist()):
        h = ((h * _P) ^ (t + 0x9E3779B9)) & _MASK
        if (i + 1) % every == 0:
            out.append(h)
    return np.asarray(out, dtype=np.int64)


class PrefixCacheIndex:
    """fingerprint -> cache-slot id, on a sharded UpLIF keyspace router.

    ``capacity_hint`` (expected number of live fingerprints) sizes the
    index: it picks the shard count of the router (one shard per ~2k
    fingerprints, capped at 8) and presizes each shard's delta buffer so
    the steady-state insert path never reallocates. Fingerprints are
    uniform 52-bit hashes, so evenly spaced bootstrap boundaries keep the
    shards balanced from the first admission on. The router runs on
    ``device`` (``cuda`` unless the caller passes ``device="cpu"``).
    """

    def __init__(
        self,
        capacity_hint: int = 4096,
        n_shards: Optional[int] = None,
        tuner=None,
        locate: str = "auto",
        device=None,
    ):
        self.capacity_hint = int(capacity_hint)
        if n_shards is None:
            n_shards = max(1, min(8, self.capacity_hint // 2048))
        # bootstrap keys spread over the fingerprint domain -> balanced
        # shard boundaries (vals -1 = "no slot", never matched)
        n_seed = max(8, 2 * n_shards)
        seed_keys = np.linspace(1, _MASK, n_seed).astype(np.int64)
        per_shard_buf = max(256, self.capacity_hint // max(n_shards, 1))
        # locate="auto" puts the match()/admit() hot path on the fused
        # locate and rank kernels when the router runs on CUDA
        self.index = ShardedUpLIF(
            seed_keys,
            np.full(n_seed, -1, dtype=np.int64),
            UpLIFConfig(
                batch_bucket=256, bmat_capacity=per_shard_buf, locate=locate
            ),
            n_shards=n_shards,
            device=device,
        )
        self.slots: Dict[int, Any] = {}
        self._next_slot = 0
        self.hits = 0
        self.misses = 0
        # online self-tuning hook: the tuner observes every fingerprint
        # insert and plans budgeted maintenance when maintain() is called
        # between waves. With an async tuner the build phase overlaps the
        # following serving waves and the rebuilt state lands at a later
        # maintain() (the wave-boundary commit point). Maintenance
        # preserves the fingerprint -> slot mapping either way, so match()
        # results never change — only latency/memory.
        self.tuner = tuner.attach(self.index) if tuner is not None else None
        self._wave_ops = 0
        self._wave_t0 = time.perf_counter()
        self._gateway: Optional[RequestGateway] = None
        self._closed = False
        self._close_lock = threading.Lock()

    def maintain(self):
        """End-of-wave hook: report measured wave throughput to the tuner,
        land any finished background builds, and let it plan the next
        maintenance step. No-op without a tuner."""
        if self.tuner is None:
            return None
        now = time.perf_counter()
        rec = self.tuner.after_wave(self._wave_ops, now - self._wave_t0)
        self._wave_ops = 0
        self._wave_t0 = time.perf_counter()
        return rec

    def open_gateway(
        self, config: Optional[GatewayConfig] = None
    ) -> RequestGateway:
        """Attach (or return the already-open) async request gateway over
        this index's router. The gateway's flusher becomes the router's
        single writer — don't interleave direct match()/admit() waves with
        live gateway traffic. The gateway shares the index's tuner, so
        admission-control pressure sheds the SAME maintenance budget."""
        with self._close_lock:
            if self._closed:
                raise RuntimeError("index is closed")
            if self._gateway is None or self._gateway.closed:
                self._gateway = RequestGateway(
                    self.index, tuner=self.tuner, config=config
                )
            return self._gateway

    def close(self):
        """Drain the gateway (if open), land in-flight builds, persist
        learned Q-tables, stop the executor thread.

        Idempotent AND safe to call concurrently — with other closers and
        with in-flight gateway flushes: the first caller drains everything
        exactly once while later/concurrent callers serialize behind it;
        every already-queued gateway future completes (or fails with
        ``GatewayClosed``), never hangs; submissions racing the close get
        ``GatewayClosed``."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
            if self._gateway is not None:
                # joins the flusher: after this, no thread touches the
                # tuner or the router, so the tuner teardown below is safe
                self._gateway.close()
                self._gateway = None
            if self.tuner is not None:
                self.tuner.close()

    def match(self, fps: np.ndarray) -> Tuple[int, int]:
        """Longest cached prefix whose slot is still resident: returns
        (slot_id, n_prefix_blocks) or (-1, 0). A matched-but-evicted slot
        is not a hit — the caller gets (and we count) exactly what it can
        actually reuse, so hits + misses stays consistent with evictions."""
        if len(fps) == 0:
            return -1, 0
        self._wave_ops += len(fps)
        found, slot = self.index.lookup(fps)
        valid = found & (slot >= 0)
        for i in reversed(np.nonzero(valid)[0]):
            sid = int(slot[i])
            if sid in self.slots:
                self.hits += 1
                return sid, int(i) + 1
        self.misses += 1
        return -1, 0

    def admit(self, fps: np.ndarray, state: Any) -> int:
        sid = self._next_slot
        self._next_slot += 1
        self.slots[sid] = state
        if len(fps):
            self._wave_ops += len(fps)
            self.index.insert(fps, np.full(len(fps), sid, dtype=np.int64))
            if self.tuner is not None:
                self.tuner.observe_inserts(fps)
        return sid

    def evict(self, sid: int, fps: np.ndarray):
        self.slots.pop(sid, None)
        if len(fps):
            self._wave_ops += len(fps)
            self.index.delete(fps)

    def memory_bytes(self) -> int:
        return self.index.index_bytes()
