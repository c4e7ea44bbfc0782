"""Batched serving engine with an UpLIF-backed prefix-cache index (port of
``repro/serve/engine.py``).

Second framework-level integration of the paper's technique: the serving
engine memoizes decode states for previously seen prompt prefixes. Prefix
fingerprints (a rolling hash of token prefixes) form a heavily updated
sparse key space — every admitted request inserts new fingerprints,
evictions delete them — the updatable-index workload UpLIF targets.
Lookups run batched once per admission wave; on CUDA they run the fused
locate (K1) and BMAT rank (K2) kernels, and the tuner's forecaster its
E-step (K3).

``ServeEngine`` decodes greedily over the port's LM substrate
(``repro_torch.models``: every family, with KV, MLA, ring, recurrent or
cross-attention caches), with two departures from the reference, both
about the stored caches (``ROADMAP.md`` §3):

- ``decode_step`` writes its cache's tensors in place, so the engine
  clones a cache when it admits it and when a hit takes it: no stored
  cache is ever a tensor that a decode writes to.
- A hit resumes at the matched prefix, ``n_blocks * every`` tokens, not
  at the stored prompt's full length, so a prompt that differs from the
  stored one after the last matched block decodes its own tokens (the
  reference decodes from the other prompt's cache there). Where the tail
  past the prefix is empty, the last matched token is decoded again for
  its logits. Where the stored prompt is exactly the matched prefix, the
  tokens are the reference's.

A KV or MLA cache is cut back to the prefix (``DecodeCache.clone``). A
recurrent state (RG-LRU, RWKV-6; and a ring that has wrapped) cannot be
cut, so for those families the prefill keeps a snapshot of the cache
before each block's last token, at lengths ``b * every - 1``, and stores
the snapshots in the slot; a hit on n blocks resumes from snapshot n and
decodes from token ``n * every - 1`` on. A hit's output is then the cold
run's, bit for bit, as for the cuttable caches. The snapshots a hit
takes over from another slot are shared (nothing writes to a snapshot:
a hit clones it before decoding).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.sharded import ShardedUpLIF
from repro_torch.core.uplif import UpLIFConfig
from repro_torch.kernels.ops import resolve_device
from repro_torch.models.transformer import (
    compute_params,
    decode_step,
    init_cache,
)
from repro_torch.serve.gateway import GatewayConfig, RequestGateway
from repro_torch.tuning import SelfTuner

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


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # int32 tokens
    max_new_tokens: int = 16
    out: Optional[List[int]] = None


class ServeEngine:
    """Greedy decode engine with the prefix-cache index, on ``device``
    (``cuda`` unless the caller passes another): the model, the caches and
    the index's router all live there.

    ``params`` is the stored parameter tree (``init_params`` or
    ``params_from_numpy``); the engine keeps ``compute_params`` of it as
    ``self.params``, so a leaf already in the compute dtype on ``device`` is
    shared, not copied."""

    _DEFAULT_TUNER = object()  # sentinel: "make one" vs an explicit None
    PREFIX_EVERY = 16          # tokens per fingerprinted prefix block

    def __init__(
        self,
        cfg,
        params,
        max_batch: int = 8,
        max_len: int = 512,
        tuner: Any = _DEFAULT_TUNER,
        async_maintenance: bool = True,
        max_concurrent_builds: int = 2,
        commit_replay_cap: Optional[int] = 4096,
        locate: str = "auto",
        device=None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = compute_params(params, cfg, self.device)
        self.max_batch = max_batch
        self.max_len = max_len
        if tuner is self._DEFAULT_TUNER:
            # self-tuning on unless explicitly disabled; the engine defaults
            # to the async pipeline so index rebuilds overlap decode waves —
            # pass async_maintenance=False to get the stalling sync builds.
            # max_concurrent_builds sizes the maintenance worker pool and
            # commit_replay_cap paces each commit's op-log rebase.
            tuner = (
                SelfTuner.overlapped(
                    max_concurrent_builds=max_concurrent_builds,
                    commit_replay_cap=commit_replay_cap,
                )
                if async_maintenance
                else SelfTuner()
            )
        self.prefix_index = PrefixCacheIndex(tuner=tuner, locate=locate,
                                             device=self.device)

    def open_gateway(
        self, config: Optional[GatewayConfig] = None
    ) -> RequestGateway:
        """Async ingestion front end over the engine's prefix index (see
        ``PrefixCacheIndex.open_gateway``)."""
        return self.prefix_index.open_gateway(config)

    def close(self):
        """Idempotent; safe concurrently with in-flight gateway flushes."""
        self.prefix_index.close()

    @property
    def keeps_snapshots(self) -> bool:
        """Whether a stored prompt keeps per-block snapshots (a cache
        with a recurrent state) instead of its cache (which a hit cuts
        back)."""
        return self.cfg.rglru is not None or self.cfg.rwkv is not None

    def _decode(self, tok, cache):
        return decode_step(self.params, self.cfg, tok, cache)

    def _tokens(self, prompt: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(prompt, np.int64),
                               device=self.device)[None, :]

    def _prefill(self, prompt: np.ndarray):
        """Run the prompt through decode steps to build a cache (simple
        token-at-a-time prefill, as the reference's)."""
        cache = init_cache(self.cfg, 1, self.max_len, device=self.device)
        toks = self._tokens(prompt)
        logits = None
        for i in range(toks.shape[1]):
            logits, cache = self._decode(toks[:, i:i + 1], cache)
        return logits, cache

    def generate(self, requests: List[Request]) -> List[Request]:
        """Serve a wave of requests (greedy decoding), reusing prefix caches."""
        every = self.PREFIX_EVERY
        for req in requests:
            if len(req.prompt) == 0:
                raise ValueError(f"request {req.rid} has an empty prompt")
            fps = prefix_fingerprints(req.prompt, every)
            sid, nblk = self.prefix_index.match(fps)
            snaps = [] if self.keeps_snapshots else None
            # match() only returns slots that are still resident
            if sid >= 0 and snaps is not None:
                # resume before the last matched token, from its snapshot
                snaps = self.prefix_index.slots[sid][:nblk]
                start = nblk * every - 1
                cache = snaps[-1].clone()
            elif sid >= 0:
                # resume at the matched prefix; an empty tail decodes the
                # last matched token again, for its logits
                start = min(nblk * every, len(req.prompt) - 1)
                cache = self.prefix_index.slots[sid].clone(start)
            else:
                start = 0
                cache = init_cache(self.cfg, 1, self.max_len,
                                   device=self.device)
            toks = self._tokens(req.prompt)
            for i in range(start, toks.shape[1]):
                if snaps is not None and len(snaps) < (i + 1) // every:
                    snaps.append(cache.clone())  # before token b*every-1
                logits, cache = self._decode(toks[:, i:i + 1], cache)
            # the stored copy is never a tensor that a decode writes to
            self.prefix_index.admit(
                fps, snaps if snaps is not None else cache.clone())
            out = []
            tok = torch.argmax(logits[:, -1:], dim=-1)
            for i in range(req.max_new_tokens):
                out.append(int(tok[0, 0]))
                if i + 1 < req.max_new_tokens:  # the last token needs no step
                    logits, cache = self._decode(tok, cache)
                    tok = torch.argmax(logits[:, -1:], dim=-1)
            req.out = out
        # background maintenance runs between waves, never inside one
        self.prefix_index.maintain()
        return requests
