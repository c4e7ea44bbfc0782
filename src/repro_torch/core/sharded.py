"""ShardedUpLIF — boundary-partitioned keyspace router (port of
``repro/core/sharded.py``).

Keys are range-partitioned into S shards at build-time quantile boundaries.
Because a shard's whole index is one ``UpLIFState``, the router stores all
S shards *stacked*: every leaf carries a leading shard axis. One batched
operation is padded once on the host, run through the flat stacked ops
(``fops.slookup`` / ``sinsert`` / ``sdelete``, which route each query on
the device from the S-1 boundaries and launch K1 and K2 once for all
shards) and returned in batch order.

Host-side tuning actions (retrains, splits, merges) unstack a shard into a
regular ``UpLIF`` shell, run the shell's host machinery, and restack with
re-padded common shapes. Shapes are padded to powers of two, monotone
across restacks, and the padding obeys the fill-forward invariants so the
padded tails are inert.

State is **versioned**: an epoch counter orders structural revisions and
each revision records the key interval it touched. ``snapshot(shards=...)``
freezes an immutable view for a build and opens a per-interval op-log;
``commit(delta, replay_cap=...)`` validates the interval, replays the
logged ops into the rebuilt shells (parking in a draining state while the
log is longer than ``replay_cap``) and swaps the rows in. No operation
writes into a state tensor in place (each op and each row write builds new
tensors), so holding a reference to ``state`` is the freeze. Mutations are
single-writer; readers on other threads grab (state, boundaries, codes,
static) as one view under the swap lock.

Range scans run per shard (``_vrange``: each shard's row of the stacked
state under its own locate strategy) and concatenate in shard order, which
is key order. ``apply_wave`` applies one ``MixedWave`` (the gateway's
dispatch unit) in the canonical order inserts, deletes, lookups, ranges.

The router runs on ``cuda`` unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import fops
from repro_torch.core.bmat import BPMAT, RBMAT, _make_fences, bmat_height
from repro_torch.core.gmm import gmm_memory_bytes
from repro_torch.core.shapes import bucket_width, grow_capacity, pow2_at_least
from repro_torch.core.state import UpLIFState, UpLIFStatic, resolve_locate
from repro_torch.core.types import BMATState, GMMState, KEY_MAX, SlotsState
from repro_torch.core.uplif import UpLIF, UpLIFConfig
from repro_torch.kernels.ops import native_kernels, resolve_device


def _stack(states: Sequence[UpLIFState]) -> UpLIFState:
    """Leaf-wise stack of equally shaped states along a new shard axis."""
    def stack(kind, parts):
        return kind(*(torch.stack(xs) for xs in zip(*parts)))

    return UpLIFState(
        slots=stack(SlotsState, [s.slots for s in states]),
        model=stack(type(states[0].model), [s.model for s in states]),
        bmat=stack(BMATState, [s.bmat for s in states]),
        counters=stack(type(states[0].counters),
                       [s.counters for s in states]),
    )


def _row(state: UpLIFState, s: int) -> UpLIFState:
    """Shard ``s`` of a stacked state (views, no copy)."""
    return UpLIFState(*(type(part)(*(x[s] for x in part)) for part in state))


def _vrange(state: UpLIFState, lo, hi, *, statics, max_out: int):
    """Per-shard range scans: shard ``s`` scans its own row of the stacked
    state (views) for the queries ``lo[s]``/``hi[s]`` under its own
    ``statics[s]`` (the per-shard locate strategy; the results are
    byte-identical across strategies). Returns one ``RangeResult`` with a
    leading shard axis."""
    outs = [
        fops.range_scan(_row(state, s), lo[s], hi[s], static=statics[s],
                        max_out=max_out)
        for s in range(len(statics))
    ]
    return fops.RangeResult(*(torch.stack(xs) for xs in zip(*outs)))


@dataclasses.dataclass
class _ShardMeta:
    """Host-side per-shard metadata that cannot live in the stacked state."""

    rs_static: object
    gmm: GMMState
    alpha: float
    reservoir: np.ndarray


# --------------------------------------------------------------------------
# Versioned state: plan/build/commit support.
#
# ``RouterSnapshot`` freezes what a build needs: the stacked state, a copy of
# the boundaries and of the per-shard host metadata. ``StateDelta`` is the
# build's output — rebuilt shard shell(s) plus the key interval they own —
# and ``ShardedUpLIF.commit`` applies it against the live router.
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RouterSnapshot:
    """Immutable view of a router at one epoch; builds read only this.

    ``build_id`` names the per-interval op-log ``snapshot()`` opened for
    this build; ``key_lo``/``key_hi`` bound the keyspace the build owns."""

    epoch: int
    state: UpLIFState
    boundaries: np.ndarray
    meta: Tuple[_ShardMeta, ...]
    n_shards: int
    cfg: UpLIFConfig
    bmat_kind: str
    rs_iters: int
    device: torch.device
    build_id: int = -1
    key_lo: int = 0
    key_hi: int = int(KEY_MAX)

    def shell(self, s: int) -> UpLIF:
        """Shard ``s`` of the snapshot as a host UpLIF shell. The shell
        shares the snapshot's tensors; its ops build new ones, so the live
        router is never touched."""
        return _shell_from(self.state, self.meta[s], self.cfg, self.bmat_kind,
                           s, self.device)

    def shard_bounds(self, s: int) -> Tuple[int, int]:
        """Key interval [lo, hi) owned by shard ``s`` under this snapshot."""
        lo = int(self.boundaries[s - 1]) if s > 0 else 0
        hi = (int(self.boundaries[s]) if s < self.n_shards - 1
              else int(KEY_MAX))
        return lo, hi


@dataclasses.dataclass
class StateDelta:
    """Result of one build, ready for ``commit``.

    ``kind`` is "retrain" (shells = [rebuilt shard]), "split" (shells =
    [left, right], ``boundary`` = the new cut) or "merge" (shells =
    [merged]; covers shards ``shard`` and ``shard + 1``). ``key_lo`` and
    ``key_hi`` bound the keyspace the shells own."""

    epoch: int
    kind: str
    shard: int
    key_lo: int
    key_hi: int
    shells: Tuple[UpLIF, ...]
    boundary: Optional[int] = None
    build_seconds: float = 0.0
    build_id: int = -1


@dataclasses.dataclass
class _BuildLog:
    """One in-flight build's rebase log: the insert/delete batches that
    routed into its key interval since the snapshot. ``pos`` is the replay
    cursor; replayed entries are freed (set to None)."""

    build_id: int
    epoch: int                 # snapshot epoch (revision-ordinal floor)
    key_lo: int
    key_hi: int
    log: List[Optional[Tuple[str, np.ndarray, Optional[np.ndarray]]]] = (
        dataclasses.field(default_factory=list)
    )
    pos: int = 0

    @property
    def backlog_ops(self) -> int:
        return sum(len(k) for _, k, _ in self.log[self.pos:])


def intervals_overlap(lo: int, hi: int, b_lo: int, b_hi: int) -> bool:
    """Half-open [lo, hi) ∩ [b_lo, b_hi) ≠ ∅ — the one overlap predicate of
    snapshot admission, revision validation and the scheduler."""
    return b_lo < hi and lo < b_hi


@dataclasses.dataclass
class _DrainingCommit:
    """An accepted commit whose replay is paced across waves: the rebuilt
    ``shells`` absorb the interval's logged ops batch by batch (``cuts``
    are the interval edges each shell owns) while the old rows keep
    serving; they swap in when the residual log is empty."""

    delta: StateDelta
    shells: Tuple[UpLIF, ...]
    cuts: Tuple[int, ...]


@dataclasses.dataclass
class MixedWave:
    """One mixed-op request wave, ready for ``ShardedUpLIF.apply_wave``.

    The gateway's dispatch unit: each op kind carries its own batch and an
    optional pad width (``pad_*``, a power of two from
    ``core/shapes.padded_width``). Given a pad width, the router pads to
    exactly that width instead of the bulk ``bucket_width`` family, so a
    live stream with no repeating batch sizes lands on a small set of
    widths. ``None`` fields and empty arrays skip that op kind."""

    lookup_keys: Optional[np.ndarray] = None
    insert_keys: Optional[np.ndarray] = None
    insert_vals: Optional[np.ndarray] = None
    delete_keys: Optional[np.ndarray] = None
    range_lo: Optional[np.ndarray] = None
    range_hi: Optional[np.ndarray] = None
    pad_lookup: Optional[int] = None
    pad_insert: Optional[int] = None
    pad_delete: Optional[int] = None
    range_max_out: int = 256

    @property
    def n_ops(self) -> int:
        return sum(
            len(a)
            for a in (self.lookup_keys, self.insert_keys, self.delete_keys,
                      self.range_lo)
            if a is not None
        )


@dataclasses.dataclass
class MixedWaveResult:
    """Batch-ordered results of one ``apply_wave`` dispatch."""

    lookup_found: Optional[np.ndarray] = None
    lookup_vals: Optional[np.ndarray] = None
    delete_hit: Optional[np.ndarray] = None
    n_overflow: int = 0
    range_keys: Optional[List[np.ndarray]] = None
    range_vals: Optional[List[np.ndarray]] = None


def _shell_from(
    state: UpLIFState, meta: _ShardMeta, cfg: UpLIFConfig, bmat_kind: str,
    s: int, device,
) -> UpLIF:
    """Shard ``s`` of a stacked state as a regular UpLIF shell on
    ``device`` (views of the stacked tensors, no copy)."""
    sh = UpLIF.from_state(
        _row(state, s), rs_static=meta.rs_static, gmm=meta.gmm,
        alpha=meta.alpha, config=cfg, device=device,
    )
    sh.bmat.tree_type = bmat_kind
    sh._reservoir = meta.reservoir
    sh._rng = np.random.default_rng(s)
    return sh


def retrain_shell_fitted(
    shell: UpLIF, cap_now: int, gmm: Optional[GMMState] = None
):
    """Capacity-fitted full retrain of one shard shell: the Eq. 7 gap budget
    α is solved from the slot capacity the stacked state already has
    (floored at 0.05) so the rebuilt shard reuses the stacked shapes. Shared
    by the live ``retrain_shard`` and the build (tuning/executor.py), which
    must produce identical layouts."""
    n_live = int(shell.size)
    slack = max(64, shell.cfg.window) + shell.cfg.window
    # 5% safety for round-mode quantization jitter in the gap counts
    alpha_fit = (cap_now - slack) / max(n_live, 1) - 1.05
    alpha = min(shell.cfg.alpha_target, max(alpha_fit, 0.05))
    shell.retrain_full(gmm, alpha_target=alpha, gap_quantize="round")


def split_point(keys: np.ndarray) -> Optional[int]:
    """Live-key index a shard splits at, or None when the split is
    degenerate (fewer than 2 live keys, or the median equals the first key).
    The one definition the live ``split_shard`` and the build consult."""
    mid = len(keys) // 2
    if mid == 0 or keys[mid] == keys[0]:
        return None
    return mid


def split_shells(
    shell: UpLIF, keys: np.ndarray, vals: np.ndarray, mid: int,
    cfg: UpLIFConfig,
) -> Tuple[UpLIF, UpLIF]:
    """Two fresh shells for a shard split at live-key index ``mid``; the
    D_update reservoir partitions at the cut."""
    cut = int(keys[mid])
    left = UpLIF(keys[:mid], vals[:mid], cfg, gmm=shell.gmm,
                 device=shell.device)
    right = UpLIF(keys[mid:], vals[mid:], cfg, gmm=shell.gmm,
                  device=shell.device)
    res = shell._reservoir
    left._reservoir = res[res < cut]
    right._reservoir = res[res >= cut]
    return left, right


def merge_shells(
    sh1: UpLIF, sh2: UpLIF, keys: np.ndarray, vals: np.ndarray,
    cfg: UpLIFConfig, rng: np.random.Generator,
) -> UpLIF:
    """One fresh shell covering two adjacent shards' live entries."""
    merged = UpLIF(keys, vals, cfg, gmm=sh1.gmm, device=sh1.device)
    res = np.concatenate([sh1._reservoir, sh2._reservoir])
    if len(res) > cfg.reservoir:
        res = rng.choice(res, cfg.reservoir, replace=False)
    merged._reservoir = res
    return merged


class ShardedUpLIF:
    """Keyspace router over S UpLIF shards stored as one stacked state."""

    def __init__(
        self,
        keys: np.ndarray,
        vals: Optional[np.ndarray] = None,
        config: UpLIFConfig = UpLIFConfig(),
        n_shards: int = 4,
        gmm: Optional[GMMState] = None,
        device=None,
    ):
        device = resolve_device(device)
        keys = np.asarray(keys, dtype=np.int64)
        order = np.argsort(keys)
        keys = keys[order]
        if vals is None:
            vals = keys.copy()
        else:
            vals = np.asarray(vals, dtype=np.int64)[order]
        uk, ui = np.unique(keys, return_index=True)
        keys, vals = uk, vals[ui]
        if len(keys) == 0:
            raise ValueError("the sharded router needs a non-empty bootstrap")

        n_shards = max(1, min(int(n_shards), len(keys)))
        # the delta-buffer budget is per index, not per shard
        cfg = dataclasses.replace(
            config, bmat_capacity=max(256, config.bmat_capacity // n_shards),
        )
        # equal-count split points; boundaries[i] = first key of shard i+1
        cuts = [round(i * len(keys) / n_shards) for i in range(1, n_shards)]
        boundaries = (keys[np.asarray(cuts, dtype=np.int64)] if cuts
                      else np.zeros(0, dtype=np.int64))
        bounds = [0] + [int(c) for c in cuts] + [len(keys)]
        shells = [
            UpLIF(keys[a:b], vals[a:b], cfg, gmm=gmm, device=device)
            for a, b in zip(bounds[:-1], bounds[1:])
        ]
        locate = resolve_locate(cfg.locate, native_kernels(device))
        self._init_router(cfg, boundaries, cfg.bmat_type,
                          [locate] * n_shards, device)
        self._restack(shells)

    @classmethod
    def from_state(
        cls, state: UpLIFState, *, boundaries: np.ndarray,
        meta: Sequence[_ShardMeta], config: UpLIFConfig, bmat_kind: str,
        rs_iters: int, locate_per_shard: Sequence[str], device,
    ) -> "ShardedUpLIF":
        """A router around an existing stacked state (``core/convert.py``).
        ``config`` is the router's own (per-shard BMAT budget)."""
        self = cls.__new__(cls)
        self._init_router(config, np.asarray(boundaries, dtype=np.int64),
                          bmat_kind, list(locate_per_shard),
                          resolve_device(device))
        self.state = state
        self.rs_iters = int(rs_iters)
        self._meta = list(meta)
        return self

    def _init_router(self, cfg, boundaries, bmat_kind, locate_per_shard,
                     device):
        self.cfg = cfg
        self.device = device
        self.n_shards = len(boundaries) + 1
        self.bmat_kind = bmat_kind
        self.n_lookups = 0
        self.n_retrains = 0
        self.n_splits = 0
        self.n_merges = 0
        self._rng = np.random.default_rng(0)
        # -- versioned state (plan/build/commit) ---------------------------
        # epoch orders structural revisions; each revision records the key
        # interval it touched, so a build conflicts only with revisions
        # that intersect its interval. Each in-flight build owns a
        # per-interval op-log of the inserts/deletes routed into its
        # keyspace. The lock guards the reference swaps and the readers'
        # reference grabs.
        self.epoch = 0
        self.n_commits = 0
        self.n_discards = 0
        self.n_replayed_ops = 0
        self._lock = threading.RLock()
        self._logs: Dict[int, _BuildLog] = {}
        self._drains: Dict[int, _DrainingCommit] = {}
        self._revisions: List[Tuple[int, int, int]] = []  # (ordinal, lo, hi)
        self._next_build_id = 0
        # -- per-shard locate-strategy axis ---------------------------------
        self._locate_per_shard: List[str] = list(locate_per_shard)
        self._locate_obs: List[Tuple[np.ndarray, float, Tuple[str, ...]]] = []
        self._set_boundaries(boundaries)
        self._set_locate_axis()

    def _set_boundaries(self, boundaries: np.ndarray):
        self.boundaries = boundaries
        self._tbounds = torch.tensor(boundaries, dtype=torch.int64,
                                     device=self.device)

    # -- stacking ------------------------------------------------------------
    def _restack(self, shells: List[UpLIF]):
        """Pad every shard's state to common shapes and stack leaf-wise.

        Shapes are powers of two and monotone across restacks (they grow
        geometrically, never shrink). Padding is inert by the fill-forward
        invariants, so the only cost is bounded (< 2x) slack."""
        W = self.cfg.window
        has_state = hasattr(self, "state")
        prev_cap = self.state.slots.keys.shape[1] if has_state else 0
        prev_bcap = self.state.bmat.keys.shape[1] if has_state else 0
        prev_knots = self.state.model.spline_keys.shape[1] if has_state else 0
        cap = max(pow2_at_least(max(sh.capacity for sh in shells)),
                  prev_cap, W)
        bcap = max(pow2_at_least(max(sh.bmat.capacity for sh in shells)),
                   prev_bcap)
        # knot arrays grow with 4x headroom (floor 512) so shard growth
        # between retrains keeps the stacked shape
        knots_need = pow2_at_least(
            max(int(sh.rs_model.spline_keys.shape[0]) for sh in shells)
        )
        n_knots = (prev_knots if knots_need <= prev_knots
                   else max(4 * knots_need, 512))
        state = _stack([self._pad_shell(sh, cap, bcap, n_knots)
                        for sh in shells])
        meta = [self._meta_of(sh) for sh in shells]
        with self._lock:
            self.state = state
            self.rs_iters = max(
                max(sh.rs_static.n_search_iters for sh in shells),
                getattr(self, "rs_iters", 0),
            )
            self._meta = meta

    @staticmethod
    def _meta_of(sh: UpLIF) -> _ShardMeta:
        return _ShardMeta(rs_static=sh.rs_static, gmm=sh.gmm, alpha=sh.alpha,
                          reservoir=sh._reservoir)

    def _pad_shell(
        self, sh: UpLIF, cap: int, bcap: int, n_knots: int
    ) -> UpLIFState:
        """One shard's state padded to the given common stacked shapes."""
        st = sh.fstate

        def pad(x, n, fill):
            return torch.cat([x, x.new_full((n - x.shape[0],), fill)])

        def pad_edge(x, n):
            return torch.cat([x, x[-1:].expand(n - x.shape[0])])

        slots = SlotsState(
            keys=pad(st.slots.keys, cap, KEY_MAX),
            vals=pad(st.slots.vals, cap, 0),
            occ=pad(st.slots.occ, cap, False),
        )
        # repeat the last knot: interpolation degenerates to the knot value,
        # which is exactly the clamped extrapolation
        model = st.model._replace(
            spline_keys=pad_edge(st.model.spline_keys, n_knots),
            spline_pos=pad_edge(st.model.spline_pos, n_knots),
        )
        bkeys = pad(st.bmat.keys, bcap, KEY_MAX)
        bmat = BMATState(
            keys=bkeys,
            vals=pad(st.bmat.vals, bcap, 0),
            fences=_make_fences(bkeys, self.cfg.bmat_fanout),
            size=st.bmat.size,
        )
        return UpLIFState(slots=slots, model=model, bmat=bmat,
                          counters=st.counters)

    def _write_shard(self, s: int, sh: UpLIF) -> bool:
        """Single-shard maintenance fast path: when the rebuilt shard fits
        the current stacked shapes, write its padded row into a copy of the
        stacked state instead of restacking all S shards. Returns False
        when a dimension outgrew the stack and the caller must restack."""
        cap = int(self.state.slots.keys.shape[1])
        bcap = int(self.state.bmat.keys.shape[1])
        n_knots = int(self.state.model.spline_keys.shape[1])
        fits = (
            sh.capacity <= cap
            and sh.bmat.capacity <= bcap
            and int(sh.rs_model.spline_keys.shape[0]) <= n_knots
            and sh.rs_static.n_search_iters <= self.rs_iters
        )
        if not fits:
            return False
        row = self._pad_shell(sh, cap, bcap, n_knots)

        def put(stacked, r):
            out = stacked.clone()
            out[s] = r
            return out

        state = UpLIFState(*(
            type(part)(*(put(x, r) for x, r in zip(part, rpart)))
            for part, rpart in zip(self.state, row)
        ))
        with self._lock:
            self.state = state
            self._meta[s] = self._meta_of(sh)
        return True

    def _unstack_shell(self, s: int) -> UpLIF:
        """Shard ``s`` as a regular UpLIF shell (views, no copy)."""
        return _shell_from(self.state, self._meta[s], self.cfg,
                           self.bmat_kind, s, self.device)

    # -- per-shard locate dispatch ---------------------------------------------
    def _set_locate_axis(self):
        """Refresh the dispatch form of ``_locate_per_shard``:
        ``_locate_value`` is the single strategy when the assignment is
        uniform, else the sorted tuple of distinct strategies in play, and
        ``_codes`` the per-shard int32 indices into it (None when uniform).
        Callers mutate ``_locate_per_shard`` under the lock."""
        distinct = sorted(set(self._locate_per_shard))
        if len(distinct) == 1:
            self._locate_value = distinct[0]
            self._codes = None
        else:
            self._locate_value = tuple(distinct)
            pos = {strat: i for i, strat in enumerate(distinct)}
            self._codes = torch.tensor(
                [pos[s] for s in self._locate_per_shard], dtype=torch.int32,
                device=self.device,
            )

    def set_shard_locate(self, s: int, strategy: str) -> bool:
        """Pin shard ``s``'s locate strategy (the controller's switch-locate
        action). Metadata-only: the strategies are byte-identical in what a
        query returns, so this records no revision. Returns True when the
        assignment changed."""
        if not 0 <= s < self.n_shards:
            raise IndexError(f"shard {s} out of range")
        strategy = resolve_locate(strategy, native_kernels(self.device))
        with self._lock:
            if self._locate_per_shard[s] == strategy:
                return False
            self._locate_per_shard[s] = strategy
            self._set_locate_axis()
        return True

    def shard_locate(self) -> Tuple[str, ...]:
        """Current per-shard strategy assignment."""
        with self._lock:
            return tuple(self._locate_per_shard)

    def drain_locate_obs(
        self,
    ) -> List[Tuple[np.ndarray, float, Tuple[str, ...]]]:
        """Hand the accumulated (per-shard query counts, wall seconds,
        strategy assignment) lookup observations to telemetry and reset."""
        with self._lock:
            obs, self._locate_obs = self._locate_obs, []
        return obs

    def _static(self) -> UpLIFStatic:
        return UpLIFStatic(
            window=self.cfg.window,
            movement_k=self.cfg.movement_k,
            rs_iters=self.rs_iters,
            insert_rounds=self.cfg.insert_rounds,
            fanout=self.cfg.bmat_fanout,
            bmat_kind=self.bmat_kind,
            locate=self._locate_value,
        )

    def _read_view(self):
        """One consistent (state, boundaries, device boundaries, codes,
        static) view, grabbed under the swap lock, so a lookup issued
        mid-commit runs entirely against the old or the new state."""
        with self._lock:
            return (self.state, self.boundaries, self._tbounds, self._codes,
                    self._static())

    # -- routing ---------------------------------------------------------------
    def _route(self, keys: np.ndarray) -> np.ndarray:
        """Shard id per key: shard s owns [boundaries[s-1], boundaries[s])."""
        return np.searchsorted(self.boundaries, keys, side="right")

    def _observe_updates(self, keys: np.ndarray):
        """Feed each shard's D_update reservoir (Phase 2)."""
        cap = self.cfg.reservoir
        take = (keys if len(keys) <= cap
                else self._rng.choice(keys, cap, replace=False))
        sid = self._route(take)
        for s in range(self.n_shards):
            sub = take[sid == s]
            if len(sub) == 0:
                continue
            m = self._meta[s]
            res = np.concatenate([m.reservoir, sub])
            if len(res) > cap:
                res = self._rng.choice(res, cap, replace=False)
            m.reservoir = res

    def _pad_route(self, keys: np.ndarray, *aux, width: Optional[int] = None):
        """Pad the batch to a bucketed width — one batch for all shards (the
        stacked ops route each query on the device) — and move it and
        ``aux`` (zero-padded) to the device. ``width`` replaces the bucket
        (a ``MixedWave``'s power-of-two pad width)."""
        n = len(keys)
        B = (bucket_width(max(n, 1), self.cfg.batch_bucket) if width is None
             else int(width))
        if B < n:
            raise ValueError(f"pad width {B} below batch size {n}")
        q = np.full(B, KEY_MAX, dtype=np.int64)
        q[:n] = keys
        outs = []
        for a in aux:
            m = np.zeros(B, dtype=np.int64)
            m[:n] = a
            outs.append(torch.tensor(m, device=self.device))
        return torch.tensor(q, device=self.device), n, *outs

    # -- queries ---------------------------------------------------------------
    def lookup(
        self, queries: np.ndarray, pad_to: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched point lookup -> (found bool[n], values int64[n])."""
        queries = np.asarray(queries, dtype=np.int64)
        q, n = self._pad_route(queries, width=pad_to)
        state, boundaries, tb, codes, static = self._read_view()
        t0 = time.perf_counter()
        f, v = fops.slookup(state, q, tb, codes, static=static)
        f, v = f.cpu().numpy(), v.cpu().numpy()  # the sync ends the timing
        dt = time.perf_counter() - t0
        self.n_lookups += n
        if n:
            # per-shard latency attribution for the locate-strategy
            # controller: one searchsorted + bincount per dispatch
            counts = np.bincount(
                np.searchsorted(boundaries, queries[:n], side="right"),
                minlength=len(boundaries) + 1,
            )
            with self._lock:
                if len(self._locate_obs) < 1024:  # bounded between drains
                    self._locate_obs.append(
                        (counts, dt, tuple(self._locate_per_shard))
                    )
        return f[:n], v[:n]

    def _log_op(
        self, kind: str, keys: np.ndarray, vals: Optional[np.ndarray]
    ):
        """Record one op batch against every in-flight build whose key
        interval it intersects."""
        for bl in self._logs.values():
            m = (keys >= bl.key_lo) & (keys < bl.key_hi)
            if not m.any():
                continue
            bl.log.append((kind, keys[m], vals[m] if vals is not None else None))

    def insert(
        self,
        keys: np.ndarray,
        vals: Optional[np.ndarray] = None,
        pad_to: Optional[int] = None,
    ) -> int:
        """Batched upsert. Returns the count that went to the BMATs."""
        keys = np.asarray(keys, dtype=np.int64)
        if vals is None:
            vals = keys.copy()
        vals = np.asarray(vals, dtype=np.int64)
        if keys.shape != vals.shape:
            raise ValueError("keys and vals must have the same shape")
        if len(keys) == 0:
            return 0
        if self._logs:
            self._log_op("insert", keys, vals)
        self._observe_updates(keys)
        q, n, vm = self._pad_route(keys, vals, width=pad_to)
        self._ensure_bmat_capacity(int(q.shape[0]))
        state, res = fops.sinsert(self.state, q, vm, self._tbounds,
                                  self._codes, static=self._static())
        with self._lock:
            self.state = state
        return int(res.n_overflow)

    def delete(
        self, keys: np.ndarray, pad_to: Optional[int] = None
    ) -> np.ndarray:
        """Batched delete (tombstones). Returns hits."""
        keys = np.asarray(keys, dtype=np.int64)
        if self._logs:
            self._log_op("delete", keys, None)
        q, n = self._pad_route(keys, width=pad_to)
        state, hit = fops.sdelete(self.state, q, self._tbounds, self._codes,
                                  static=self._static())
        with self._lock:
            self.state = state
        return hit.cpu().numpy()[:n]

    def range_query(self, lo: int, hi: int, max_out: int = 1024):
        """Sorted (keys, vals) with lo <= key <= hi, at most ``max_out``."""
        ks, vs = self.range_query_batch(
            np.asarray([lo], dtype=np.int64),
            np.asarray([hi], dtype=np.int64),
            max_out,
        )
        return ks[0], vs[0]

    def range_query_batch(
        self, lo: np.ndarray, hi: np.ndarray, max_out: int = 1024
    ):
        """A range may span several shards: every shard answers the queries
        that intersect its key interval (``_vrange``), and the per-shard
        slices concatenate in shard order, which is key order because the
        partition is a range partition."""
        lo = np.asarray(lo, dtype=np.int64)
        hi = np.asarray(hi, dtype=np.int64)
        n = len(lo)
        with self._lock:
            state, boundaries = self.state, self.boundaries
            static = self._static()
            per_shard = tuple(self._locate_per_shard)
        n_shards = len(boundaries) + 1
        statics = tuple(static._replace(locate=per_shard[s])
                        for s in range(n_shards))
        edges = np.concatenate([[0], boundaries, [KEY_MAX]])
        picks = [
            np.nonzero((hi >= edges[s]) & (lo < edges[s + 1]))[0]
            for s in range(n_shards)
        ]
        B = bucket_width(max(max((len(p) for p in picks), default=1), 1),
                         self.cfg.batch_bucket)
        lo_m = np.full((n_shards, B), KEY_MAX, dtype=np.int64)
        hi_m = np.zeros((n_shards, B), dtype=np.int64)
        for s, p in enumerate(picks):
            lo_m[s, :len(p)] = lo[p]
            hi_m[s, :len(p)] = hi[p]
        res = _vrange(state, torch.tensor(lo_m, device=self.device),
                      torch.tensor(hi_m, device=self.device),
                      statics=statics, max_out=max_out)
        ks = res.keys.cpu().numpy()
        vs = res.vals.cpu().numpy()
        cn = res.count.cpu().numpy()
        parts_k: List[List[np.ndarray]] = [[] for _ in range(n)]
        parts_v: List[List[np.ndarray]] = [[] for _ in range(n)]
        for s, p in enumerate(picks):
            for row, qi in enumerate(p):
                c = cn[s, row]
                parts_k[qi].append(ks[s, row, :c])
                parts_v[qi].append(vs[s, row, :c])
        out_k, out_v = [], []
        for i in range(n):
            if parts_k[i]:
                out_k.append(np.concatenate(parts_k[i])[:max_out])
                out_v.append(np.concatenate(parts_v[i])[:max_out])
            else:
                out_k.append(np.zeros(0, dtype=np.int64))
                out_v.append(np.zeros(0, dtype=np.int64))
        return out_k, out_v

    def apply_wave(self, wave: MixedWave) -> MixedWaveResult:
        """Dispatch one mixed-op wave (the gateway's flush unit).

        Op kinds run in the canonical wave order inserts -> deletes ->
        lookups -> ranges: writes land before reads, so a write of this
        wave or of any earlier one is visible to the wave's reads
        (read-your-writes). Each op kind is one dispatch at its ``pad_*``
        width; empty kinds cost nothing."""
        res = MixedWaveResult()
        if wave.insert_keys is not None and len(wave.insert_keys):
            res.n_overflow = self.insert(
                wave.insert_keys, wave.insert_vals, pad_to=wave.pad_insert
            )
        if wave.delete_keys is not None and len(wave.delete_keys):
            res.delete_hit = self.delete(
                wave.delete_keys, pad_to=wave.pad_delete
            )
        if wave.lookup_keys is not None and len(wave.lookup_keys):
            res.lookup_found, res.lookup_vals = self.lookup(
                wave.lookup_keys, pad_to=wave.pad_lookup
            )
        if wave.range_lo is not None and len(wave.range_lo):
            res.range_keys, res.range_vals = self.range_query_batch(
                wave.range_lo, wave.range_hi, max_out=wave.range_max_out
            )
        return res

    def adjusted_predict(self, queries: np.ndarray) -> np.ndarray:
        """Global logical rank = shard-local rank + total entries in the
        shards left of the owning shard."""
        queries = np.asarray(queries, dtype=np.int64)
        state, boundaries, tb, codes, static = self._read_view()
        # a preceding shard contributes its live in-place keys plus its
        # whole BMAT entry count: the bias r(k) counts tombstones too, as
        # the single-shard BMAT rank does
        sizes = (state.counters.n_keys.cpu().numpy()
                 + state.bmat.size.cpu().numpy().astype(np.int64))
        base = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        q, n = self._pad_route(queries)
        rank = fops.srank(state, q, tb, codes, static=static).cpu().numpy()
        sid = np.searchsorted(boundaries, queries, side="right")
        return rank[:n] + base[sid]

    # -- capacity management ---------------------------------------------------
    def _grow_bmat(self, new_cap: int):
        """Grow every shard's BMAT to ``new_cap`` slots (KEY_MAX padding)."""
        b = self.state.bmat
        S, bcap = b.keys.shape
        keys = torch.cat([b.keys, b.keys.new_full((S, new_cap - bcap),
                                                  KEY_MAX)], dim=1)
        vals = torch.cat([b.vals, b.vals.new_zeros((S, new_cap - bcap))],
                         dim=1)
        fences = fops._make_fences_stacked(keys, self.cfg.bmat_fanout)
        with self._lock:
            self.state = self.state._replace(bmat=BMATState(
                keys=keys, vals=vals, fences=fences, size=b.size,
            ))

    def _ensure_bmat_capacity(self, incoming: int):
        need = int(self.state.bmat.size.max()) + incoming
        if need <= int(self.state.bmat.keys.shape[1]) - 1:
            return
        self._grow_bmat(grow_capacity(need))

    # -- versioned-state protocol (plan/build/commit) --------------------------
    def _shard_interval(self, s_first: int, s_last: int = -1) -> Tuple[int, int]:
        """Key interval [lo, hi) owned by the contiguous shard run
        ``s_first .. s_last`` under the current boundaries."""
        if s_last < 0:
            s_last = s_first
        lo = 0 if s_first == 0 else int(self.boundaries[s_first - 1])
        hi = (int(KEY_MAX) if s_last >= self.n_shards - 1
              else int(self.boundaries[s_last]))
        return lo, hi

    def _record_revision(self, lo: int, hi: int):
        """Mark a structural revision over [lo, hi): builds whose interval
        intersects it can no longer commit."""
        self._revisions.append((self.epoch, int(lo), int(hi)))
        self.epoch += 1
        self._prune_revisions()

    def _prune_revisions(self):
        """Drop revisions no active build could still conflict with."""
        if not self._logs:
            self._revisions.clear()
            return
        floor = min(bl.epoch for bl in self._logs.values())
        self._revisions = [r for r in self._revisions if r[0] >= floor]

    def _conflicts(self, epoch: int, lo: int, hi: int) -> bool:
        return any(
            e >= epoch and intervals_overlap(lo, hi, r_lo, r_hi)
            for e, r_lo, r_hi in self._revisions
        )

    def active_intervals(self) -> List[Tuple[int, int]]:
        """Key intervals owned by in-flight builds and draining commits."""
        return [(bl.key_lo, bl.key_hi) for bl in self._logs.values()]

    def snapshot(
        self, shards: Optional[Sequence[int]] = None
    ) -> RouterSnapshot:
        """Freeze the current state for a build of the given contiguous
        shard run (default: the whole router) and open its per-interval
        op-log. An overlapping snapshot is a caller error."""
        if shards is None:
            shards = range(self.n_shards)
        shards = sorted(int(s) for s in shards)
        if not shards or shards[0] < 0 or shards[-1] >= self.n_shards:
            raise ValueError(f"shards out of range: {shards}")
        if shards != list(range(shards[0], shards[-1] + 1)):
            raise ValueError(f"shards must be contiguous: {shards}")
        lo, hi = self._shard_interval(shards[0], shards[-1])
        for b_lo, b_hi in self.active_intervals():
            if intervals_overlap(lo, hi, b_lo, b_hi):
                raise RuntimeError(
                    "a build is already in flight for an overlapping key "
                    f"interval [{b_lo}, {b_hi})"
                )
        with self._lock:
            self._next_build_id += 1
            bid = self._next_build_id
            self._logs[bid] = _BuildLog(build_id=bid, epoch=self.epoch,
                                        key_lo=lo, key_hi=hi)
            return RouterSnapshot(
                epoch=self.epoch,
                state=self.state,
                boundaries=self.boundaries.copy(),
                meta=tuple(dataclasses.replace(m) for m in self._meta),
                n_shards=self.n_shards,
                cfg=self.cfg,
                bmat_kind=self.bmat_kind,
                rs_iters=self.rs_iters,
                device=self.device,
                build_id=bid,
                key_lo=lo,
                key_hi=hi,
            )

    def discard_build(self, build_id: Optional[int] = None):
        """Drop a build's op-log and any staged drain. ``None`` discards
        every active build."""
        ids = list(self._logs) if build_id is None else [build_id]
        for bid in ids:
            if self._logs.pop(bid, None) is not None:
                self.n_discards += 1
            self._drains.pop(bid, None)
        self._prune_revisions()

    def _resolve_shard(self, delta: StateDelta) -> Optional[int]:
        """Map the delta's key interval back to a current shard index (one
        shard for retrain/split, an adjacent pair for merge), or None."""
        s = int(np.searchsorted(self.boundaries, delta.key_lo, side="right"))
        if s >= self.n_shards:
            return None
        lo, hi = self._shard_interval(s)
        if lo != delta.key_lo:
            return None
        if delta.kind == "merge":
            if s + 1 >= self.n_shards:
                return None
            hi = self._shard_interval(s + 1)[1]
        return s if hi == delta.key_hi else None

    def commit(
        self, delta: StateDelta, replay_cap: Optional[int] = None
    ) -> bool:
        """Accept a finished build. A structural revision since the
        snapshot that intersects the delta's keyspace discards it (returns
        False). Otherwise the interval's logged ops are replayed into the
        rebuilt shells, whole batches at a time, up to ``replay_cap`` ops
        (None = unbounded): a dry log swaps the shells in now, else the
        commit parks in the draining state (old rows keep serving) and
        ``advance_drain`` resumes it. Returns True when accepted."""
        bl = self._logs.get(delta.build_id)
        if bl is None or self._conflicts(delta.epoch, delta.key_lo,
                                         delta.key_hi):
            self.discard_build(delta.build_id)
            return False
        if self._resolve_shard(delta) is None:
            self.discard_build(delta.build_id)
            return False
        if delta.kind == "split":
            cuts = (delta.key_lo, int(delta.boundary), delta.key_hi)
        else:
            cuts = (delta.key_lo, delta.key_hi)
        drain = _DrainingCommit(delta=delta, shells=delta.shells, cuts=cuts)
        self._drains[delta.build_id] = drain
        self._advance_one(drain, replay_cap)
        return True

    @property
    def draining(self) -> bool:
        return bool(self._drains)

    def draining_builds(self) -> List[int]:
        return list(self._drains)

    def drain_backlog(self, build_id: Optional[int] = None) -> int:
        """Un-replayed ops still owed by draining commits."""
        ids = self.draining_builds() if build_id is None else [build_id]
        return sum(self._logs[b].backlog_ops for b in ids if b in self._logs)

    def advance_drain(
        self, build_id: int, replay_cap: Optional[int] = None
    ) -> bool:
        """Replay up to ``replay_cap`` more ops of one draining commit and
        swap if it caught up; abort when an intersecting revision landed.
        Returns True when the commit completed this call."""
        drain = self._drains.get(build_id)
        if drain is None:
            return False
        bl = self._logs[build_id]
        if self._conflicts(bl.epoch, bl.key_lo, bl.key_hi):
            self.discard_build(build_id)
            return False
        return self._advance_one(drain, replay_cap)

    def advance_drains(self, replay_cap: Optional[int] = None) -> int:
        """Wave-boundary hook: advance every draining commit; returns the
        number that completed this call."""
        return sum(self.advance_drain(bid, replay_cap)
                   for bid in self.draining_builds())

    def _advance_one(
        self, drain: _DrainingCommit, replay_cap: Optional[int]
    ) -> bool:
        """Replay whole logged batches into the staged shells until the op
        budget is spent or the log is dry; swap when dry."""
        bl = self._logs[drain.delta.build_id]
        done = 0
        while bl.pos < len(bl.log):
            if replay_cap is not None and done >= replay_cap:
                return False
            kind, keys, vals = bl.log[bl.pos]
            bl.log[bl.pos] = None  # consumed: hold only the unreplayed tail
            bl.pos += 1
            for shell, c_lo, c_hi in zip(drain.shells, drain.cuts[:-1],
                                         drain.cuts[1:]):
                m = (keys >= c_lo) & (keys < c_hi)
                if not m.any():
                    continue
                if kind == "insert":
                    shell.insert(keys[m], vals[m])
                else:
                    shell.delete(keys[m])
            done += len(keys)
            self.n_replayed_ops += len(keys)
        return self._finish_drain(drain)

    def _finish_drain(self, drain: _DrainingCommit) -> bool:
        """The wave-boundary swap of the caught-up shells: it changes the
        layout, never what a lookup returns."""
        delta = drain.delta
        s = self._resolve_shard(delta)
        if s is None:
            self.discard_build(delta.build_id)
            return False
        del self._drains[delta.build_id]
        del self._logs[delta.build_id]
        with self._lock:
            self._apply_delta(delta, s, drain.shells)
            self._record_revision(delta.key_lo, delta.key_hi)
            self.n_commits += 1
        return True

    def _apply_delta(
        self, delta: StateDelta, s: int, shells: Tuple[UpLIF, ...]
    ):
        if delta.kind == "retrain":
            sh = shells[0]
            if not self._write_shard(s, sh):
                self._restack([sh if i == s else self._unstack_shell(i)
                               for i in range(self.n_shards)])
            self.n_retrains += 1
        elif delta.kind == "split":
            self._replace_shards(s, 1, list(shells), boundary=delta.boundary)
        elif delta.kind == "merge":
            self._replace_shards(s, 2, list(shells))
        else:
            raise ValueError(f"unknown delta kind: {delta.kind}")

    def _replace_shards(self, s: int, n_old: int, new: List[UpLIF],
                        boundary: Optional[int] = None):
        """Restack with shards ``s .. s+n_old-1`` replaced by ``new``: a
        split (one shard, two shells, a new ``boundary``; both halves keep
        the shard's locate strategy) or a merge (two shards, one shell,
        which keeps the left member's strategy)."""
        live = [self._unstack_shell(i) for i in range(self.n_shards)]
        with self._lock:
            if len(new) > n_old:
                self._set_boundaries(np.insert(self.boundaries, s, boundary))
                self._locate_per_shard.insert(s, self._locate_per_shard[s])
                self.n_splits += 1
            else:
                self._set_boundaries(np.delete(self.boundaries, s))
                del self._locate_per_shard[s + 1]
                self.n_merges += 1
            self.n_shards = len(self.boundaries) + 1
            self._set_locate_axis()
            self._restack(live[:s] + new + live[s + n_old:])

    # -- tuning hooks (Section 4.2, applied per shard) -------------------------
    def retrain_full(self, gmm: Optional[GMMState] = None):
        shells = [self._unstack_shell(s) for s in range(self.n_shards)]
        for sh in shells:
            sh.retrain_full(gmm)
        self._restack(shells)
        self.n_retrains += 1
        self._record_revision(0, int(KEY_MAX))

    def retrain_shard(self, s: int, gmm: Optional[GMMState] = None):
        """Targeted tuning action: full retrain of one shard — absorb its
        delta buffer, drop its tombstones, re-nullify with ``gmm`` (the
        forecaster's D_update) or the shard's reservoir refit, with the gap
        budget fitted to the stacked capacity so the rebuilt shard usually
        lands as one padded row write."""
        if not 0 <= s < self.n_shards:
            raise IndexError(f"shard {s} out of range")
        shell = self._unstack_shell(s)
        retrain_shell_fitted(shell, int(self.state.slots.keys.shape[1]),
                             gmm=gmm)
        if not self._write_shard(s, shell):
            self._restack([shell if i == s else self._unstack_shell(i)
                           for i in range(self.n_shards)])
        self.n_retrains += 1
        self._record_revision(*self._shard_interval(s))

    def retrain_subset(self, quantiles: int = 16) -> int:
        """Subset retrain (``UpLIF.retrain_subset``) on the shard with the
        largest BMAT, the cheapest win; returns the number absorbed."""
        worst = int(np.argmax(self.state.bmat.size.cpu().numpy()))
        shells = [self._unstack_shell(s) for s in range(self.n_shards)]
        absorbed = shells[worst].retrain_subset(quantiles)
        self._restack(shells)
        self.n_retrains += 1
        self._record_revision(*self._shard_interval(worst))
        return absorbed

    def switch_bmat_type(self):
        # the BMAT layout is shared by every shard, so the switch revises
        # the whole keyspace
        with self._lock:
            self.bmat_kind = BPMAT if self.bmat_kind == RBMAT else RBMAT
            self._record_revision(0, int(KEY_MAX))

    # -- structural maintenance ------------------------------------------------
    def split_shard(self, s: int) -> bool:
        """Split shard ``s`` at its median live key into two shards. Returns
        False when the shard is too small to split."""
        if not 0 <= s < self.n_shards:
            raise IndexError(f"shard {s} out of range")
        shell = self._unstack_shell(s)
        keys, vals = shell.extract_live()
        mid = split_point(keys)
        if mid is None:
            return False
        left, right = split_shells(shell, keys, vals, mid, self.cfg)
        lo, hi = self._shard_interval(s)
        with self._lock:
            self._replace_shards(s, 1, [left, right], boundary=int(keys[mid]))
            self._record_revision(lo, hi)
        return True

    def merge_shards(self, s: int) -> bool:
        """Merge shard ``s`` with its right neighbour. Returns False when
        there is none or the merged shard would be empty."""
        if self.n_shards < 2 or not (0 <= s < self.n_shards - 1):
            return False
        sh1, sh2 = self._unstack_shell(s), self._unstack_shell(s + 1)
        k1, v1 = sh1.extract_live()
        k2, v2 = sh2.extract_live()
        keys = np.concatenate([k1, k2])
        vals = np.concatenate([v1, v2])
        if len(keys) == 0:
            return False
        merged = merge_shells(sh1, sh2, keys, vals, self.cfg, self._rng)
        lo = self._shard_interval(s)[0]
        hi = self._shard_interval(s + 1)[1]
        with self._lock:
            self._replace_shards(s, 2, [merged])
            self._record_revision(lo, hi)
        return True

    def presize_bmat(self, per_shard_capacity: int) -> bool:
        """Forecast-driven delta-buffer growth: raise every shard's BMAT
        capacity to at least ``per_shard_capacity`` now. Growth only."""
        need = int(per_shard_capacity)
        if need <= int(self.state.bmat.keys.shape[1]):
            return False
        self._grow_bmat(pow2_at_least(need))
        return True

    # -- accounting ------------------------------------------------------------
    @property
    def size(self) -> int:
        c = self.state.counters
        return int((c.n_keys + c.n_bmat_live).sum())

    @property
    def n_keys(self) -> int:
        return int(self.state.counters.n_keys.sum())

    @property
    def capacity(self) -> int:
        return int(self.state.slots.keys.numel())

    def _bytes(self, arrays) -> int:
        total = sum(a.numel() * a.element_size() for a in arrays)
        return total + sum(gmm_memory_bytes(m.gmm) for m in self._meta)

    def memory_bytes(self, modeled: bool = False) -> int:
        st = self.state
        return self._bytes([*st.slots, *st.model, *st.bmat])

    def index_bytes(self, modeled: bool = False) -> int:
        return self._bytes([*self.state.model, *self.state.bmat])

    def measures(self) -> dict:
        """Aggregate Section 4.1 measures (worst-case heights, summed sizes)."""
        c = self.state.counters
        bsizes = self.state.bmat.size.cpu().numpy()
        heights = [bmat_height(int(b), self.bmat_kind, self.cfg.bmat_fanout)
                   for b in bsizes]
        return {
            "bmat_height": max(heights),
            "granularity": int(c.min_granularity.min()),
            "error_scaling": float(np.mean([m.alpha for m in self._meta])),
            "n_models": sum(m.rs_static.n_spline for m in self._meta),
            "bmat_type": self.bmat_kind,
            "bmat_size": int(bsizes.sum()),
            "n_keys": self.n_keys,
            "occupancy": self.n_keys / max(self.capacity, 1),
            "n_shards": self.n_shards,
        }
