"""Live per-shard telemetry for the online tuning loop (port of
``repro/tuning/telemetry.py``).

Everything structural already lives in the router's stacked ``UpLIFState``
on the device (counters, BMAT sizes, array shapes), so ``shard_signals``
reduces it to [S] vectors with one device op and one transfer; no host
round-trip per field. Workload-side signals (throughput, memory, range and
lookup latency) cannot come from the state: ``Telemetry`` keeps EWMAs of
what the serving loop reports.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.bmat import bmat_height
from repro_torch.core.sharded import ShardedUpLIF
from repro_torch.core.state import UpLIFState


class ShardSignals(NamedTuple):
    """Per-shard [S] signal vectors (host numpy) of the stacked state."""

    n_keys: np.ndarray           # int64[S] — live in-place keys
    n_bmat_live: np.ndarray      # int64[S] — live delta-buffer entries
    bmat_size: np.ndarray        # int32[S] — delta-buffer rows incl. tombstones
    bmat_fill: np.ndarray        # float64[S] — size / capacity
    occupancy: np.ndarray        # float64[S] — live keys / slot capacity
    n_overflow: np.ndarray       # int64[S] — lifetime BMAT-routed inserts
    min_granularity: np.ndarray  # int64[S] — smallest failed-window span


def shard_signals(state: UpLIFState) -> ShardSignals:
    """Stacked state -> [S] signals: the five integer vectors are stacked on
    the device and copied in one transfer; the two ratios divide on the
    host (the same IEEE division the device would do)."""
    c = state.counters
    cap = state.slots.keys.shape[-1]
    bcap = state.bmat.keys.shape[-1]
    n_keys, n_live, size, n_over, gran = torch.stack([
        c.n_keys, c.n_bmat_live, state.bmat.size.to(torch.int64),
        c.n_overflow, c.min_granularity,
    ]).cpu().numpy()
    return ShardSignals(
        n_keys=n_keys,
        n_bmat_live=n_live,
        bmat_size=size.astype(np.int32),
        bmat_fill=size.astype(np.float64) / float(max(bcap, 1)),
        occupancy=n_keys.astype(np.float64) / float(max(cap, 1)),
        n_overflow=n_over,
        min_granularity=gran,
    )


@dataclasses.dataclass
class TelemetrySnapshot:
    """Host view of one telemetry read: per-shard arrays + global measures."""

    n_shards: int
    n_keys: np.ndarray           # [S]
    n_bmat_live: np.ndarray      # [S]
    bmat_size: np.ndarray        # [S]
    bmat_fill: np.ndarray        # [S]
    occupancy: np.ndarray        # [S]
    n_overflow: np.ndarray       # [S]
    min_granularity: np.ndarray  # [S]
    bmat_height: np.ndarray      # [S] — dependent gathers per rank query (S1)
    alpha: np.ndarray            # [S] — error scaling Γ̄-1 per shard (S3)
    n_models: np.ndarray         # [S] — spline knots per shard (S4)
    bmat_type: str               # S5
    throughput_ewma: float       # ops/s over recent waves
    memory_ewma: float           # index bytes
    range_lat_ewma: float        # seconds per range query (0 = none seen)
    # per-shard locate-strategy axis: the current assignment plus the
    # (shard, strategy) -> seconds-per-query latency EWMAs the controller's
    # switch-locate action reads (empty until lookups have been observed)
    locate_strategy: Tuple[str, ...] = ()
    locate_lat: Dict[Tuple[int, str], float] = dataclasses.field(
        default_factory=dict
    )
    # the router's device: decides which locate strategies are candidates
    device: torch.device = torch.device("cpu")

    def shard_measures(self, s: int) -> dict:
        """Section 4.1 measure dict for shard ``s`` (controller state input)."""
        return {
            "bmat_height": int(self.bmat_height[s]),
            "bmat_fill": float(self.bmat_fill[s]),
            "granularity": int(self.min_granularity[s]),
            "error_scaling": float(self.alpha[s]),
            "n_models": int(self.n_models[s]),
            "bmat_type": self.bmat_type,
            "bmat_size": int(self.bmat_size[s]),
            "n_keys": int(self.n_keys[s]),
            "occupancy": float(self.occupancy[s]),
            "n_shards": self.n_shards,
        }


@dataclasses.dataclass
class TelemetryConfig:
    ewma_alpha: float = 0.25     # weight of the newest wave observation
    memory_every: int = 4        # snapshot-to-snapshot memory re-read cadence


class Telemetry:
    """EWMA aggregator + snapshot reader for a ``ShardedUpLIF`` router."""

    def __init__(self, config: TelemetryConfig = TelemetryConfig()):
        self.cfg = config
        self.throughput_ewma = 0.0
        self.memory_ewma = 0.0
        self.range_lat_ewma = 0.0
        self.n_waves = 0
        self.n_range_obs = 0
        self._snap_count = 0
        # (shard, locate strategy) -> EWMA seconds per lookup query
        self.locate_lat: Dict[Tuple[int, str], float] = {}
        self._locate_n_shards: Optional[int] = None

    def observe_wave(self, n_ops: int, seconds: float):
        """Feed one request wave's measured throughput into the EWMA."""
        if seconds <= 0 or n_ops <= 0:
            return
        tput = n_ops / seconds
        a = self.cfg.ewma_alpha
        self.throughput_ewma = (
            tput if self.n_waves == 0
            else (1 - a) * self.throughput_ewma + a * tput
        )
        self.n_waves += 1

    def observe_range(self, n_queries: int, seconds: float):
        """Feed measured range-scan latency (per query) into its EWMA."""
        if seconds < 0 or n_queries <= 0:
            return
        lat = seconds / n_queries
        a = self.cfg.ewma_alpha
        self.range_lat_ewma = (
            lat if self.n_range_obs == 0
            else (1 - a) * self.range_lat_ewma + a * lat
        )
        self.n_range_obs += 1

    def observe_locate(
        self,
        obs: Sequence[Tuple[np.ndarray, float, Tuple[str, ...]]],
        n_shards: int,
    ):
        """Fold drained lookup observations into the per-(shard, strategy)
        latency EWMAs. A lookup wave is one joint dispatch, so every shard
        that served queries observes the wave's per-query latency, with an
        EWMA step scaled by its share of the wave. A shard-count change
        (split/merge renumbering) resets the table."""
        if (self._locate_n_shards is not None
                and n_shards != self._locate_n_shards):
            self.locate_lat.clear()
        self._locate_n_shards = n_shards
        a = self.cfg.ewma_alpha
        for counts, seconds, strategies in obs:
            total = int(counts.sum())
            if total <= 0 or seconds <= 0:
                continue
            lat = seconds / total
            for s, strat in enumerate(strategies):
                c = int(counts[s]) if s < len(counts) else 0
                if c == 0:
                    continue
                key = (s, strat)
                prev = self.locate_lat.get(key)
                w = a * c / total
                self.locate_lat[key] = (
                    lat if prev is None else (1 - w) * prev + w * lat
                )

    def snapshot(self, index: ShardedUpLIF) -> TelemetrySnapshot:
        """Read the per-shard signals (one device reduce + one transfer)."""
        self.observe_locate(index.drain_locate_obs(), index.n_shards)
        sig = shard_signals(index.state)
        heights = np.asarray([
            bmat_height(int(b), index.bmat_kind, index.cfg.bmat_fanout)
            for b in sig.bmat_size
        ])
        if (self._snap_count % self.cfg.memory_every == 0
                or self.memory_ewma == 0):
            self.memory_ewma = float(index.index_bytes())
        self._snap_count += 1
        return TelemetrySnapshot(
            n_shards=index.n_shards,
            n_keys=sig.n_keys,
            n_bmat_live=sig.n_bmat_live,
            bmat_size=sig.bmat_size,
            bmat_fill=sig.bmat_fill,
            occupancy=sig.occupancy,
            n_overflow=sig.n_overflow,
            min_granularity=sig.min_granularity,
            bmat_height=heights,
            alpha=np.asarray([m.alpha for m in index._meta]),
            n_models=np.asarray([m.rs_static.n_spline for m in index._meta]),
            bmat_type=index.bmat_kind,
            throughput_ewma=self.throughput_ewma,
            memory_ewma=self.memory_ewma,
            range_lat_ewma=self.range_lat_ewma,
            locate_strategy=index.shard_locate(),
            locate_lat=dict(self.locate_lat),
            device=index.device,
        )
