"""Online self-tuning subsystem (port of ``repro/tuning``).

Closes the paper's adaptive loop over the sharded router:

  telemetry  — per-shard measures reduced on the device from the stacked
               ``UpLIFState`` (one small transfer per snapshot) + latency
               EWMAs from the serving loop;
  forecast   — streaming-EM GMM over the observed insert stream (D_update,
               Section 3.4), whose E-step is the K3 kernel on CUDA; it
               drives delta-buffer presizing, Eq. 6 gap sizing at retrain,
               split triggers and a distribution-shift signal;
  controller — per-shard Q-learning (Algorithm 1) over the masked actions
               keep / retrain-shard / switch-BMAT / split-shard /
               merge-shards / switch-locate, persisted per workload
               signature through ``QTableStore``;
  scheduler  — plan/build/commit: decisions become ``MaintenancePlan``
               records admitted by interval overlap + aggregate budget;
               builds run inline (sync) or on the ``MaintenanceExecutor``
               worker pool (async — disjoint shard intervals rebuild
               concurrently), and land through the router's
               interval-validated ``commit`` at a wave boundary, paced by
               ``commit_replay_cap`` (long replay logs drain across
               waves). Maintenance never alters lookup results.

``SelfTuner`` bundles them into the one object serving code attaches:

    tuner = SelfTuner().attach(router)             # sync builds
    tuner = SelfTuner.overlapped().attach(router)  # builds overlap waves
    ...  # per wave: tuner.observe_inserts(keys); tuner.after_wave(n, s)
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.sharded import RouterSnapshot, ShardedUpLIF, StateDelta  # noqa: F401
from repro_torch.core.types import KEY_MAX
from repro_torch.tuning.controller import (  # noqa: F401
    A_KEEP,
    A_MERGE_SHARDS,
    A_RETRAIN_SHARD,
    A_SPLIT_SHARD,
    A_SWITCH_BMAT,
    A_SWITCH_LOCATE,
    ACTION_NAMES,
    ACTIONS,
    ControllerConfig,
    QTableStore,
    ShardTuningController,
)
from repro_torch.tuning.executor import (  # noqa: F401
    BUILD_ACTIONS,
    BuildResult,
    MaintenanceExecutor,
    build,
)
from repro_torch.tuning.forecast import ForecastConfig, UpdateForecaster  # noqa: F401
from repro_torch.tuning.scheduler import (  # noqa: F401
    MaintenancePlan,
    MaintenanceScheduler,
    SchedulerConfig,
)
from repro_torch.tuning.telemetry import (  # noqa: F401
    Telemetry,
    TelemetryConfig,
    TelemetrySnapshot,
    shard_signals,
)


@dataclasses.dataclass
class TunerConfig:
    telemetry: TelemetryConfig = dataclasses.field(
        default_factory=TelemetryConfig
    )
    forecast: ForecastConfig = dataclasses.field(
        default_factory=ForecastConfig
    )
    controller: ControllerConfig = dataclasses.field(
        default_factory=ControllerConfig
    )
    scheduler: SchedulerConfig = dataclasses.field(
        default_factory=SchedulerConfig
    )
    # Q-table persistence: path of the signature-keyed store (None = off).
    # Warm-start waits until the workload signature is measurable.
    qtable_path: Optional[str] = None
    warmup_waves: int = 4          # waves before the signature is trusted


class SelfTuner:
    """Telemetry + forecast + controller + scheduler as one attachable unit."""

    def __init__(self, config: TunerConfig = TunerConfig()):
        self.cfg = config
        self.telemetry = Telemetry(config.telemetry)
        self.controller = ShardTuningController(config.controller)
        self.forecaster: Optional[UpdateForecaster] = None
        self.scheduler: Optional[MaintenanceScheduler] = None
        self.index: Optional[ShardedUpLIF] = None
        self.store: Optional[QTableStore] = (
            QTableStore(config.qtable_path) if config.qtable_path else None
        )
        self._warm_started = False
        self._wave_inserts = 0
        self._write_rate_ewma = 0.0

    @classmethod
    def overlapped(
        cls,
        config: Optional[TunerConfig] = None,
        max_concurrent_builds: Optional[int] = None,
        commit_replay_cap: Optional[int] = None,
    ) -> "SelfTuner":
        """A tuner whose builds overlap serving waves (async pipeline).

        ``max_concurrent_builds`` sizes the executor's worker pool —
        builds for disjoint shard intervals run concurrently;
        ``commit_replay_cap`` paces commits (at most this many logged ops
        replayed per wave; a longer replay log drains across waves)."""
        config = config or TunerConfig()
        overrides: dict = {"async_build": True}
        if max_concurrent_builds is not None:
            overrides["max_concurrent_builds"] = int(max_concurrent_builds)
        if commit_replay_cap is not None:
            overrides["commit_replay_cap"] = int(commit_replay_cap)
        config = dataclasses.replace(
            config,
            scheduler=dataclasses.replace(config.scheduler, **overrides),
        )
        return cls(config)

    def attach(self, index: ShardedUpLIF) -> "SelfTuner":
        """Bind to a router; the forecast domain is the min/max of its live
        slot keys, reduced on the device (one scalar pair comes back), and
        the forecaster runs on the router's device."""
        keys = index.state.slots.keys
        lo, hi = torch.stack([
            keys.min(), torch.where(keys < KEY_MAX, keys, -1).max(),
        ]).tolist()
        lo, hi = (float(lo), float(hi)) if hi >= 0 else (0.0, 1.0)
        self.forecaster = UpdateForecaster(lo, hi, self.cfg.forecast,
                                           device=index.device)
        self.scheduler = MaintenanceScheduler(
            self.controller, self.telemetry, self.forecaster,
            self.cfg.scheduler,
        )
        self.index = index
        return self

    # -- the calls serving code makes -----------------------------------------
    def observe_inserts(self, keys):
        """Feed observed insert keys to the D_update forecaster."""
        if self.forecaster is not None and len(keys):
            self.forecaster.observe(keys)
            self.scheduler.observe_inserts(len(keys))
            self._wave_inserts += len(keys)

    def observe_range(self, n_queries: int, seconds: float):
        """Feed measured range-scan latency into telemetry (reward input)."""
        self.telemetry.observe_range(n_queries, seconds)

    def set_pressure(self, level: int):
        """Gateway overload ladder: pressure >= 1 sheds maintenance before
        any client request is rejected or delayed."""
        if self.scheduler is not None:
            self.scheduler.set_pressure(level)

    def after_wave(self, n_ops: int, seconds: float) -> Optional[dict]:
        """Report a finished request wave; maybe plan one maintenance step."""
        if self.scheduler is None or self.index is None:
            return None
        if n_ops > 0:
            rate = min(self._wave_inserts / n_ops, 1.0)
            self._write_rate_ewma = 0.75 * self._write_rate_ewma + 0.25 * rate
        self._wave_inserts = 0
        if (
            self.store is not None
            and not self._warm_started
            and self.telemetry.n_waves >= self.cfg.warmup_waves
            and self.forecaster.ready
        ):
            # nearest-signature warm-start, deferred past warmup so the
            # measured signature picks the stored table
            self.store.warm_start(self.controller, self.signature())
            self._warm_started = True
        return self.scheduler.on_wave(self.index, n_ops, seconds)

    # -- workload signature + persistence -------------------------------------
    def signature(self) -> tuple:
        """(write rate, skew, shift) — the workload-class axes Q-tables are
        stored under."""
        skew = 1.0
        shift = 0.0
        if self.forecaster is not None and self.forecaster.ready:
            if self.index is not None:
                skew = self.forecaster.imbalance(self.index.boundaries)
            shift = self.forecaster.drift_ewma * 100.0
        return (round(self._write_rate_ewma, 4), round(skew, 3),
                round(shift, 3))

    def persist(self):
        """Save the learned Q-table under the measured workload signature."""
        if self.store is not None and self.controller.q:
            self.store.save(self.signature(), self.controller)

    def drain(self, timeout: float = 30.0) -> int:
        """Land every in-flight build and parked commit (blocking).
        Returns #commits."""
        if self.scheduler is None or self.index is None:
            return 0
        return self.scheduler.drain(self.index, timeout)

    def close(self):
        """Land (or abandon) in-flight builds, persist the Q-table and stop
        the executor's workers. Draining first keeps the router's op-logs
        from outliving the tuner when callers skip an explicit drain()."""
        self.drain()
        self.persist()
        if self.scheduler is not None:
            self.scheduler.close()

    # -- introspection --------------------------------------------------------
    def stats(self) -> dict:
        sched = self.scheduler
        return {
            "waves": self.telemetry.n_waves,
            "throughput_ewma": self.telemetry.throughput_ewma,
            "range_lat_ewma": self.telemetry.range_lat_ewma,
            "actions": {
                name: int(n)
                for name, n in zip(ACTION_NAMES, self.controller.action_counts)
            },
            "q_states": len(self.controller.q),
            "time_in_maintenance_s": (
                sched.time_in_maintenance if sched else 0.0
            ),
            "forecast_obs": self.forecaster.n_obs if self.forecaster else 0,
            "n_shards": self.index.n_shards if self.index else 0,
            "async_build": bool(sched and sched.cfg.async_build),
            "max_concurrent_builds": (
                sched.cfg.max_concurrent_builds if sched else 1
            ),
            "commit_replay_cap": (
                sched.cfg.commit_replay_cap if sched else None
            ),
            "pressure": sched.pressure if sched else 0,
            "shed_waves": sched.n_shed_waves if sched else 0,
            "plans": sched.n_planned if sched else 0,
            "commits": sched.n_committed if sched else 0,
            "drained": sched.n_drained if sched else 0,
            "conflicts": sched.n_conflicts if sched else 0,
            "abandoned": sched.n_abandoned if sched else 0,
            "replayed_ops": self.index.n_replayed_ops if self.index else 0,
            "drain_backlog_ops": (
                self.index.drain_backlog() if self.index else 0
            ),
            "last_build_error": sched.last_build_error if sched else None,
            "epoch": self.index.epoch if self.index else 0,
            "signature": list(self.signature()),
        }
