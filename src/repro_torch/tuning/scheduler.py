"""Maintenance planning and the synchronous plan/build/commit pipeline
(port of ``repro/tuning/scheduler.py``).

Each decision point emits a declarative ``MaintenancePlan`` (action, shard,
forecast inputs, cost estimate) and runs it through three phases:

  plan    — here, between waves: telemetry snapshot, capacity guards,
            controller decision, admission control, budget check;
  build   — ``tuning/executor.py``: the host-side unstack/retrain/restack
            against an immutable ``RouterSnapshot``, run inline;
  commit  — ``ShardedUpLIF.commit`` validates the build's key interval and
            swaps the rebuilt rows in, right after the build.

This slice of the port runs builds synchronously: the serving wave stalls
for the build, and the measured time is charged to a token bucket that
waves refill at ``budget_fraction`` of their wall time. Builds on the
executor's worker pool, paced commits and their drain accounting arrive
with the async/serving slice; ``SchedulerConfig(async_build=True)`` raises
until then.

Capacity guards (forecast presize, forced absorb) and BMAT-type switches
have no build phase and execute directly at plan time. The reward loop
closes one decision later.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.sharded import ShardedUpLIF, intervals_overlap
from repro_torch.core.types import GMMState
from repro_torch.tuning.controller import (
    A_KEEP,
    A_MERGE_SHARDS,
    A_RETRAIN_SHARD,
    A_SWITCH_BMAT,
    A_SWITCH_LOCATE,
    ACTION_NAMES,
    ShardTuningController,
)
from repro_torch.tuning.executor import BUILD_ACTIONS, build as build_plan
from repro_torch.tuning.forecast import UpdateForecaster
from repro_torch.tuning.telemetry import Telemetry

_ASYNC = "asynchronous builds arrive with the async/serving slice of the port"


@dataclasses.dataclass
class MaintenancePlan:
    """Declarative maintenance record: everything build + commit need.
    ``build_id``/``key_lo``/``key_hi`` are stamped from the snapshot at
    dispatch — they tie the plan to its per-interval op-log."""

    plan_id: int
    epoch: int                     # epoch of the snapshot the build reads
    wave: int                      # wave the decision was made on
    action: int
    shard: int
    gmm: Optional[GMMState]        # forecast D_update for gap sizing
    cost_estimate: float           # learned cost the budget must cover
    forced: bool = False
    build_id: int = -1
    key_lo: int = 0
    key_hi: int = 0


@dataclasses.dataclass
class SchedulerConfig:
    budget_fraction: float = 0.25  # ceiling on maintenance share of wall time
    decide_every: int = 4          # waves between controller decisions
    presize_horizon: int = 16      # presize for this many waves of inserts
    presize_margin: float = 1.5    # overshoot factor per presize jump
    force_absorb_fill: float = 0.6  # capacity-debt guard (see on_wave)
    explore: bool = True           # epsilon-greedy (False = pure exploit)
    cost_ewma: float = 0.5         # action-cost estimate update weight
    max_budget_s: float = 30.0     # token-bucket cap (bounds catch-up bursts)
    # overlap builds with serving waves: the async slice brings it (and the
    # JAX package's pacing knobs with it)
    async_build: bool = False

    def __post_init__(self):
        if self.async_build:
            raise NotImplementedError(_ASYNC)


class MaintenanceScheduler:
    """Plans controller actions between waves; builds and commits inline."""

    def __init__(
        self,
        controller: ShardTuningController,
        telemetry: Telemetry,
        forecaster: Optional[UpdateForecaster] = None,
        config: SchedulerConfig = SchedulerConfig(),
    ):
        self.controller = controller
        self.telemetry = telemetry
        self.forecaster = forecaster
        self.cfg = config
        self._budget = 0.0
        self._wave = 0
        self._insert_ewma = 0.0
        # (state, action, mask) awaiting its measured reward
        self._pending: Optional[Tuple] = None
        self._cost_est: Dict[int, float] = {}
        self.time_in_maintenance = 0.0
        self.actions_log: List[dict] = []
        self._next_plan_id = 0
        # gateway overload ladder (set_pressure): 0 = normal; >= 1 = shed
        # maintenance (no new plans, no budget refill). Forced capacity
        # guards still run.
        self.pressure = 0
        self.n_shed_waves = 0
        self.n_planned = 0
        self.n_committed = 0
        self.n_drained = 0             # paced commits that completed a drain
        self.n_conflicts = 0           # interval-conflict discards
        self.n_abandoned = 0           # degenerate or failed builds
        self.last_build_error: Optional[str] = None

    # -- bookkeeping ---------------------------------------------------------
    def observe_inserts(self, n: int):
        self._insert_ewma = 0.75 * self._insert_ewma + 0.25 * float(n)

    def set_pressure(self, level: int):
        """Load-shedding hook for the request gateway: at pressure >= 1 new
        plan admission pauses and the token bucket stops refilling; forced
        absorbs and presize guards still run."""
        self.pressure = int(level)

    def _estimated_cost(self, a: int) -> float:
        return self._cost_est.get(a, 0.05)  # optimistic until measured

    def _fold_cost(self, a: int, dt: float):
        """Fold a measured serving-path cost into the learned per-action
        estimate (EWMA) without touching the bucket."""
        w = self.cfg.cost_ewma
        old = self._cost_est.get(a, dt)
        self._cost_est[a] = (1 - w) * old + w * dt

    def _charge(self, a: int, dt: float):
        """Deduct the measured serving-path cost and fold it into the
        learned per-action cost estimate."""
        self._budget = max(self._budget - dt, 0.0)
        self._fold_cost(a, dt)

    # -- plan dispatch -------------------------------------------------------
    def _make_plan(self, a: int, s: int, forced: bool) -> MaintenancePlan:
        gmm = (
            self.forecaster.gmm
            if self.forecaster is not None and self.forecaster.ready
            else None
        )
        self._next_plan_id += 1
        self.n_planned += 1
        return MaintenancePlan(
            plan_id=self._next_plan_id,
            epoch=-1,  # stamped from the snapshot at dispatch
            wave=self._wave,
            action=a,
            shard=s,
            gmm=gmm,
            cost_estimate=self._estimated_cost(a),
            forced=forced,
        )

    def _plan_shards(self, a: int, s: int) -> Tuple[int, ...]:
        """Contiguous shard run a plan's build owns (merge takes a pair)."""
        return (s, s + 1) if a == A_MERGE_SHARDS else (s,)

    def _admit(self, index: ShardedUpLIF, a: int, s: int,
               forced: bool) -> bool:
        """A plan runs only when its key interval is disjoint from every
        active build and (unless forced) its cost estimate fits the
        budget."""
        if self.pressure >= 1 and not forced:
            return False  # shed: overloaded front end — no new builds
        shards = self._plan_shards(a, s)
        if shards[-1] >= index.n_shards:
            return False
        lo, hi = index._shard_interval(shards[0], shards[-1])
        for b_lo, b_hi in index.active_intervals():
            if intervals_overlap(lo, hi, b_lo, b_hi):
                return False
        return forced or self._estimated_cost(a) <= self._budget

    def _dispatch(self, index: ShardedUpLIF, plan: MaintenancePlan) -> bool:
        """Run one plan through build + commit inline (the wave stalls and
        is charged at the commit). Returns whether the index changed."""
        snapshot = index.snapshot(self._plan_shards(plan.action, plan.shard))
        plan.epoch = snapshot.epoch
        plan.build_id = snapshot.build_id
        plan.key_lo, plan.key_hi = snapshot.key_lo, snapshot.key_hi
        t0 = time.perf_counter()
        try:
            delta = build_plan(plan, snapshot)
        except Exception:
            index.discard_build(plan.build_id)
            self.n_abandoned += 1
            raise
        if delta is None:
            # degenerate action: the wave still paid snapshot + build, so
            # the bucket is deducted, but the learned estimate is not
            index.discard_build(plan.build_id)
            self.n_abandoned += 1
            self._budget = max(self._budget - (time.perf_counter() - t0), 0.0)
            return False
        # nothing arrived mid-build, so the commit lands unpaced
        ok = index.commit(delta)
        if ok:
            self._charge(plan.action, time.perf_counter() - t0)
            self.n_committed += 1
        else:
            self.n_conflicts += 1
            self._budget = max(self._budget - (time.perf_counter() - t0), 0.0)
        return ok

    def drain(self, index: ShardedUpLIF, timeout: float = 30.0) -> int:
        """Land every commit still parked in the draining state, unpaced.
        Returns the number of builds committed here (none: sync builds
        commit as they run)."""
        while index.draining:
            done = index.advance_drains(None)
            self.n_drained += done
            if done == 0:
                break  # aborted drains vanish without completing
        return 0

    # -- the loop ------------------------------------------------------------
    def on_wave(
        self, index: ShardedUpLIF, n_ops: int, seconds: float
    ) -> Optional[dict]:
        """Report one finished request wave; maybe plan one maintenance step.

        Returns the action record when a decision was made, else None.
        """
        self.telemetry.observe_wave(n_ops, seconds)
        if self.pressure < 1:
            self._budget = min(
                self._budget + max(seconds, 0.0) * self.cfg.budget_fraction,
                self.cfg.max_budget_s,
            )
        else:
            self.n_shed_waves += 1
        self._wave += 1
        decide = self._wave % self.cfg.decide_every == 0

        t0 = time.perf_counter()
        replayed0 = index.n_replayed_ops
        snap = self.telemetry.snapshot(index)
        heat = (
            self.forecaster.shard_mass(index.boundaries)
            if self.forecaster is not None
            else np.full(index.n_shards, 1.0 / index.n_shards)
        )
        s = self.controller.focus_shard(snap, heat)
        state = self.controller.encode(snap, s, heat)
        mask = self.controller.action_mask(snap, s)

        # -- capacity guards: every wave, ahead of the learned policy -------
        # Forecast-driven presize: when the predicted insert stream would
        # not fit an empty buffer AND the buffer is actually filling, jump
        # once with margin (every presize changes the BMAT shapes).
        presized = False
        bcap = int(index.state.bmat.keys.shape[1])
        if self.forecaster is not None and self.forecaster.ready:
            horizon = int(
                self.cfg.presize_horizon * max(self._insert_ewma, 1.0)
            )
            need = int(
                self.cfg.presize_margin
                * self.forecaster.bmat_presize(index.boundaries, horizon)
            )
            if need > bcap and int(snap.bmat_size.max()) > bcap // 2:
                p0 = time.perf_counter()
                presized = index.presize_bmat(need)
                bcap = int(index.state.bmat.keys.shape[1])
                if presized:  # guards are charged as they run (no build)
                    self._budget = max(
                        self._budget - (time.perf_counter() - p0), 0.0
                    )

        # capacity-debt guard: a delta buffer about to overflow its capacity
        # would force an organic reallocation mid-wave, so an absorb retrain
        # of the fullest buffer is mandatory whatever the policy prefers
        hot = int(np.argmax(snap.bmat_size))
        forced = (
            int(snap.bmat_size[hot]) > 0
            and float(snap.bmat_size[hot])
            > self.cfg.force_absorb_fill * bcap
        )

        # close the reward loop for the previous learned action on the
        # normal cadence (Algorithm 1 lines 13-17), even when a forced
        # absorb preempts this wave's choice
        if decide and self._pending is not None:
            p_state, p_action, _ = self._pending
            r = self.controller.reward(
                snap.throughput_ewma, snap.memory_ewma, snap.range_lat_ewma,
            )
            self.controller.update(p_state, p_action, r, state, mask)
            self._pending = None

        a, deferred = A_KEEP, False
        s_apply = s
        if forced:
            a, s_apply = A_RETRAIN_SHARD, hot
        elif decide:
            a = self.controller.choose(
                state, mask, explore=self.cfg.explore,
                snap=snap, s=s, heat=heat,
            )
        elif not presized:
            return None

        # -- translate the decision into a plan / direct action -------------
        changed = False
        if a in BUILD_ACTIONS:
            if a == A_MERGE_SHARDS:
                s_apply = self.controller.coldest_pair(snap)
            if not self._admit(index, a, s_apply, forced):
                # interval overlaps an active build, or unaffordable — defer
                a, deferred = A_KEEP, True
            else:
                self.controller.action_counts[a] += 1
                changed = self._dispatch(
                    index, self._make_plan(a, s_apply, forced)
                )
        elif a == A_SWITCH_BMAT:
            if self.pressure >= 1:
                a, deferred = A_KEEP, True  # shed: no structural changes
            elif index.active_intervals():
                # the switch revises the whole keyspace: it would void
                # every active build
                a, deferred = A_KEEP, True
            elif self._estimated_cost(a) > self._budget:
                a, deferred = A_KEEP, True
            else:
                self.controller.action_counts[a] += 1
                sw0 = time.perf_counter()
                index.switch_bmat_type()
                self._charge(A_SWITCH_BMAT, time.perf_counter() - sw0)
                changed = True
        elif a == A_SWITCH_LOCATE:
            # metadata-only: no tensors move and results are identical
            # across strategies, so only overload or the budget defer it
            if self.pressure >= 1:
                a, deferred = A_KEEP, True
            elif self._estimated_cost(a) > self._budget:
                a, deferred = A_KEEP, True
            else:
                pick = self.controller.pick_locate(snap, s)
                sw0 = time.perf_counter()
                changed = index.set_shard_locate(s, pick)
                if changed:
                    self.controller.action_counts[a] += 1
                    self._charge(A_SWITCH_LOCATE, time.perf_counter() - sw0)
                else:  # telemetry moved since the mask: nothing to change
                    a = A_KEEP
                    self.controller.action_counts[A_KEEP] += 1
        else:
            self.controller.action_counts[A_KEEP] += 1

        dt = time.perf_counter() - t0
        self.time_in_maintenance += dt
        if decide and not forced and (self.cfg.explore or a != A_KEEP):
            self._pending = (state, a, mask)

        rec = {
            "wave": self._wave,
            "shard": s_apply,
            "action": ACTION_NAMES[a],
            "changed": bool(changed),
            "deferred": deferred,
            "forced": forced,
            "presized": presized,
            "committed": 0,
            "drained": 0,
            "pressure": self.pressure,
            "draining": len(index.draining_builds()),
            "replayed_ops": index.n_replayed_ops - replayed0,
            "inflight": 0,
            "cost_s": dt,
            "budget_s": self._budget,
            "reserved_s": 0.0,
            "throughput_ewma": snap.throughput_ewma,
            "n_shards": snap.n_shards,
            "bmat_fill_max": float(snap.bmat_fill.max()),
        }
        self.actions_log.append(rec)
        return rec
