"""Maintenance planning and the plan/build/commit pipeline (port of
``repro/tuning/scheduler.py``).

Each decision point emits a declarative ``MaintenancePlan`` (action, shard,
forecast inputs, cost estimate) and routes it through three phases:

  plan    — here, between waves: telemetry snapshot, capacity guards,
            controller decision, admission control, budget reservation;
  build   — ``tuning/executor.py``: the host-side unstack/retrain/restack
            against an immutable ``RouterSnapshot``. Sync mode runs it
            inline (the serving wave stalls); async mode runs it on the
            executor's worker pool while serving continues;
  commit  — back on the serving thread at a wave boundary:
            ``ShardedUpLIF.commit`` validates the build's key interval
            against intervening revisions, replays the interval's op-log
            (at most ``commit_replay_cap`` ops per wave — a longer log
            parks the commit in the draining state, advanced every wave
            until the residual is empty) and swaps the rows in under the
            router's lock.

Admission is by interval overlap and aggregate budget: up to
``max_concurrent_builds`` plans may be in flight at once as long as their
key intervals are pairwise disjoint (the per-interval op-logs make
disjoint replays independent) and the sum of reserved cost estimates fits
the token bucket. A plan whose interval overlaps an in-flight build or a
draining commit defers to a later wave.

Budget accounting is at commit time: planning only reserves the learned
cost estimate per plan, and the token bucket is charged the measured
serving-path cost when the delta lands. A build abandoned mid-flight —
interval conflict, degenerate action, build error — releases exactly its
own reservation, exactly once. A build error is kept in
``last_build_error`` and warned about, never dropped without a word.

Capacity guards (forecast presize, forced absorb) and BMAT-type switches
have no build phase and execute directly at plan time in both modes. The
reward loop closes one decision later; under async builds the action's
structural effect may land a wave after that.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
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
from repro_torch.tuning.executor import (
    BUILD_ACTIONS,
    MaintenanceExecutor,
    build as build_plan,
)
from repro_torch.tuning.forecast import UpdateForecaster
from repro_torch.tuning.telemetry import Telemetry


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
    cost_estimate: float           # reserved against the budget until commit
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
    async_build: bool = False      # overlap builds with serving waves
    max_concurrent_builds: int = 1  # disjoint-interval builds in flight
    # commit pacing: replay at most this many logged ops per wave per
    # commit (whole batches; None = unbounded = land in one wave). Bounds
    # the serving-path cost of a commit like any other wave op.
    commit_replay_cap: Optional[int] = None
    max_drain_waves: int = 64      # force-finish a drain stuck this long
    # load-shedding (gateway overload ladder, DESIGN.md §9): while the
    # serving front end reports pressure ≥ 1 the drains advance at
    # commit_replay_cap / shed_drain_divisor per wave — maintenance slows
    # BEFORE any client request is rejected or delayed.
    shed_drain_divisor: int = 4


class MaintenanceScheduler:
    """Plans controller actions between waves; builds run sync or async."""

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
        # plan/build/commit bookkeeping
        self.executor: Optional[MaintenanceExecutor] = (
            MaintenanceExecutor(config.max_concurrent_builds)
            if config.async_build
            else None
        )
        # plan_id -> in-flight plan / its budget reservation. Reservations
        # are PER PLAN and released by pop: a conflicted build refunds
        # exactly its own estimate exactly once, never a neighbor's.
        self._inflight: Dict[int, MaintenancePlan] = {}
        self._reservations: Dict[int, float] = {}
        self._drain_waves: Dict[int, int] = {}  # build_id -> waves draining
        self._fresh_drains: set = set()  # parked THIS wave: already paid
                                         # their cap at commit acceptance
        # build_id -> (action, serving-path seconds spent so far): a paced
        # commit's TRUE cost spans its drain waves — folded into the
        # learned estimate only when the drain completes, so admission
        # learns the whole cost, not just the commit-wave slice
        self._drain_actions: Dict[int, int] = {}
        self._drain_spent: Dict[int, float] = {}
        self._next_plan_id = 0
        self._stale_plan_ids: set = set()  # abandoned; late results dropped
        # gateway overload ladder (set_pressure): 0 = normal; ≥1 = shed
        # maintenance (no new plan admission, no budget refill, slowed
        # drains). Forced capacity guards still run — shedding must never
        # trade overload for a mid-wave reallocation stall.
        self.pressure = 0
        self.n_shed_waves = 0
        self.n_planned = 0
        self.n_committed = 0           # commits accepted (incl. draining)
        self.n_drained = 0             # paced commits that completed a drain
        self.n_conflicts = 0           # interval-conflict discards
        self.n_abandoned = 0           # degenerate/failed/timed-out builds
        self.last_build_error: Optional[str] = None

    # -- bookkeeping ---------------------------------------------------------
    def observe_inserts(self, n: int):
        self._insert_ewma = 0.75 * self._insert_ewma + 0.25 * float(n)

    def set_pressure(self, level: int):
        """Load-shedding hook for the request gateway (DESIGN.md §9): the
        admission controller reports its overload level before each wave's
        maintenance step. At pressure ≥ 1 the scheduler sheds maintenance
        FIRST — new plan admission pauses, the token bucket stops
        refilling (maintenance earns budget only from waves served while
        the front end is healthy — the budget-sharing contract), and
        draining commits advance at a reduced replay cap — so client
        requests are rejected or delayed only after maintenance has
        already been pushed off the serving path. Forced absorbs and
        presize guards still run: capacity debt is the one thing more
        expensive than overload."""
        self.pressure = int(level)

    def _estimated_cost(self, a: int) -> float:
        return self._cost_est.get(a, 0.05)  # optimistic until measured

    @property
    def _reserved(self) -> float:
        """Budget held by ALL in-flight plans (aggregate reservation)."""
        return sum(self._reservations.values())

    def _available(self) -> float:
        """Spendable budget = bucket minus the in-flight reservations."""
        return self._budget - self._reserved

    def _release(self, plan_id: int):
        """Refund-once: pop the plan's own reservation; a second release
        of the same plan (late result, double discard) is a no-op."""
        self._reservations.pop(plan_id, None)
        self._inflight.pop(plan_id, None)

    def _fold_cost(self, a: int, dt: float):
        """Fold a measured serving-path cost into the learned per-action
        estimate (EWMA) without touching the bucket."""
        w = self.cfg.cost_ewma
        old = self._cost_est.get(a, dt)
        self._cost_est[a] = (1 - w) * old + w * dt

    def _charge(self, a: int, dt: float):
        """Commit-time charge: deduct the measured serving-path cost and
        fold it into the learned per-action cost estimate."""
        self._budget = max(self._budget - dt, 0.0)
        self._fold_cost(a, dt)

    def close(self):
        if self.executor is not None:
            self.executor.close()

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
        """Interval-overlap + budget admission: a plan runs only when a
        worker slot is free, its key interval is disjoint from every
        in-flight build AND draining commit, and (unless forced) its cost
        estimate fits the unreserved budget."""
        if self.pressure >= 1 and not forced:
            return False  # shed: overloaded front end — no new builds
        if len(self._inflight) >= self.cfg.max_concurrent_builds and (
            self.executor is not None
        ):
            return False
        shards = self._plan_shards(a, s)
        if shards[-1] >= index.n_shards:
            return False
        lo, hi = index._shard_interval(shards[0], shards[-1])
        for b_lo, b_hi in index.active_intervals():
            if intervals_overlap(lo, hi, b_lo, b_hi):
                return False
        return forced or self._estimated_cost(a) <= self._available()

    def _dispatch(self, index: ShardedUpLIF, plan: MaintenancePlan) -> bool:
        """Run one plan through build + commit. Sync: inline (stalls the
        wave, charged at its commit). Async: submit and return — the
        estimate stays reserved until the build lands or is abandoned.
        Returns whether the index changed NOW (sync commit)."""
        snapshot = index.snapshot(self._plan_shards(plan.action, plan.shard))
        plan.epoch = snapshot.epoch
        plan.build_id = snapshot.build_id
        plan.key_lo, plan.key_hi = snapshot.key_lo, snapshot.key_hi
        if self.executor is not None:
            self.executor.submit(plan, snapshot)
            self._inflight[plan.plan_id] = plan
            self._reservations[plan.plan_id] = plan.cost_estimate
            return False
        t0 = time.perf_counter()
        try:
            delta = build_plan(plan, snapshot)
        except Exception:
            index.discard_build(plan.build_id)
            self.n_abandoned += 1
            raise
        if delta is None:
            # degenerate action: the wave still paid snapshot + build, so
            # the bucket is deducted (or the controller could retry the
            # same free no-op every decide wave) — but an abandoned
            # build's cost never pollutes the learned estimate
            index.discard_build(plan.build_id)
            self.n_abandoned += 1
            self._budget = max(
                self._budget - (time.perf_counter() - t0), 0.0
            )
            return False
        # sync commits are never paced: the build already stalled the wave,
        # so the replay is tiny (nothing arrived mid-build)
        ok = index.commit(delta)
        if ok:
            self._charge(plan.action, time.perf_counter() - t0)
            self.n_committed += 1
        else:
            self.n_conflicts += 1
            self._budget = max(
                self._budget - (time.perf_counter() - t0), 0.0
            )
        return ok

    def _handle_result(
        self, index: ShardedUpLIF, res,
        replay_cap: Optional[int] = None,
    ) -> bool:
        """Commit (or abandon) one finished async build on the serving
        thread. Releasing the plan's reservation without a charge IS the
        refund path for abandoned work — and it releases ONLY this plan's
        hold, other queued plans keep theirs."""
        plan = res.plan
        if plan.plan_id in self._stale_plan_ids:
            # a build that outlived its drain timeout: its op-log is gone
            # (possibly replaced by a newer build's) — committing it would
            # replay the wrong log, so it is dropped unconditionally
            self._stale_plan_ids.discard(plan.plan_id)
            return False
        self._release(plan.plan_id)
        if res.error is not None or res.delta is None:
            index.discard_build(plan.build_id)
            self.n_abandoned += 1
            if res.error is not None:
                # async must not silently degrade to never-tune: keep the
                # reason visible (stats) and warn once per failure
                self.last_build_error = repr(res.error)
                warnings.warn(
                    f"maintenance build failed ({ACTION_NAMES[plan.action]}"
                    f" shard {plan.shard}): {res.error!r}",
                    RuntimeWarning,
                )
            return False
        t0 = time.perf_counter()
        ok = index.commit(res.delta, replay_cap=replay_cap)
        if ok:
            # the serving path paid only the commit (row write + capped
            # replay); the build ran off-path, so only that hits the bucket
            dt = time.perf_counter() - t0
            self.n_committed += 1
            bid = res.delta.build_id
            if bid in index.draining_builds():
                # parked: deduct the slice now, but fold the estimate only
                # when the drain completes — the action's true serving-path
                # cost is the commit slice PLUS every drain wave's replay
                self._budget = max(self._budget - dt, 0.0)
                self._drain_actions[bid] = plan.action
                self._drain_spent[bid] = dt
                self._drain_waves[bid] = 0
                # the commit already replayed this wave's cap: the first
                # advance_drain belongs to the NEXT wave, or the commit
                # wave would replay up to 2x the documented bound
                self._fresh_drains.add(bid)
            else:
                self._charge(plan.action, dt)
        else:
            self.n_conflicts += 1
        return ok

    def _commit_finished(self, index: ShardedUpLIF) -> int:
        """Wave-boundary commit point: land every finished async build."""
        if self.executor is None:
            return 0
        return sum(
            self._handle_result(
                index, res, replay_cap=self.cfg.commit_replay_cap
            )
            for res in self.executor.poll()
        )

    def _advance_drains(self, index: ShardedUpLIF) -> int:
        """Advance every draining commit by one capped replay step; a
        drain stuck past ``max_drain_waves`` (arrivals outpacing the cap)
        finishes unbounded — pacing bounds the common case, the escape
        hatch bounds drain lifetime. Replay is serving-thread work, so
        the measured time is charged to the token bucket like every
        other directly-executed maintenance step."""
        done = 0
        for bid in index.draining_builds():
            if bid in self._fresh_drains:
                # parked at THIS wave's commit: its cap is already spent
                self._fresh_drains.discard(bid)
                continue
            age = self._drain_waves.get(bid, 0) + 1
            self._drain_waves[bid] = age
            cap = (
                None
                if age > self.cfg.max_drain_waves
                else self.cfg.commit_replay_cap
            )
            if cap is not None and self.pressure >= 1:
                # shed: slow drain advancement while the gateway is
                # overloaded (the escape hatch above still bounds lifetime)
                cap = max(cap // max(self.cfg.shed_drain_divisor, 1), 1)
            d0 = time.perf_counter()
            completed = index.advance_drain(bid, cap)
            dt = time.perf_counter() - d0
            self._budget = max(self._budget - dt, 0.0)
            spent = self._drain_spent.get(bid, 0.0) + dt
            self._drain_spent[bid] = spent
            if completed:
                done += 1
                a = self._drain_actions.pop(bid, None)
                if a is not None:
                    # the action's learned cost is its WHOLE serving-path
                    # bill (commit slice + all drain waves)
                    self._fold_cost(a, self._drain_spent.pop(bid))
        live = set(index.draining_builds())
        for stale in set(self._drain_waves) - live:
            # completed above, or aborted mid-drain (intersecting
            # revision): drop the bookkeeping. An aborted build's partial
            # cost must not pollute the learned estimate — the bucket
            # already paid for the real time spent
            self._drain_waves.pop(stale, None)
            self._drain_actions.pop(stale, None)
            self._drain_spent.pop(stale, None)
        self._fresh_drains &= live
        self.n_drained += done
        return done

    def drain(self, index: ShardedUpLIF, timeout: float = 30.0) -> int:
        """Block until in-flight builds finish and commit them fully —
        paced drains included (shutdown / test convergence helper; serving
        uses the non-blocking poll). A build that outlives the timeout is
        ABANDONED: its op-log is released (it would otherwise grow
        unbounded and block every future overlapping snapshot) and its
        plan is marked stale so a late result can never commit against a
        newer build's log."""
        n = 0
        if self.executor is not None:
            n = sum(
                self._handle_result(index, res, replay_cap=None)
                for res in self.executor.wait(timeout)
            )
            for plan in list(self._inflight.values()):
                self._stale_plan_ids.add(plan.plan_id)
                self._release(plan.plan_id)
                index.discard_build(plan.build_id)
                self.n_abandoned += 1
        # land anything still parked in the draining state, unpaced —
        # with the same completion accounting the paced path keeps
        while index.draining:
            progressed = 0
            for bid in index.draining_builds():
                d0 = time.perf_counter()
                if index.advance_drain(bid, None):
                    progressed += 1
                    self.n_drained += 1
                    a = self._drain_actions.pop(bid, None)
                    if a is not None:
                        self._fold_cost(
                            a,
                            self._drain_spent.pop(bid, 0.0)
                            + time.perf_counter() - d0,
                        )
            if progressed == 0:
                break  # aborted drains vanish without completing
        self._drain_waves.clear()
        self._fresh_drains.clear()
        self._drain_actions.clear()
        self._drain_spent.clear()
        return n

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
        committed = self._commit_finished(index)
        drained = self._advance_drains(index)

        snap = self.telemetry.snapshot(index)
        heat = (
            self.forecaster.shard_mass(index.boundaries)
            if self.forecaster is not None
            else np.full(index.n_shards, 1.0 / index.n_shards)
        )
        s = self.controller.focus_shard(snap, heat)
        state = self.controller.encode(snap, s, heat)
        mask = self.controller.action_mask(snap, s)

        # -- capacity guards: EVERY wave, ahead of the learned policy -------
        # Forecast-driven proactive presize (cheap, not a learned action).
        # Capacity serves the FORECAST HORIZON only: if the predicted
        # insert stream wouldn't fit an *empty* buffer, jump once with
        # margin — every presize changes the BMAT's shapes, so land
        # above the need instead of chasing it in reallocating
        # increments. Two gates keep it honest: the pressure must be
        # *predicted* (forecast need beyond capacity) AND *materializing*
        # (the buffer is actually filling — inserts the gapped array
        # absorbs in place need no buffer capacity, whatever the forecast
        # says). Capacity already used is the absorb guard's business,
        # never a reason to grow further.
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

        # capacity-debt guard (analogous to LSM compaction-debt limits): a
        # delta buffer about to overflow its capacity would force an
        # organic reallocation — new shapes, mid-wave — so an absorb
        # retrain is mandatory no matter what the policy prefers. It
        # watches the FULLEST buffer, not the (heat-biased) focus shard —
        # any shard can hit the debt limit. This also keeps learning
        # safe: the controller explores within bounds the scheduler
        # enforces. With async builds the forced absorb becomes an urgent
        # *plan*; while one is already in flight the buffer may organically
        # grow once, which the monotone shape discipline absorbs.
        hot = int(np.argmax(snap.bmat_size))
        forced = (
            int(snap.bmat_size[hot]) > 0
            and float(snap.bmat_size[hot])
            > self.cfg.force_absorb_fill * bcap
        )

        # close the reward loop for the previous learned action on the
        # normal cadence (Algorithm 1 lines 13-17) — even when a forced
        # absorb preempts this wave's choice, so the old action's reward
        # window doesn't silently stretch over later maintenance stalls
        if decide and self._pending is not None:
            p_state, p_action, _ = self._pending
            r = self.controller.reward(
                snap.throughput_ewma, snap.memory_ewma,
                snap.range_lat_ewma,
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
        elif not presized and committed == 0 and drained == 0:
            return None

        # -- translate the decision into a plan / direct action -------------
        changed = False
        if a in BUILD_ACTIONS:
            if a == A_MERGE_SHARDS:
                s_apply = self.controller.coldest_pair(snap)
            if not self._admit(index, a, s_apply, forced):
                # no free worker slot, interval overlaps an in-flight
                # build / draining commit, or unaffordable — defer
                a, deferred = A_KEEP, True
            else:
                self.controller.action_counts[a] += 1
                changed = self._dispatch(
                    index, self._make_plan(a, s_apply, forced)
                )
        elif a == A_SWITCH_BMAT:
            if self.pressure >= 1:
                a, deferred = A_KEEP, True  # shed: no structural changes
            elif self._inflight or index.active_intervals():
                # the switch revises the WHOLE keyspace: it would void
                # every in-flight build and draining commit
                a, deferred = A_KEEP, True
            elif self._estimated_cost(a) > self._available():
                a, deferred = A_KEEP, True
            else:
                self.controller.action_counts[a] += 1
                sw0 = time.perf_counter()  # own timer: t0 covers commits
                index.switch_bmat_type()
                self._charge(A_SWITCH_BMAT, time.perf_counter() - sw0)
                changed = True
        elif a == A_SWITCH_LOCATE:
            # metadata-only: no arrays move, results are byte-identical
            # across strategies, so — unlike switch_bmat — the repin needs
            # neither an in-flight-build veto nor a revision record; only
            # overload sheds it
            if self.pressure >= 1:
                a, deferred = A_KEEP, True
            elif self._estimated_cost(a) > self._available():
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
            "committed": committed,
            "drained": drained,
            "pressure": self.pressure,
            "draining": len(index.draining_builds()),
            "replayed_ops": index.n_replayed_ops - replayed0,
            "inflight": len(self._inflight),
            "cost_s": dt,
            "budget_s": self._budget,
            "reserved_s": self._reserved,
            "throughput_ewma": snap.throughput_ewma,
            "n_shards": snap.n_shards,
            "bmat_fill_max": float(snap.bmat_fill.max()),
        }
        self.actions_log.append(rec)
        return rec
