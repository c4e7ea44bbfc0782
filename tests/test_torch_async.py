"""The port's asynchronous maintenance, on the CPU: the plan/build/commit
pipeline with builds on the ``MaintenanceExecutor``'s worker threads.

The cases of ``tests/test_async_maintenance.py`` are held to the same
contracts on the port's router and tuner: ops logged between snapshot and
commit are replayed, an intersecting revision discards a build and a
disjoint one does not, sync and async maintenance leave the same mapping,
budgets are reserved at plan time and charged or refunded once at commit,
a build that outlives the drain is abandoned and its late result dropped,
readers never see a torn swap, and a maximally paced commit leaves the
same bytes as an unbounded one. Two cases go further: the same op tape and
forced plans through the JAX package's overlapped tuner and the port's
leave identical arrays, and a snapshot's tensors stay bitwise frozen
across inserts, deletes, a subset retrain and a build.

Every join, wait and result here has a timeout, and running into it fails
the test.
"""
import hashlib
import threading
import time

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401 — x64
from repro.core import ShardedUpLIF as JaxRouter
from repro.core.uplif import UpLIFConfig as JaxConfig
from repro.tuning import SelfTuner as JaxSelfTuner
from repro_torch.core import ShardedUpLIF
from repro_torch.core.uplif import UpLIFConfig
from repro_torch.tuning import (
    A_MERGE_SHARDS,
    A_RETRAIN_SHARD,
    A_SPLIT_SHARD,
    ControllerConfig,
    ForecastConfig,
    MaintenanceExecutor,
    MaintenancePlan,
    QTableStore,
    SchedulerConfig,
    SelfTuner,
    ShardTuningController,
    Telemetry,
    TunerConfig,
    build,
)
from tests.conftest import make_keys
from tests.test_torch_sharded import _state_arrays, assert_same_state

CFG = UpLIFConfig(batch_bucket=256)
JOIN_S = 60.0


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps the parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _router(n=20_000, seed=7, shards=4, cfg=CFG):
    keys = make_keys(n, seed)
    return keys, ShardedUpLIF(keys, keys * 2, cfg, n_shards=shards,
                              device="cpu")


def _plan(action, shard, epoch=-1):
    return MaintenancePlan(
        plan_id=1, epoch=epoch, wave=0, action=action, shard=shard,
        gmm=None, cost_estimate=0.05,
    )


def _join(threads):
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads), "a thread did not finish"


# ---------------------------------------------------------------------------
# core protocol: snapshot -> build -> commit with replay
# ---------------------------------------------------------------------------


def test_commit_replays_mid_build_ops():
    """Inserts and deletes that arrive between snapshot and commit survive
    the swap: the op-log replay carries them over."""
    keys, idx = _router()
    rng = np.random.default_rng(0)
    snap = idx.snapshot()
    new = np.setdiff1d(rng.integers(0, 1 << 48, 4000).astype(np.int64), keys)
    idx.insert(new, new + 7)
    dead = keys[100:200]
    idx.delete(dead)
    delta = build(_plan(A_RETRAIN_SHARD, 1), snap)
    assert idx.commit(delta)
    assert idx.epoch == 1 and idx.n_commits == 1
    f, v = idx.lookup(new)
    assert f.all() and np.array_equal(v, new + 7)
    f, _ = idx.lookup(dead)
    assert not f.any()
    keep = np.setdiff1d(keys, dead)
    f, v = idx.lookup(keep)
    assert f.all() and np.array_equal(v, keep * 2)


def test_commit_split_delta_and_ranges():
    keys, idx = _router(shards=2)
    snap = idx.snapshot()
    rng = np.random.default_rng(1)
    new = np.setdiff1d(rng.integers(0, 1 << 48, 2000).astype(np.int64), keys)
    idx.insert(new, new + 1)
    delta = build(_plan(A_SPLIT_SHARD, 0), snap)
    assert delta.kind == "split" and len(delta.shells) == 2
    assert idx.commit(delta)
    assert idx.n_shards == 3 and len(idx.boundaries) == 2
    f, v = idx.lookup(new)
    assert f.all() and np.array_equal(v, new + 1)
    ks, _ = idx.range_query(int(keys[10]), int(keys[400]), max_out=1024)
    assert np.all(np.diff(ks) > 0)


def test_interval_conflict_discards_build():
    """A revision that intersects a build's key interval voids it; a
    revision on a disjoint interval does not."""
    keys, idx = _router()
    rng = np.random.default_rng(2)
    new = np.setdiff1d(rng.integers(0, 1 << 48, 3000).astype(np.int64), keys)
    idx.insert(new, new + 1)
    snap = idx.snapshot(shards=(0,))
    delta = build(_plan(A_RETRAIN_SHARD, 0), snap)
    idx.retrain_shard(0)          # direct revision of the same interval
    assert not idx.commit(delta)  # stale build discarded
    assert idx.n_commits == 0 and idx.n_discards == 1
    assert not idx._logs          # op-log released for the next build
    f, v = idx.lookup(new)
    assert f.all() and np.array_equal(v, new + 1)
    f, v = idx.lookup(keys)
    assert f.all() and np.array_equal(v, keys * 2)
    snap = idx.snapshot(shards=(0,))
    delta = build(_plan(A_RETRAIN_SHARD, 0), snap)
    idx.retrain_shard(2)          # disjoint interval: no conflict
    assert idx.commit(delta)
    assert idx.n_commits == 1
    f, v = idx.lookup(new)
    assert f.all() and np.array_equal(v, new + 1)


def test_sync_mode_runs_the_same_pipeline():
    """Sync is async with the build inline: the scheduler still plans,
    builds against a snapshot and commits."""
    keys, idx = _router(n=30_000, seed=9)
    tuner = SelfTuner(
        TunerConfig(
            forecast=ForecastConfig(min_obs=128, seed=0),
            scheduler=SchedulerConfig(decide_every=2, force_absorb_fill=0.3),
        )
    ).attach(idx)
    rng = np.random.default_rng(5)
    base = int(keys.max())
    for _ in range(10):
        ins = np.unique((base + rng.integers(1, 1 << 30, 800)).astype(np.int64))
        idx.insert(ins, ins + 1)
        tuner.observe_inserts(ins)
        tuner.after_wave(800, 0.5)
    assert tuner.scheduler.n_planned > 0
    assert tuner.scheduler.n_committed > 0
    assert idx.epoch == idx.n_commits > 0


def test_sync_async_equivalence_under_shift():
    """The same op sequence through sync and async maintenance gives the
    same lookup results over the whole live key set."""
    results = {}
    for mode in ("sync", "async"):
        keys, idx = _router(n=30_000, seed=11)
        tuner = SelfTuner(
            TunerConfig(
                controller=ControllerConfig(seed=3),
                forecast=ForecastConfig(min_obs=128, seed=3),
                scheduler=SchedulerConfig(
                    decide_every=2, force_absorb_fill=0.4,
                    async_build=(mode == "async"),
                ),
            )
        ).attach(idx)
        rng = np.random.default_rng(13)
        base = int(keys.max())
        inserted, deleted = [], []
        for wave in range(16):
            if wave < 6:  # phase 1: inside the bootstrap range
                ins = np.setdiff1d(
                    rng.integers(0, base, 600).astype(np.int64), keys
                )
            else:         # phase 2: shift to an unseen upper range
                ins = np.unique(
                    (base + rng.integers(1, 1 << 30, 600)).astype(np.int64)
                )
            idx.insert(ins, ins + 5)
            inserted.append(ins)
            dead = keys[wave * 50: wave * 50 + 25]
            idx.delete(dead)
            deleted.append(dead)
            idx.lookup(rng.choice(keys, 256))
            tuner.observe_inserts(ins)
            tuner.after_wave(881, 0.5)
            if mode == "async":
                time.sleep(0.01)  # let builds land on some waves
        tuner.drain(timeout=JOIN_S)
        assert tuner.stats()["last_build_error"] is None
        tuner.close()
        all_ins = np.unique(np.concatenate(inserted))
        all_del = np.concatenate(deleted)
        live = np.setdiff1d(np.concatenate([keys, all_ins]), all_del)
        f, v = idx.lookup(live)
        results[mode] = (f, v, idx.lookup(all_del)[0])
    f_s, v_s, fd_s = results["sync"]
    f_a, v_a, fd_a = results["async"]
    assert f_s.all() and f_a.all()
    assert np.array_equal(v_s, v_a)
    assert not fd_s.any() and not fd_a.any()


# ---------------------------------------------------------------------------
# commit-time budget accounting
# ---------------------------------------------------------------------------


def test_abandoned_build_refunds_budget():
    """Async plans only reserve their cost estimate; an interval conflict
    releases the reservation without charging the bucket."""
    keys, idx = _router()
    rng = np.random.default_rng(4)
    new = np.setdiff1d(rng.integers(0, 1 << 48, 3000).astype(np.int64), keys)
    idx.insert(new, new + 1)
    tuner = SelfTuner(
        TunerConfig(scheduler=SchedulerConfig(async_build=True))
    ).attach(idx)
    sched = tuner.scheduler
    sched._budget = 2.0
    sched._cost_est[A_RETRAIN_SHARD] = 1.5
    plan = sched._make_plan(A_RETRAIN_SHARD, 0, forced=False)
    assert not sched._dispatch(idx, plan)      # async: submitted, not done
    assert sched._reserved == 1.5
    assert sched._available() == 0.5           # the reservation blocks
    idx.retrain_shard(0)                       # same-interval revision
    committed = sched.drain(idx, timeout=JOIN_S)  # lands, commit refuses
    assert committed == 0
    assert sched.n_conflicts == 1 and sched.n_committed == 0
    assert sched._reserved == 0.0              # reservation released ...
    assert sched._budget == 2.0                # ... with no charge
    assert sched._cost_est[A_RETRAIN_SHARD] == 1.5
    tuner.close()


def test_commit_charges_budget_at_commit_time():
    keys, idx = _router()
    rng = np.random.default_rng(6)
    new = np.setdiff1d(rng.integers(0, 1 << 48, 3000).astype(np.int64), keys)
    idx.insert(new, new + 1)
    tuner = SelfTuner(
        TunerConfig(scheduler=SchedulerConfig(async_build=True))
    ).attach(idx)
    sched = tuner.scheduler
    sched._budget = 2.0
    sched._cost_est[A_RETRAIN_SHARD] = 1.5
    plan = sched._make_plan(A_RETRAIN_SHARD, 0, forced=False)
    sched._dispatch(idx, plan)
    committed = sched.drain(idx, timeout=JOIN_S)
    assert committed == 1 and sched.n_committed == 1
    assert sched._reserved == 0.0
    # charged the measured commit cost, not the 1.5 s estimate
    assert 2.0 - sched._budget < 1.0
    assert sched._cost_est[A_RETRAIN_SHARD] < 1.5
    tuner.close()


def test_drain_timeout_abandons_and_drops_late_result(monkeypatch):
    """A build that outlives the drain timeout releases its op-log, and
    its late result never commits."""
    import repro_torch.tuning.executor as executor_mod

    keys, idx = _router()
    rng = np.random.default_rng(8)
    new = np.setdiff1d(rng.integers(0, 1 << 48, 2000).astype(np.int64), keys)
    idx.insert(new, new + 1)
    tuner = SelfTuner(
        TunerConfig(scheduler=SchedulerConfig(async_build=True))
    ).attach(idx)
    sched = tuner.scheduler

    real_build = executor_mod.build

    def slow_build(plan, snapshot):
        time.sleep(0.6)
        return real_build(plan, snapshot)

    monkeypatch.setattr(executor_mod, "build", slow_build)
    sched._dispatch(idx, sched._make_plan(A_RETRAIN_SHARD, 0, forced=False))
    assert sched.drain(idx, timeout=0.05) == 0   # too slow: abandoned
    assert not sched._inflight and sched._reserved == 0.0
    assert not idx._logs                          # op-log released
    assert sched.n_abandoned == 1
    late = np.setdiff1d(rng.integers(0, 1 << 48, 1500).astype(np.int64),
                        np.concatenate([keys, new]))
    idx.insert(late, late + 9)
    assert sched.drain(idx, timeout=JOIN_S) == 0  # late result: dropped
    assert idx.n_commits == 0
    snap = idx.snapshot()
    assert idx.commit(build(_plan(A_RETRAIN_SHARD, 0), snap))
    for probe, want in ((new, new + 1), (late, late + 9)):
        f, v = idx.lookup(probe)
        assert f.all() and np.array_equal(v, want)
    tuner.close()


# ---------------------------------------------------------------------------
# threaded stress: no torn reads across the swap
# ---------------------------------------------------------------------------


def _reader(idx, probe, want, acked, stop, failures):
    while not stop.is_set():
        try:
            f, v = idx.lookup(probe)
            if not (f.all() and np.array_equal(v, want)):
                failures.append("probe mismatch (torn read)")
                return
            if acked:
                # read-your-writes across the swap: keys acknowledged
                # before a commit never vanish during its swap and replay
                ak, av = acked[-1]
                f, v = idx.lookup(ak)
                if not (f.all() and np.array_equal(v, av)):
                    failures.append("acked insert vanished")
                    return
        except Exception as e:  # noqa: BLE001 — any tear is a failure
            failures.append(repr(e))
            return


def test_threaded_lookups_never_tear():
    """Reader threads look up a fixed probe set while the main thread
    inserts and commits retrains and a split."""
    keys, idx = _router(n=24_000, seed=21)
    probe = keys[:: len(keys) // 512][:512]
    stop = threading.Event()
    failures, acked = [], []
    threads = [threading.Thread(target=_reader, daemon=True,
                                args=(idx, probe, probe * 2, acked, stop,
                                      failures))
               for _ in range(2)]
    for t in threads:
        t.start()
    try:
        rng = np.random.default_rng(22)
        base = int(keys.max())
        for round_ in range(6):
            new = np.unique(
                (base + rng.integers(1, 1 << 30, 1000)).astype(np.int64)
            )
            snap = idx.snapshot()
            # acknowledged after the snapshot: only the replay carries these
            idx.insert(new, new + 1)
            acked.append((new, new + 1))
            action = A_SPLIT_SHARD if round_ == 3 else A_RETRAIN_SHARD
            delta = build(_plan(action, round_ % idx.n_shards), snap)
            if delta is None:
                idx.discard_build()
            else:
                idx.commit(delta)
    finally:
        stop.set()
        _join(threads)
    assert not failures, failures
    assert idx.n_commits >= 5


# ---------------------------------------------------------------------------
# range-latency reward and Q-table persistence
# ---------------------------------------------------------------------------


def test_range_latency_feeds_reward():
    tel = Telemetry()
    tel.observe_range(4, 0.4)       # 100 ms per query
    assert tel.range_lat_ewma > 0
    ctl = ShardTuningController(ControllerConfig(eta_range=0.2))
    r_fast = ctl.reward(1000.0, 100.0, 0.001)
    r_slow = ctl.reward(1000.0, 100.0, 0.1)
    assert r_slow < r_fast
    ctl2 = ShardTuningController(ControllerConfig(eta_range=0.2))
    assert ctl2.reward(1000.0, 100.0) == ctl2.reward(1000.0, 100.0, 0.0)


def test_qtable_store_roundtrip_and_nearest(tmp_path):
    path = str(tmp_path / "qtables.json")
    store = QTableStore(path)
    c1 = ShardTuningController()
    c1._q_row((1,) * 7)[A_RETRAIN_SHARD] = 3.0
    store.save((0.5, 2.0, 0.1), c1)
    c2 = ShardTuningController()
    c2._q_row((2,) * 7)[A_SPLIT_SHARD] = 7.0
    store.save((0.05, 1.0, 0.0), c2)

    fresh = QTableStore(path)
    near = fresh.nearest((0.45, 1.8, 0.12))
    assert near["signature"] == [0.5, 2.0, 0.1]
    c3 = ShardTuningController()
    c3._q_row((1,) * 7)[A_SPLIT_SHARD] = 9.0
    assert fresh.warm_start(c3, (0.45, 1.8, 0.12))
    assert c3.q[(1,) * 7][A_SPLIT_SHARD] == 9.0  # own learning kept
    near2 = fresh.nearest((0.04, 1.1, 0.01))
    assert near2["signature"] == [0.05, 1.0, 0.0]
    c4 = ShardTuningController()
    assert fresh.warm_start(c4, (0.04, 1.1, 0.01))
    assert c4.q[(2,) * 7][A_SPLIT_SHARD] == 7.0


# ---------------------------------------------------------------------------
# concurrent disjoint builds and paced (draining) commits
# ---------------------------------------------------------------------------


def _digest(idx, keys: np.ndarray) -> str:
    """Order-independent content digest (found flags and values)."""
    keys = np.unique(keys)
    h = hashlib.sha256()
    for a in range(0, len(keys), 65536):
        f, v = idx.lookup(keys[a: a + 65536])
        h.update(f.astype(np.uint8).tobytes())
        h.update(np.where(f, v, 0).astype(np.int64).tobytes())
    return h.hexdigest()


def test_threaded_concurrent_builds_paced_commits():
    """Readers look up while two builds on disjoint shard intervals run on
    the executor's two workers and their commits drain under a small replay
    cap: no torn read, every acknowledged insert readable, and the final
    contents equal a sync twin's on the same tape."""
    rng = np.random.default_rng(41)
    keys = make_keys(24_000, 41)
    base = int(keys.max())
    tape = [
        np.unique((base + rng.integers(1, 1 << 30, 1200)).astype(np.int64))
        for _ in range(8)
    ]

    idx = ShardedUpLIF(keys, keys * 2, CFG, n_shards=4, device="cpu")
    probe = keys[:: len(keys) // 512][:512]
    stop = threading.Event()
    failures, acked = [], []
    threads = [threading.Thread(target=_reader, daemon=True,
                                args=(idx, probe, probe * 2, acked, stop,
                                      failures))
               for _ in range(3)]
    for t in threads:
        t.start()
    executor = MaintenanceExecutor(n_workers=2)
    try:
        for round_, new in enumerate(tape):
            if round_ % 2 == 0:
                snap_a = idx.snapshot(shards=(0,))
                snap_c = idx.snapshot(shards=(2,))
                assert len(idx.active_intervals()) == 2
                executor.submit(_plan(A_RETRAIN_SHARD, 0), snap_a)
                executor.submit(_plan(A_RETRAIN_SHARD, 2), snap_c)
            idx.insert(new, new + 1)
            acked.append((new, new + 1))
            if round_ % 2 == 1:
                results = executor.wait(timeout=JOIN_S)
                assert len(results) == 2 and executor.inflight == 0
                for res in results:
                    assert res.error is None
                    assert idx.commit(res.delta, replay_cap=256)
                idx.advance_drains(256)
                while idx.draining:
                    idx.advance_drains(256)
        while idx.draining:
            assert idx.advance_drains(None) > 0
    finally:
        stop.set()
        _join(threads)
        executor.close()
    assert not failures, failures
    assert idx.n_commits >= 6 and idx.n_discards == 0

    twin = ShardedUpLIF(keys, keys * 2, CFG, n_shards=4, device="cpu")
    for round_, new in enumerate(tape):
        twin.insert(new, new + 1)
        if round_ % 2 == 0:
            twin.retrain_shard(0)
            twin.retrain_shard(2)
    all_keys = np.concatenate([keys] + tape)
    assert _digest(idx, all_keys) == _digest(twin, all_keys)


def test_replay_cap_differential_byte_identical():
    """Maximal pacing (one logged batch per wave) and unbounded replay leave
    byte-identical stacked arrays: pacing changes when replay happens,
    never what it computes."""
    def run(replay_cap):
        keys = make_keys(16_000, 17)
        idx = ShardedUpLIF(keys, keys * 2, CFG, n_shards=2, device="cpu")
        rng = np.random.default_rng(18)
        snap = idx.snapshot(shards=(0,))
        for _ in range(5):
            new = np.setdiff1d(
                rng.integers(0, 1 << 48, 800).astype(np.int64), keys
            )
            idx.insert(new, new + 3)
            idx.delete(rng.choice(keys, 120, replace=False))
        delta = build(_plan(A_RETRAIN_SHARD, 0), snap)
        assert idx.commit(delta, replay_cap=replay_cap)
        waves = 0
        while idx.draining:
            idx.advance_drains(replay_cap)
            waves += 1
            assert waves < 100, "drain failed to converge"
        return idx, waves

    a, waves_a = run(None)
    b, waves_b = run(1)
    assert waves_a == 0 and waves_b >= 5
    assert a.n_commits == b.n_commits == 1
    la, lb = _state_arrays(a.state), _state_arrays(b.state)
    assert len(la) == len(lb)
    for xa, xb in zip(la, lb):
        np.testing.assert_array_equal(xa, xb)
    np.testing.assert_array_equal(a.boundaries, b.boundaries)


def test_budget_refund_once_with_second_plan_queued():
    """With two plans in flight, a conflicted build refunds exactly its own
    reservation exactly once."""
    keys, idx = _router()
    rng = np.random.default_rng(9)
    new = np.setdiff1d(rng.integers(0, 1 << 48, 3000).astype(np.int64), keys)
    idx.insert(new, new + 1)
    tuner = SelfTuner(
        TunerConfig(scheduler=SchedulerConfig(async_build=True,
                                              max_concurrent_builds=2))
    ).attach(idx)
    sched = tuner.scheduler
    sched._budget = 4.0
    sched._cost_est[A_RETRAIN_SHARD] = 1.5
    plan_a = sched._make_plan(A_RETRAIN_SHARD, 0, forced=False)
    plan_b = sched._make_plan(A_RETRAIN_SHARD, 2, forced=False)
    sched._dispatch(idx, plan_a)
    sched._dispatch(idx, plan_b)          # disjoint interval: admitted
    assert sched._reserved == 3.0
    assert sched._available() == 1.0
    idx.retrain_shard(0)                  # conflicts plan A only
    results = {r.plan.plan_id: r for r in sched.executor.wait(JOIN_S)}
    assert set(results) == {plan_a.plan_id, plan_b.plan_id}
    assert sched._handle_result(idx, results[plan_a.plan_id]) is False
    assert sched.n_conflicts == 1
    assert sched._reserved == 1.5         # only plan A's hold released
    assert sched._budget == 4.0
    sched._release(plan_a.plan_id)        # a duplicate release: no refund
    assert sched._reserved == 1.5
    assert sched._handle_result(idx, results[plan_b.plan_id]) is True
    assert sched._reserved == 0.0 and sched.n_committed == 1
    assert sched._budget < 4.0
    f, v = idx.lookup(new)
    assert f.all() and np.array_equal(v, new + 1)
    tuner.close()


def test_scheduler_admission_by_overlap_and_slots():
    """The scheduler defers a plan that overlaps an in-flight build or finds
    the pool full, and admits disjoint plans up to max_concurrent_builds."""
    keys, idx = _router(shards=4)
    tuner = SelfTuner(
        TunerConfig(scheduler=SchedulerConfig(async_build=True,
                                              max_concurrent_builds=2))
    ).attach(idx)
    sched = tuner.scheduler
    sched._budget = 10.0
    assert sched._admit(idx, A_RETRAIN_SHARD, 1, forced=False)
    sched._dispatch(idx, sched._make_plan(A_RETRAIN_SHARD, 1, forced=False))
    assert not sched._admit(idx, A_RETRAIN_SHARD, 1, forced=False)
    assert not sched._admit(idx, A_MERGE_SHARDS, 0, forced=False)  # (0, 1)
    assert sched._admit(idx, A_RETRAIN_SHARD, 3, forced=False)
    sched._dispatch(idx, sched._make_plan(A_RETRAIN_SHARD, 3, forced=False))
    assert not sched._admit(idx, A_RETRAIN_SHARD, 2, forced=False)
    assert sched.drain(idx, timeout=JOIN_S) == 2 and idx.n_commits == 2
    tuner.close()


def test_selftuner_signature_and_persist(tmp_path):
    path = str(tmp_path / "qtables.json")
    keys, idx = _router(n=20_000, seed=31)
    tuner = SelfTuner(
        TunerConfig(
            forecast=ForecastConfig(min_obs=64, seed=0),
            qtable_path=path, warmup_waves=2,
        )
    ).attach(idx)
    rng = np.random.default_rng(32)
    for _ in range(6):
        ins = np.unique(rng.integers(0, 1 << 40, 256).astype(np.int64))
        idx.insert(ins, ins + 1)
        tuner.observe_inserts(ins)
        tuner.after_wave(512, 0.05)
    sig = tuner.signature()
    assert 0.0 < sig[0] <= 1.0
    assert tuner._warm_started
    tuner.controller._q_row((5,) * 7)[A_RETRAIN_SHARD] = 1.0
    tuner.persist()
    assert QTableStore(path).nearest(sig) is not None
    c = ShardTuningController()
    assert QTableStore(path).warm_start(c, sig)
    assert c.q[(5,) * 7][A_RETRAIN_SHARD] == 1.0
    tuner.close()


# ---------------------------------------------------------------------------
# against the JAX package, and the snapshot freeze
# ---------------------------------------------------------------------------


def _overlapped_tape(idx, tuner, keys, plans_by_round, cap):
    """Forced plans dispatched to the executor, two op waves logged against
    them, the finished builds committed under ``cap`` (in plan order), two
    more waves with a drain step after each, then a full drain."""
    sched = tuner.scheduler
    rng = np.random.default_rng(51)
    base = int(keys.max())
    for round_, plans in enumerate(plans_by_round):
        made = []
        for action, shard in plans:
            p = sched._make_plan(action, shard(idx), forced=True)
            assert sched._admit(idx, action, p.shard, True)
            sched._dispatch(idx, p)
            made.append(p.plan_id)
        for w in range(4):
            lo = int(keys[0]) if w % 2 else base
            ins = np.unique(
                (lo + rng.integers(1, 1 << 36, 700)).astype(np.int64))
            idx.insert(ins, ins + round_)
            idx.delete(rng.choice(keys, 60, replace=False))
            if w == 1:
                results = sched.executor.wait(JOIN_S)
                assert sorted(r.plan.plan_id for r in results) == made
                for res in sorted(results, key=lambda r: r.plan.plan_id):
                    assert res.error is None
                    assert sched._handle_result(idx, res, replay_cap=cap)
            elif w > 1:
                sched._advance_drains(idx)
        tuner.drain(timeout=JOIN_S)
        assert not idx.draining and not idx._logs


def test_overlapped_tuner_matches_jax():
    """The same op tape and forced plans (a shard retrain beside a split,
    then a merge beside a retrain) through the JAX package's overlapped
    tuner and the port's, with paced commits: contents, boundaries and
    every stacked array identical after the drain."""
    keys = make_keys(16_000, 50)
    cap = 500
    plans = [
        [(A_RETRAIN_SHARD, lambda r: 0),
         (A_SPLIT_SHARD, lambda r: r.n_shards - 1)],
        [(A_MERGE_SHARDS, lambda r: 1), (A_RETRAIN_SHARD, lambda r: 0)],
    ]
    jidx = JaxRouter(keys, keys * 2, JaxConfig(batch_bucket=256), n_shards=4)
    jt = JaxSelfTuner.overlapped(max_concurrent_builds=2,
                                 commit_replay_cap=cap).attach(jidx)
    tidx = ShardedUpLIF(keys, keys * 2, CFG, n_shards=4, device="cpu")
    tt = SelfTuner.overlapped(max_concurrent_builds=2,
                              commit_replay_cap=cap).attach(tidx)
    try:
        for idx, tuner in ((jidx, jt), (tidx, tt)):
            _overlapped_tape(idx, tuner, keys, plans, cap)
    finally:
        jt.close()
        tt.close()
    st = tt.stats()
    assert st["commits"] == jt.stats()["commits"] == 4
    assert st["drained"] == jt.stats()["drained"] >= 1
    assert st["last_build_error"] is None
    assert tidx.n_shards == jidx.n_shards == 4
    assert tidx.n_replayed_ops == jidx.n_replayed_ops > 0
    np.testing.assert_array_equal(tidx.boundaries, jidx.boundaries)
    assert tidx.epoch == jidx.epoch
    assert_same_state(jidx.state, tidx.state, "overlapped tuner")
    probe = np.concatenate([keys, make_keys(4000, 52)])
    jf, jv = jidx.lookup(probe)
    tf, tv = tidx.lookup(probe)
    np.testing.assert_array_equal(jf, tf)
    np.testing.assert_array_equal(jv, tv)


def test_snapshot_stays_frozen():
    """A snapshot shares the router's tensors, so it is a freeze only while
    no op writes into a tensor in place: every tensor (and reservoir) of a
    snapshot equals, bitwise, a clone taken when it was made, after an
    insert wave, a delete wave, a subset retrain, a build from the
    snapshot and its commit."""
    keys, idx = _router(n=12_000, seed=61)
    rng = np.random.default_rng(62)
    early = np.setdiff1d(rng.integers(0, 1 << 48, 7000).astype(np.int64),
                         keys)
    idx.insert(early, early + 1)                # a BMAT to absorb later
    snap = idx.snapshot()
    frozen = [t.clone() for part in snap.state for t in part]
    reservoirs = [m.reservoir.copy() for m in snap.meta]
    new = np.setdiff1d(rng.integers(0, 1 << 48, 2000).astype(np.int64), keys)
    idx.insert(new, new + 5)
    idx.delete(keys[::7])
    worst = int(np.argmax(idx.state.bmat.size.numpy()))
    assert idx.retrain_subset() > 0
    delta = build(_plan(A_RETRAIN_SHARD, worst), snap)
    now = [t for part in snap.state for t in part]
    assert len(now) == len(frozen)
    for i, (a, b) in enumerate(zip(now, frozen)):
        assert a.dtype == b.dtype and torch.equal(a, b), f"leaf {i} changed"
    for a, b in zip(snap.meta, reservoirs):
        np.testing.assert_array_equal(a.reservoir, b)
    assert not idx.commit(delta)  # the subset retrain revised that shard
    f, v = idx.lookup(new)
    assert f.all() and np.array_equal(v, new + 5)
