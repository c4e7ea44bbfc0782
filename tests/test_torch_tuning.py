"""The port's self-tuning loop against the JAX package, on the CPU.

``fit_gmm`` and the forecaster's float64 numpy E-step must equal the JAX
ones (to rounding, and exactly); the forecaster's kernel path (K3's plain
version here) must match the JAX forecaster's Pallas path in interpret
mode within float32 tolerance. Telemetry signals, the controller's masks,
choices and Q-updates must equal the JAX controller's on the same router
state. A closed sync tuning loop must never change what a lookup returns,
and a K3 failure must surface, not quietly turn the kernel off.
"""
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401 — x64
import jax.numpy as jnp
from repro.core import ShardedUpLIF as JaxRouter
from repro.core.gmm import fit_gmm as jax_fit_gmm
from repro.core.uplif import UpLIFConfig as JaxConfig
from repro.tuning import ControllerConfig as JaxControllerConfig
from repro.tuning import ForecastConfig as JaxForecastConfig
from repro.tuning import ShardTuningController as JaxController
from repro.tuning import Telemetry as JaxTelemetry
from repro.tuning import UpdateForecaster as JaxForecaster
from repro.tuning import shard_signals as jax_shard_signals
from repro_torch.core import ShardedUpLIF, UpLIFConfig
from repro_torch.core.gmm import fit_gmm
from repro_torch.kernels import gmm_estep as k3
from repro_torch.tuning import (
    ControllerConfig,
    ForecastConfig,
    SchedulerConfig,
    SelfTuner,
    ShardTuningController,
    Telemetry,
    TunerConfig,
    UpdateForecaster,
    shard_signals,
)
from repro_torch.tuning.controller import locate_candidates
from tests.conftest import make_keys
from tests.test_torch_sharded import to_port


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stream(seed, n_batches=12):
    """Insert batches whose distribution shifts half way; one batch is
    above ``max_batch`` so the subsampling draws from the forecaster's rng."""
    r = np.random.default_rng(seed)
    out = []
    for i in range(n_batches):
        n = 9000 if i == 3 else 1024
        if i < n_batches // 2:
            out.append(r.integers(0, 1 << 40, n))
        else:
            out.append(r.normal(0.8 * (1 << 40), 1 << 34, n).astype(np.int64))
    return out


def test_fit_gmm_matches_jax():
    r = np.random.default_rng(0)
    keys = np.concatenate([r.normal(1e12, 3e10, 3000),
                           r.normal(5e12, 1e11, 5000),
                           r.uniform(0, 8e12, 2000)]).astype(np.int64)
    for k in (2, 4):
        want = jax_fit_gmm(jnp.asarray(keys, dtype=jnp.float64), k)
        got = fit_gmm(keys, k)
        for a, b in zip(want, got):
            assert b.dtype == torch.float64
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-9)


def test_forecaster_numpy_path_matches_jax_exactly():
    lo, hi = 0.0, float(1 << 40)
    jf = JaxForecaster(lo, hi, JaxForecastConfig(use_pallas=False, seed=3))
    tf = UpdateForecaster(lo, hi, ForecastConfig(seed=3), device="cpu")
    assert tf.cfg.use_kernel is False  # None -> no native kernels on the CPU
    bounds = np.array([1 << 38, 1 << 39, 3 << 38], dtype=np.int64)
    for batch in _stream(4):
        jf.observe(batch)
        tf.observe(batch)
        for a, b in zip(jf.gmm, tf.gmm):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        for a, b in ((jf._s0, tf._s0), (jf._s1, tf._s1), (jf._s2, tf._s2)):
            np.testing.assert_array_equal(a, b)
        assert jf.drift_ewma == tf.drift_ewma and jf.ready == tf.ready
        np.testing.assert_array_equal(jf.shard_mass(bounds),
                                      tf.shard_mass(bounds))
        assert jf.bmat_presize(bounds, 5000) == tf.bmat_presize(bounds, 5000)
        assert jf.imbalance(bounds) == tf.imbalance(bounds)
        assert jf.hottest_shard(bounds) == tf.hottest_shard(bounds)
    keys = np.arange(0, 1 << 40, 1 << 28, dtype=np.int64)
    np.testing.assert_array_equal(
        jf.gap_sizes(keys, alpha_target=1.0, d_max=16),
        tf.gap_sizes(keys, alpha_target=1.0, d_max=16),
    )


@pytest.mark.parametrize("n_components", [4, 16, 33])
def test_forecaster_kernel_path_matches_jax_pallas(n_components):
    """The port's kernel path (K3's plain version on the CPU) against the
    JAX forecaster's Pallas E-step in interpret mode, on the same mixture
    and samples, within the float32 tolerance of ``tests/test_kernels.py``;
    K 16 and 33 are where the CUDA kernel takes a 16-lane group and a warp
    per sample."""
    lo, hi = 0.0, float(1 << 40)
    jf = JaxForecaster(lo, hi, JaxForecastConfig(
        n_components=n_components, use_pallas=True, seed=1))
    tf = UpdateForecaster(lo, hi, ForecastConfig(
        n_components=n_components, use_kernel=True, seed=1), device="cpu")
    r = np.random.default_rng(5)
    for step in range(3):
        x = r.integers(0, 1 << 40, 700).astype(np.float64)
        want = jf._responsibilities(x)
        assert jf.cfg.use_pallas, "the JAX Pallas path degraded"
        got = tf._responsibilities(x)
        assert got.dtype == np.float64 and got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5)
        np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-5)
        batch = r.normal(0.3 * (1 << 40), 1 << 35, 600).astype(np.int64)
        jf.observe(batch)
        tf.observe(batch)
        # a component holding under a millionth of a sample has no mean:
        # its M-step divides float32-underflowed sums by the EM floor (none
        # at K = 4; 4 of 16 and 17 of 33 here), so the mixtures are held to
        # each other on the components that hold samples
        live = jf._s0 >= 1e-6
        np.testing.assert_array_equal(tf._s0 >= 1e-6, live)
        assert live.sum() >= 4
        for a, b in zip(jf.gmm, tf.gmm):
            np.testing.assert_allclose(b.numpy()[live], np.asarray(a)[live],
                                       rtol=1e-4)


@pytest.mark.gpu
def test_forecaster_on_cuda_with_16_components():
    """A forecaster on the card (K3 by default there) with 16 components,
    where the kernel gives a sample a 16-lane group, against the same
    forecaster on the CPU (K3's plain version): responsibilities within
    1e-5, the mixtures within 1e-4 on the components that hold samples."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lo, hi = 0.0, float(1 << 40)
    gpu = UpdateForecaster(lo, hi, ForecastConfig(n_components=16, seed=1),
                           device="cuda")
    cpu = UpdateForecaster(lo, hi, ForecastConfig(
        n_components=16, use_kernel=True, seed=1), device="cpu")
    assert gpu.cfg.use_kernel
    r = np.random.default_rng(5)
    before = k3.gmm_estep.launches
    for _ in range(3):
        x = r.integers(0, 1 << 40, 700).astype(np.float64)
        np.testing.assert_allclose(gpu._responsibilities(x),
                                   cpu._responsibilities(x), atol=1e-5)
        batch = r.normal(0.3 * (1 << 40), 1 << 35, 600).astype(np.int64)
        gpu.observe(batch)
        cpu.observe(batch)
        live = cpu._s0 >= 1e-6
        np.testing.assert_array_equal(gpu._s0 >= 1e-6, live)
        for a, b in zip(cpu.gmm, gpu.gmm):
            np.testing.assert_allclose(b.numpy()[live], a.numpy()[live],
                                       rtol=1e-4)
    assert k3.gmm_estep.launches == before + 6


def test_k3_failure_raises_from_observe(monkeypatch):
    """No silent degrade: a failing K3 wrapper makes ``observe`` raise and
    leaves the kernel path switched on."""
    calls = []

    def broken(*args):
        calls.append(1)
        raise RuntimeError("gmm_estep: CUDA launch failed with error 98")

    monkeypatch.setattr(k3, "gmm_estep", broken)
    fc = UpdateForecaster(0.0, 1e6, ForecastConfig(use_kernel=True),
                          device="cpu")
    with pytest.raises(RuntimeError, match="launch failed"):
        fc.observe(np.arange(0, 1000, 3))
    assert calls and fc.cfg.use_kernel
    assert fc.n_obs == 0


def _routers(n=8000, seed=7, shards=4):
    keys = make_keys(n, seed)
    jidx = JaxRouter(keys, keys * 2, JaxConfig(batch_bucket=256),
                     n_shards=shards)
    r = np.random.default_rng(seed)
    hot = np.unique(r.integers(int(keys[10]), int(keys[40]), 3000))
    jidx.insert(hot, hot + 1)
    jidx.delete(keys[::13])
    jidx.lookup(keys[:600])
    return keys, jidx, to_port(jidx)


def test_telemetry_and_controller_match_jax():
    keys, jidx, tidx = _routers()
    js, ts = jax_shard_signals(jidx.state), shard_signals(tidx.state)
    for a, b in zip(js, ts):
        a = np.asarray(a)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)

    jsnap, tsnap = JaxTelemetry().snapshot(jidx), Telemetry().snapshot(tidx)
    for f in ("n_keys", "n_bmat_live", "bmat_size", "bmat_fill", "occupancy",
              "n_overflow", "min_granularity", "bmat_height", "alpha",
              "n_models"):
        np.testing.assert_array_equal(getattr(jsnap, f), getattr(tsnap, f))
    assert jsnap.bmat_type == tsnap.bmat_type
    assert jsnap.memory_ewma == tsnap.memory_ewma
    assert jsnap.locate_strategy == tsnap.locate_strategy
    assert locate_candidates(tidx.device) == ("spline", "binsearch")
    assert locate_candidates("cuda") == ("spline", "binsearch", "fused")
    # the lookup latencies are wall-clock measurements: feed both the same
    for snap in (jsnap, tsnap):
        snap.locate_lat = {(0, "spline"): 3e-6, (0, "binsearch"): 1e-6,
                           (2, "spline"): 2e-6}

    heats = [np.full(4, 0.25), np.array([0.7, 0.1, 0.1, 0.1]),
             np.array([0.05, 0.05, 0.1, 0.8])]
    cfg = dict(seed=3, min_split_keys=1000, merge_max_keys=4000)
    jc = JaxController(JaxControllerConfig(**cfg))
    tc = ShardTuningController(ControllerConfig(**cfg))
    prev = None
    for step in range(12):
        heat = heats[step % 3]
        s = jc.focus_shard(jsnap, heat)
        assert s == tc.focus_shard(tsnap, heat)
        st = jc.encode(jsnap, s, heat)
        assert st == tc.encode(tsnap, s, heat)
        mask = jc.action_mask(jsnap, s)
        np.testing.assert_array_equal(mask, tc.action_mask(tsnap, s))
        assert jc.pick_locate(jsnap, s) == tc.pick_locate(tsnap, s)
        assert jc.coldest_pair(jsnap) == tc.coldest_pair(tsnap)
        a = jc.choose(st, mask, snap=jsnap, s=s, heat=heat)
        assert a == tc.choose(st, mask, snap=tsnap, s=s, heat=heat)
        if prev is not None:
            r = 0.1 * step - 0.3
            assert jc.reward(1e5 * step, 1e6, 0.0) == tc.reward(
                1e5 * step, 1e6, 0.0)
            jc.update(*prev, r, st, mask)
            tc.update(*prev, r, st, mask)
        prev = (st, a)
    assert jc.q.keys() == tc.q.keys()
    for k in jc.q:
        np.testing.assert_array_equal(jc.q[k], tc.q[k])
    assert jc.epsilon == tc.epsilon
    np.testing.assert_array_equal(jc.action_counts, tc.action_counts)


def test_sync_tuner_closed_loop_preserves_semantics():
    """The sync SelfTuner on a shifting stream: whatever it does, every
    lookup matches a dict oracle, and maintenance actually ran."""
    keys = make_keys(20_000, 9)
    idx = ShardedUpLIF(keys, keys * 2, UpLIFConfig(batch_bucket=256),
                       n_shards=4, device="cpu")
    tuner = SelfTuner(TunerConfig(
        controller=ControllerConfig(seed=0, min_split_keys=2048,
                                    merge_max_keys=2048, epsilon=0.5),
        forecast=ForecastConfig(min_obs=128, seed=0),
        scheduler=SchedulerConfig(decide_every=2, max_budget_s=60.0,
                                  budget_fraction=1.0),
    )).attach(idx)
    assert tuner.forecaster.lo == float(keys[0])
    assert tuner.forecaster.hi == float(keys[-1])
    assert not tuner.forecaster.cfg.use_kernel
    oracle = dict(zip(keys.tolist(), (keys * 2).tolist()))
    rng = np.random.default_rng(5)
    base = int(keys.max())
    for wave in range(16):
        ins = np.unique((base + rng.integers(1, 1 << 30, 700)).astype(np.int64))
        if wave % 2:
            ins = np.concatenate([ins, rng.choice(keys, 100)])
        idx.insert(ins, ins + wave)
        oracle.update(zip(ins.tolist(), (ins + wave).tolist()))
        if wave % 4 == 3:
            dead = rng.choice(np.fromiter(oracle, np.int64), 200, replace=False)
            idx.delete(dead)
            for k in dead.tolist():
                oracle.pop(k)
        probe = rng.choice(np.fromiter(oracle, np.int64), 800)
        f, v = idx.lookup(probe)
        assert f.all()
        np.testing.assert_array_equal(v, [oracle[k] for k in probe.tolist()])
        tuner.observe_inserts(ins)
        tuner.after_wave(1500, 1.0)
    allk = np.fromiter(oracle, np.int64)
    f, v = idx.lookup(allk)
    assert f.all()
    np.testing.assert_array_equal(v, [oracle[k] for k in allk.tolist()])
    assert idx.size == len(oracle)
    st = tuner.stats()
    assert st["waves"] == 16 and st["forecast_obs"] > 0
    assert st["commits"] >= 1 and st["commits"] == idx.n_commits
    assert not st["async_build"] and st["last_build_error"] is None
    tuner.close()


def test_async_pieces_wait_for_their_slice():
    """The overlapped tuner (async builds on the executor's two workers,
    paced commits) runs a shifting stream and drains: every build lands,
    lookups match a dict oracle, and no build failed."""
    tuner = SelfTuner.overlapped(
        TunerConfig(
            controller=ControllerConfig(seed=0),
            forecast=ForecastConfig(min_obs=128, seed=0),
            scheduler=SchedulerConfig(decide_every=2, force_absorb_fill=0.3,
                                      budget_fraction=1.0),
        ),
        max_concurrent_builds=2, commit_replay_cap=256,
    )
    assert tuner.cfg.scheduler.async_build
    keys = make_keys(12_000, 13)
    idx = ShardedUpLIF(keys, keys * 2, UpLIFConfig(batch_bucket=256),
                       n_shards=4, device="cpu")
    tuner.attach(idx)
    assert tuner.scheduler.executor.n_workers == 2
    oracle = dict(zip(keys.tolist(), (keys * 2).tolist()))
    rng = np.random.default_rng(14)
    base = int(keys.max())
    for wave in range(10):
        ins = np.unique((base + rng.integers(1, 1 << 30, 600)).astype(np.int64))
        idx.insert(ins, ins + wave)
        oracle.update(zip(ins.tolist(), (ins + wave).tolist()))
        tuner.observe_inserts(ins)
        tuner.after_wave(600, 0.5)
    tuner.drain(timeout=60.0)
    st = tuner.stats()
    assert st["async_build"] and st["max_concurrent_builds"] == 2
    assert st["commit_replay_cap"] == 256
    assert st["plans"] >= 1 and st["commits"] >= 1
    assert st["commits"] == idx.n_commits and not idx.draining
    assert st["last_build_error"] is None and not idx._logs
    allk = np.fromiter(oracle, np.int64)
    f, v = idx.lookup(allk)
    assert f.all()
    np.testing.assert_array_equal(v, [oracle[k] for k in allk.tolist()])
    tuner.close()
    assert not any(t.is_alive() for t in tuner.scheduler.executor._threads)
