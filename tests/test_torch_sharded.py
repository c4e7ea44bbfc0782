"""The port's stacked ops and sharded router against the JAX package, on
the CPU.

The contract is identity: the stacked ops (``slookup``/``sinsert``/
``sdelete``/``srank``) return the same results and leave the same stacked
arrays, byte for byte, as the JAX ones on the same state, for every locate
strategy and for a mixed per-shard ``codes`` axis (the router-level tape
is in ``tests/test_torch_router.py``). The versioned state is held to the
JAX package's own contracts: ops logged between snapshot and commit are
replayed, and a maximally paced commit leaves the same bytes as an
unbounded one. On the CPU the JAX fused strategy runs its Pallas kernels
in interpret mode and the port's runs the kernels' plain versions.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401 — x64
import jax.numpy as jnp
from repro.core import ShardedUpLIF as JaxRouter
from repro.core import fops as jfops
from repro.core.uplif import UpLIFConfig as JaxConfig
from repro_torch.core import ShardedUpLIF, UpLIFConfig, fops
from repro_torch.core.convert import sharded_from_numpy
from repro_torch.core.types import KEY_MAX
from repro_torch.tuning import A_RETRAIN_SHARD, MaintenancePlan, build
from tests.conftest import make_keys

B = 4096  # padded batch width of the direct op calls


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps the parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(t):
    return [np.asarray(a) for a in t]


def to_port(jidx, device="cpu") -> ShardedUpLIF:
    """The port router on numpy copies of a JAX router's state."""
    st = jidx.state
    metas = [
        dict(rs_static=tuple(m.rs_static), gmm=_leaves(m.gmm), alpha=m.alpha,
             reservoir=np.asarray(m.reservoir))
        for m in jidx._meta
    ]
    return sharded_from_numpy(
        _leaves(st.slots), _leaves(st.model), _leaves(st.bmat),
        _leaves(st.counters), boundaries=jidx.boundaries, metas=metas,
        locate_per_shard=jidx.shard_locate(), bmat_kind=jidx.bmat_kind,
        rs_iters=jidx.rs_iters,
        config=UpLIFConfig(**dataclasses.asdict(jidx.cfg)), device=device,
    )


def _state_arrays(state):
    return [np.asarray(a) for part in (state.slots, state.model, state.bmat,
                                       state.counters) for a in part]


def assert_same_state(js, ts, what):
    ja, ta = _state_arrays(js), _state_arrays(ts)
    assert len(ja) == len(ta)
    for i, (x, y) in enumerate(zip(ja, ta)):
        assert x.dtype == y.dtype, f"{what}: leaf {i} dtype"
        np.testing.assert_array_equal(x, y, err_msg=f"{what}: leaf {i}")


def _pad(a, fill):
    out = np.full(B, fill, dtype=np.int64)
    out[: len(a)] = a
    return out


def _both(a, fill):
    p = _pad(a, fill)
    return jnp.asarray(p), torch.tensor(p)


def _mixed_router(keys, locate):
    """A JAX router of 3 shards; "mixed" pins one shard per strategy."""
    jidx = JaxRouter(keys, keys * 2,
                     JaxConfig(batch_bucket=256,
                               locate="fused" if locate == "mixed" else locate),
                     n_shards=3)
    if locate == "mixed":
        jidx.set_shard_locate(0, "binsearch")
        jidx.set_shard_locate(2, "spline")
        assert jidx._static().locate == ("binsearch", "fused", "spline")
    return jidx


@pytest.mark.parametrize("locate", ["binsearch", "spline", "fused", "mixed"])
def test_stacked_ops_match_jax(locate):
    keys = make_keys(6000, 21)
    jidx = _mixed_router(keys, locate)
    tidx = to_port(jidx)
    assert tidx._static()._asdict() == jidx._static()._asdict()
    assert_same_state(jidx.state, tidx.state, "converted")

    r = np.random.default_rng(22)
    fresh = np.setdiff1d(r.integers(0, int(keys[-1]) + (1 << 40), 3000),
                         keys)
    hot = r.integers(int(keys[1000]), int(keys[1040]), 500)
    js, ts = jidx.state, tidx.state
    jb, jc, jst = jidx._jbounds, jidx._jcodes, jidx._static()
    tb, tc, tst = tidx._tbounds, tidx._codes, tidx._static()
    # fresh keys, a hotspot that overflows, then duplicates, value updates
    # of slot and BMAT keys, and tombstone revivals
    batches = [
        np.concatenate([fresh[:1500], hot]),
        np.concatenate([hot[:300], hot[:300], keys[::20], fresh[:200],
                        keys[100:150]]),
    ]
    for step, ins in enumerate(batches):
        jidx._ensure_bmat_capacity(B)
        tidx._ensure_bmat_capacity(B)
        js, ts = jidx.state, tidx.state
        jq, tq = _both(ins, KEY_MAX)
        jv, tv = _both(ins * 3 + step, 0)
        js, jres = jfops.sinsert(js, jq, jv, jb, jc, static=jst)
        ts, tres = fops.sinsert(ts, tq, tv, tb, tc, static=tst)
        np.testing.assert_array_equal(np.asarray(jres.pending),
                                      tres.pending.numpy())
        assert int(jres.n_overflow) == int(tres.n_overflow)
        assert_same_state(js, ts, f"sinsert {step}")
        jidx.state, tidx.state = js, ts

        dels = np.concatenate([keys[100:130], fresh[step::7][:200],
                               hot[:50], r.integers(0, 1 << 48, 50)])
        jq, tq = _both(dels, KEY_MAX)
        js, jhit = jfops.sdelete(js, jq, jb, jc, static=jst)
        ts, thit = fops.sdelete(ts, tq, tb, tc, static=tst)
        np.testing.assert_array_equal(np.asarray(jhit), thit.numpy())
        assert_same_state(js, ts, f"sdelete {step}")
        jidx.state, tidx.state = js, ts

        probes = np.concatenate([keys[::9], fresh[::5], hot[::3], dels[::4],
                                 r.integers(0, 1 << 50, 300), [0, KEY_MAX - 1]])
        for lo in range(0, len(probes), B):
            jq, tq = _both(probes[lo:lo + B], KEY_MAX)
            jf, jv_ = jfops.slookup(js, jq, jb, jc, static=jst)
            tf, tv_ = fops.slookup(ts, tq, tb, tc, static=tst)
            np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
            np.testing.assert_array_equal(np.asarray(jv_), tv_.numpy())

    q = np.sort(r.choice(probes, 256))
    jr = jfops.srank(js, jnp.asarray(q), jb, jc, static=jst)
    tr = fops.srank(ts, torch.tensor(q), tb, tc, static=tst)
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())


def _plan(action, shard):
    return MaintenancePlan(plan_id=1, epoch=-1, wave=0, action=action,
                           shard=shard, gmm=None, cost_estimate=0.05)


def test_commit_replays_mid_build_ops():
    """Inserts and deletes that arrive between snapshot and commit survive
    the swap: the op-log replay carries them into the rebuilt shard."""
    keys = make_keys(12_000, 7)
    idx = ShardedUpLIF(keys, keys * 2, UpLIFConfig(batch_bucket=256),
                       n_shards=4, device="cpu")
    rng = np.random.default_rng(0)
    snap = idx.snapshot()
    new = np.setdiff1d(rng.integers(0, 1 << 48, 3000), keys)
    idx.insert(new, new + 7)
    dead = keys[100:200]
    idx.delete(dead)
    delta = build(_plan(A_RETRAIN_SHARD, 1), snap)
    assert idx.commit(delta)
    assert idx.epoch == 1 and idx.n_commits == 1 and idx.n_replayed_ops > 0
    f, v = idx.lookup(new)
    assert f.all() and np.array_equal(v, new + 7)
    f, _ = idx.lookup(dead)
    assert not f.any()
    keep = np.setdiff1d(keys, dead)
    f, v = idx.lookup(keep)
    assert f.all() and np.array_equal(v, keep * 2)
    # a second build over an interval revised since its snapshot is voided
    snap = idx.snapshot(shards=(2,))
    idx.split_shard(2)
    assert not idx.commit(build(_plan(A_RETRAIN_SHARD, 2), snap))
    assert idx.n_discards == 1


def test_replay_cap_differential_byte_identical():
    """Maximal pacing (replay_cap=1: one logged batch per wave) and an
    unbounded replay leave byte-identical stacked states."""
    def run(replay_cap):
        keys = make_keys(10_000, 17)
        idx = ShardedUpLIF(keys, keys * 2, UpLIFConfig(batch_bucket=256),
                           n_shards=2, device="cpu")
        rng = np.random.default_rng(18)
        snap = idx.snapshot(shards=(0,))
        for _ in range(4):
            new = np.setdiff1d(rng.integers(0, 1 << 48, 600), keys)
            idx.insert(new, new + 3)
            idx.delete(rng.choice(keys, 100, replace=False))
        assert idx.commit(build(_plan(A_RETRAIN_SHARD, 0), snap),
                          replay_cap=replay_cap)
        waves = 0
        while idx.draining:
            idx.advance_drains(replay_cap)
            waves += 1
            assert waves < 100, "drain failed to converge"
        return idx, waves

    a, waves_a = run(None)
    b, waves_b = run(1)
    assert waves_a == 0 and waves_b >= 4
    assert a.n_commits == b.n_commits == 1
    for x, y in zip(_state_arrays(a.state), _state_arrays(b.state)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.boundaries, b.boundaries)


def test_router_needs_cuda_and_later_slices_raise(monkeypatch):
    """Without CUDA the default device raises; on the CPU the range path
    answers (it arrived with the third slice), and ``retrain_subset``
    leaves the same stacked arrays as the JAX router's."""
    from repro_torch.core.sharded import MixedWave

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    keys = make_keys(3000, 5)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ShardedUpLIF(keys)
    idx = ShardedUpLIF(keys, device="cpu", n_shards=2)
    assert idx._static().locate == "spline"  # "auto" on the CPU
    k, v = idx.range_query(int(keys[10]), int(keys[20]))
    np.testing.assert_array_equal(k, keys[10:21])
    np.testing.assert_array_equal(v, keys[10:21])
    np.testing.assert_array_equal(idx.adjusted_predict(keys[:4]),
                                  np.arange(4))
    res = idx.apply_wave(MixedWave(lookup_keys=keys[:3]))
    assert res.lookup_found.all() and res.delete_hit is None
    with pytest.raises(ValueError, match="pad width"):
        idx.lookup(keys[:300], pad_to=256)
    jidx = JaxRouter(keys, None, JaxConfig(), n_shards=2)
    new = np.setdiff1d(np.random.default_rng(6).integers(
        int(keys[0]), int(keys[-1]), 2000).astype(np.int64), keys)
    for r in (jidx, idx):
        r.insert(new, new + 1)
    assert idx.retrain_subset() == jidx.retrain_subset()
    assert idx.epoch == jidx.epoch == 1
    assert_same_state(jidx.state, idx.state, "retrain_subset")
