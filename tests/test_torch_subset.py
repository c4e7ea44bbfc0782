"""The port's subset retrain against the JAX package, on the CPU.

The contract is identity: ``fops.insert`` under its ``check_bmat`` /
``merge_overflow`` flags and ``retrain_subset`` on the index and on the
router leave the same arrays and counters and answer the same lookups,
byte for byte. (The baselines, the RL agent and the data pipeline, which
sit on the same shell, are in ``tests/test_torch_agent.py``.) On the CPU
the JAX fused strategy runs its Pallas kernels in interpret mode and the
port's runs the kernels' plain versions.
"""
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401 — x64
import jax.numpy as jnp
from repro.core import ShardedUpLIF as JaxRouter
from repro.core import UpLIF as JaxUpLIF
from repro.core import fops as jfops
from repro.core.uplif import UpLIFConfig as JaxConfig
from repro_torch.core import ShardedUpLIF, UpLIF, UpLIFConfig, fops
from tests.conftest import make_keys
from tests.test_torch_sharded import assert_same_state
from tests.test_torch_uplif import _assert_same_arrays

CFG = dict(batch_bucket=256)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps the parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_lookups(jidx, tidx, keys):
    jf, jv = jidx.lookup(keys)
    tf, tv = tidx.lookup(keys)
    np.testing.assert_array_equal(jf, tf)
    np.testing.assert_array_equal(jv, tv)
    return tf, tv


def _counters(idx):
    return [int(c) for c in idx._counters]


# ---------------------------------------------------------------------------
# fops.insert flags
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("check_bmat", [True, False])
@pytest.mark.parametrize("merge_overflow", [True, False])
def test_insert_flags_match_jax(check_bmat, merge_overflow):
    """One insert batch of slot keys, BMAT keys (a tombstoned one too),
    fresh keys and in-batch duplicates, under each flag pair: the same
    state and result as the JAX insert."""
    keys = make_keys(6000, 3)
    cfg = dict(CFG, locate="fused")
    jidx = JaxUpLIF(keys, keys * 2, JaxConfig(**cfg))
    tidx = UpLIF(keys, keys * 2, UpLIFConfig(**cfg), device="cpu")
    r = np.random.default_rng(4)
    hot = np.setdiff1d(
        (keys[2000] + r.integers(1, 1 << 20, 3000)).astype(np.int64), keys)
    for idx in (jidx, tidx):
        idx.insert(hot, hot + 1)
        idx.delete(hot[:40])
    assert jidx.bmat.size == tidx.bmat.size > 100
    bk = jidx.bmat.extract()[0]
    fresh = np.setdiff1d(r.integers(0, 1 << 48, 700).astype(np.int64), keys)
    batch = np.concatenate([r.choice(keys, 300), bk[:200], hot[:20], fresh,
                            fresh[:50]])
    r.shuffle(batch)
    vals = batch * 3 + 1
    n = 2048
    q = np.full(n, np.iinfo(np.int64).max, dtype=np.int64)
    q[:len(batch)] = batch
    v = np.zeros(n, dtype=np.int64)
    v[:len(batch)] = vals
    for idx in (jidx, tidx):
        idx._ensure_bmat_capacity(n)
    js, jr = jfops.insert(jidx.fstate, jnp.asarray(q), jnp.asarray(v),
                          static=jidx.fstatic(), check_bmat=check_bmat,
                          merge_overflow=merge_overflow)
    ts, tr = fops.insert(tidx.fstate, torch.tensor(q), torch.tensor(v),
                         static=tidx.fstatic(), check_bmat=check_bmat,
                         merge_overflow=merge_overflow)
    np.testing.assert_array_equal(np.asarray(jr.pending), tr.pending.numpy())
    assert int(jr.n_overflow) == int(tr.n_overflow)
    assert tr.n_overflow.dtype == torch.int64
    if not merge_overflow:
        assert int(tr.n_overflow) == 0 and tr.pending.any()
    jidx._adopt(js)
    tidx._adopt(ts)
    _assert_same_arrays(jidx, tidx, f"insert {check_bmat} {merge_overflow}")
    assert _counters(jidx) == _counters(tidx)
    _same_lookups(jidx, tidx, np.concatenate([batch, keys, hot]))


# ---------------------------------------------------------------------------
# retrain_subset
# ---------------------------------------------------------------------------


def test_index_retrain_subset_matches_jax():
    """The inputs of tests/test_uplif_invariants.py's retrain test: the
    absorbed count, arrays, counters and lookups equal JAX's after the
    subset retrain and again after the full retrain that follows."""
    keys = make_keys(10000, 31)
    jidx = JaxUpLIF(keys, keys + 1, JaxConfig(**CFG))
    tidx = UpLIF(keys, keys + 1, UpLIFConfig(**CFG), device="cpu")
    r = np.random.default_rng(32)
    new = np.setdiff1d(r.integers(0, 1 << 48, 6000).astype(np.int64), keys)
    r.shuffle(new)
    for idx in (jidx, tidx):
        idx.insert(new, new + 1)
        idx.delete(keys[:777])
    size0 = tidx.bmat.size
    absorbed = jidx.retrain_subset()
    assert tidx.retrain_subset() == absorbed > 0
    assert tidx.bmat.size == jidx.bmat.size < size0
    assert tidx.n_retrains == jidx.n_retrains == 1
    _assert_same_arrays(jidx, tidx, "retrain_subset")
    assert _counters(jidx) == _counters(tidx)
    live = np.concatenate([keys[777:], new])
    f, v = _same_lookups(jidx, tidx, live)
    assert f.all() and np.array_equal(v, live + 1)
    f, _ = _same_lookups(jidx, tidx, keys[:777])
    assert not f.any()
    # quantile bins over an already absorbed buffer, then the full retrain
    assert jidx.retrain_subset(quantiles=4) == tidx.retrain_subset(quantiles=4)
    _assert_same_arrays(jidx, tidx, "second retrain_subset")
    for idx in (jidx, tidx):
        idx.retrain_full()
    _assert_same_arrays(jidx, tidx, "retrain_full after subset")
    f, v = _same_lookups(jidx, tidx, live)
    assert f.all() and np.array_equal(v, live + 1)


def test_index_retrain_subset_empty_bmat():
    keys = make_keys(3000, 5)
    jidx = JaxUpLIF(keys, keys, JaxConfig(**CFG))
    tidx = UpLIF(keys, keys, UpLIFConfig(**CFG), device="cpu")
    assert jidx.retrain_subset() == tidx.retrain_subset() == 0
    assert jidx.n_retrains == tidx.n_retrains == 0
    _assert_same_arrays(jidx, tidx, "empty BMAT")


def test_router_retrain_subset_matches_jax():
    """The inputs of tests/test_fops_sharded.py's router retrain test: the
    subset retrain works on the shard with the largest BMAT and records a
    revision of its interval; the stacked arrays, counters and lookups
    equal JAX's, then again after the full retrain and the BMAT switch."""
    keys = make_keys(8000, 109)
    jidx = JaxRouter(keys, keys + 7, JaxConfig(**CFG), n_shards=3)
    tidx = ShardedUpLIF(keys, keys + 7, UpLIFConfig(**CFG), n_shards=3,
                        device="cpu")
    r = np.random.default_rng(110)
    new = np.setdiff1d(r.integers(0, 1 << 48, 4000).astype(np.int64), keys)
    for idx in (jidx, tidx):
        idx.insert(new, new + 7)
        idx.delete(keys[:500])
    worst = int(np.argmax(tidx.state.bmat.size.numpy()))
    assert jidx.retrain_subset() == tidx.retrain_subset()
    assert tidx.epoch == jidx.epoch == 1
    assert tidx.n_retrains == jidx.n_retrains == 1
    assert_same_state(jidx.state, tidx.state, "router retrain_subset")
    live = np.concatenate([keys[500:], new])
    f, v = _same_lookups(jidx, tidx, live)
    assert f.all() and np.array_equal(v, live + 7)
    f, _ = _same_lookups(jidx, tidx, keys[:500])
    assert not f.any()
    # the revision covers the worst shard's interval: a build of it is void
    snap = tidx.snapshot(shards=(worst,))
    tidx.retrain_subset()
    assert tidx._conflicts(snap.epoch, snap.key_lo, snap.key_hi)
    tidx.discard_build()
    jidx.retrain_subset()
    for idx in (jidx, tidx):
        idx.retrain_full()
        idx.switch_bmat_type()
    assert_same_state(jidx.state, tidx.state, "router retrain_full")
    f, v = _same_lookups(jidx, tidx, live)
    assert f.all() and np.array_equal(v, live + 7)
