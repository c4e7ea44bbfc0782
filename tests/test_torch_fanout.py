"""BMAT fanouts above 64 through the port's fused path, against the JAX
package, on the CPU.

The reference's BMAT takes any power-of-two fanout of 2 or more, and its
fused rank (the Pallas K2) has no bound on it. The port's K2 takes any
fanout too: a node of up to 64 keys is counted in one ballot, a wider one
by a 32-ary count. Here the port's ``UpLIF`` and ``ShardedUpLIF`` with
``locate="fused"`` at fanouts 128 and 256 are held to the JAX ones byte for
byte (bulk load, inserts, deletes, lookups, range rows, the adjusted rank,
and the slot and BMAT arrays); on the CPU the JAX side runs its Pallas
kernels in interpret mode and the port K2's plain version.
"""
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401 — x64
from repro.core import ShardedUpLIF as JaxRouter
from repro.core import UpLIF as JaxUpLIF
from repro.core.uplif import UpLIFConfig as JaxConfig
from repro_torch.core import ShardedUpLIF, UpLIF, UpLIFConfig
from repro_torch.kernels import bmat_rank as k2
from tests.conftest import make_keys
from tests.test_locate_fused import _tape
from tests.test_torch_sharded import assert_same_state
from tests.test_torch_uplif import (
    _assert_same_arrays, _range_bounds, _run_both,
)

FANOUTS = [128, 256]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("fanout", FANOUTS)
def test_uplif_wide_fanout_matches_jax(fanout):
    """The op tape of ``tests/test_locate_fused.py`` leaves about 640 keys
    in the BMAT, so the rank crosses several nodes of 128 or 256 keys."""
    base, vals, ops_tape, probes, ranges = _tape(1)
    kw = dict(locate="fused", bmat_fanout=fanout)
    jidx = JaxUpLIF(base, vals, JaxConfig(**kw))
    tidx = UpLIF(base, vals, UpLIFConfig(**kw), device="cpu")
    assert tidx.fstatic()._asdict() == jidx.fstatic()._asdict()
    assert tidx.fstatic().fanout == fanout
    _assert_same_arrays(jidx, tidx, "bulk load")
    _run_both(jidx, tidx, ops_tape, probes, _range_bounds(base, ranges))
    assert tidx.bmat.size > 2 * fanout


@pytest.mark.parametrize("fanout", FANOUTS)
def test_router_wide_fanout_matches_jax(fanout):
    """Three shards: inserts (a hotspot that overflows into the BMATs),
    deletes, lookups and the adjusted rank after every op, and the stacked
    arrays, byte for byte."""
    keys = make_keys(6000, 41)
    r = np.random.default_rng(42)
    kw = dict(batch_bucket=256, locate="fused", bmat_fanout=fanout)
    jidx = JaxRouter(keys, keys + 1, JaxConfig(**kw), n_shards=3)
    tidx = ShardedUpLIF(keys, keys + 1, UpLIFConfig(**kw), n_shards=3,
                        device="cpu")
    fresh = np.setdiff1d(r.integers(0, int(keys[-1]), 3000), keys)
    hot = r.integers(int(keys[1000]), int(keys[1010]), 900)
    probes = np.concatenate([keys[::13], fresh[::5], hot[::7],
                             r.integers(0, 1 << 50, 200)])
    tape = [
        lambda idx: idx.insert(fresh[:1500], fresh[:1500] + 5),
        lambda idx: idx.insert(hot, hot + 7),
        lambda idx: idx.delete(np.concatenate([keys[:200], hot[:100]])),
        lambda idx: idx.insert(fresh[1500:], fresh[1500:] + 9),
    ]
    assert_same_state(jidx.state, tidx.state, "bulk load")
    for step, op in enumerate(tape):
        np.testing.assert_array_equal(np.asarray(op(jidx)),
                                      np.asarray(op(tidx)), err_msg=step)
        assert_same_state(jidx.state, tidx.state, f"op {step}")
        fj, vj = jidx.lookup(probes)
        ft, vt = tidx.lookup(probes)
        np.testing.assert_array_equal(fj, ft, err_msg=f"found at op {step}")
        np.testing.assert_array_equal(vj, vt, err_msg=f"values at op {step}")
        np.testing.assert_array_equal(
            np.asarray(jidx.adjusted_predict(probes)),
            tidx.adjusted_predict(probes), err_msg=f"ranks at op {step}")
    assert tidx._static().fanout == fanout
    assert int(tidx.state.bmat.size.max()) > fanout


def test_wide_fanout_answers_every_lookup(monkeypatch):
    """20,000 random keys below 2^40, 6,000 inserts and 4,096 lookups at
    fanout 128 with the fused locate: every key is found with its value,
    and K2's wrapper ranked the BMAT at that fanout."""
    fanouts = []
    plain = k2.bmat_rank_plain

    def spy(*args, **kw):
        fanouts.append(kw["fanout"])
        return plain(*args, **kw)

    monkeypatch.setattr(k2, "bmat_rank_plain", spy)
    r = np.random.default_rng(0)
    keys = np.unique(r.integers(0, 1 << 40, 21_000))[:20_000]
    idx = UpLIF(keys, keys + 1, UpLIFConfig(bmat_fanout=128, locate="fused"),
                device="cpu")
    fresh = np.setdiff1d(r.integers(0, 1 << 40, 6_500), keys)[:6_000]
    idx.insert(fresh, fresh + 1)
    assert idx.bmat.size > 128
    pool = np.concatenate([keys, fresh])
    q = r.choice(pool, 4096)
    found, vals = idx.lookup(q)
    assert found.all()
    np.testing.assert_array_equal(vals, q + 1)
    assert fanouts and set(fanouts) == {128}
