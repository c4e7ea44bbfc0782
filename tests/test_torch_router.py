"""The port's sharded router against the JAX router, on the CPU.

Both routers are built from the same keys by their own bulk loads and run
the same op tape with scripted maintenance: a mixed per-shard locate
assignment, split, merge, a shard retrain with a fixed GMM, the BMAT
switch and a presize. Every result, overflow count, boundary, static
configuration and stacked array must agree, byte for byte. On the CPU the
JAX fused strategy runs its Pallas kernels in interpret mode and the
port's runs the kernels' plain versions.
"""
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401 — x64
import jax.numpy as jnp
from repro.core import ShardedUpLIF as JaxRouter
from repro.core.types import GMMState as JaxGMM
from repro.core.uplif import UpLIFConfig as JaxConfig
from repro_torch.core import ShardedUpLIF, UpLIFConfig
from repro_torch.core.types import GMMState
from tests.conftest import make_keys
from tests.test_torch_sharded import assert_same_state


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fixed_gmm(lo, hi):
    w = np.array([0.1, 0.2, 0.3, 0.4])
    mu = lo + (hi - lo) * np.array([0.1, 0.35, 0.6, 0.9])
    sd = (hi - lo) * np.array([0.05, 0.1, 0.08, 0.2])
    return (JaxGMM(*(jnp.asarray(a) for a in (w, mu, sd))),
            GMMState(*(torch.tensor(a) for a in (w, mu, sd))))


def test_router_tape_matches_jax():
    """The same op tape and scripted maintenance through both routers,
    each built from the same keys by its own bulk load."""
    keys = make_keys(6000, 31)
    r = np.random.default_rng(32)
    jidx = JaxRouter(keys, keys + 1, JaxConfig(batch_bucket=256,
                                               locate="fused"), n_shards=3)
    tidx = ShardedUpLIF(keys, keys + 1, UpLIFConfig(batch_bucket=256,
                                                    locate="fused"),
                        n_shards=3, device="cpu")
    jg, tg = _fixed_gmm(float(keys[0]), float(keys[-1]))
    fresh = np.setdiff1d(r.integers(0, int(keys[-1]), 6000), keys)
    hot = r.integers(int(keys[2000]), int(keys[2030]), 600)
    probes = np.concatenate([keys[::11], fresh[::7], hot[::5],
                             r.integers(0, 1 << 50, 200)])

    def ins(a):
        return lambda idx, _: idx.insert(a, a + 5)

    tape = [
        ("insert", ins(fresh[:2000])),
        ("locate", lambda idx, _: idx.set_shard_locate(1, "binsearch")),
        ("insert hot", ins(hot)),
        ("delete", lambda idx, _: idx.delete(
            np.concatenate([keys[:300], fresh[:100], hot[:40]]))),
        ("split", lambda idx, _: idx.split_shard(0)),
        ("insert", ins(fresh[2000:3500])),
        ("retrain", lambda idx, g: idx.retrain_shard(2, g)),
        ("merge", lambda idx, _: idx.merge_shards(1)),
        ("locate", lambda idx, _: idx.set_shard_locate(0, "spline")),
        ("switch", lambda idx, _: idx.switch_bmat_type()),
        ("presize", lambda idx, _: idx.presize_bmat(
            2 * int(idx.state.bmat.keys.shape[1]))),
        ("insert", ins(np.concatenate([fresh[3500:], hot[:100]]))),
        ("delete", lambda idx, _: idx.delete(fresh[::3])),
    ]
    assert_same_state(jidx.state, tidx.state, "bulk load")
    for name, step in tape:
        out_j = step(jidx, jg)
        out_t = step(tidx, tg)
        np.testing.assert_array_equal(np.asarray(out_j), np.asarray(out_t),
                                      err_msg=name)
        assert tidx._static()._asdict() == jidx._static()._asdict(), name
        np.testing.assert_array_equal(jidx.boundaries, tidx.boundaries)
        assert_same_state(jidx.state, tidx.state, name)
        fj, vj = jidx.lookup(probes)
        ft, vt = tidx.lookup(probes)
        np.testing.assert_array_equal(fj, ft, err_msg=name)
        np.testing.assert_array_equal(vj, vt, err_msg=name)
    assert tidx._static().locate == ("fused", "spline")
    assert (tidx.n_shards, tidx.epoch, tidx.n_splits, tidx.n_merges) == (
        jidx.n_shards, jidx.epoch, jidx.n_splits, jidx.n_merges)
    assert tidx.size == jidx.size and tidx.measures() == jidx.measures()
    assert tidx.memory_bytes() == jidx.memory_bytes()
    assert tidx.index_bytes() == jidx.index_bytes()
