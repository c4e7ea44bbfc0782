"""The port's range path against the JAX package, on the CPU: range scans,
the adjusted rank and mixed waves, on the single index and on the router.

The contract is identity: ``range_query``/``range_query_batch`` rows,
``adjusted_predict`` ranks, ``apply_wave`` results and the stacked arrays
after the waves are byte for byte the JAX package's, under a uniform and a
mixed per-shard locate assignment, and they agree with sorted numpy
oracles. (The single index's range rows and ranks on the op tapes of
``tests/test_locate_fused.py``, for every locate strategy and both BMAT
kinds, are checked after every op in ``tests/test_torch_uplif.py``.) On the CPU the JAX fused strategy runs its
Pallas kernels in interpret mode and the port's runs the kernels' plain
versions.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401 — x64
import jax.numpy as jnp
from repro.core import ShardedUpLIF as JaxRouter
from repro.core import UpLIF as JaxUpLIF
from repro.core import fops as jfops
from repro.core.shapes import padded_width as jax_padded_width
from repro.core.sharded import MixedWave as JaxWave
from repro.core.uplif import UpLIFConfig as JaxConfig
from repro_torch.core import ShardedUpLIF, UpLIF, UpLIFConfig, fops
from repro_torch.core.shapes import padded_width
from repro_torch.core.sharded import MixedWave, MixedWaveResult
from repro_torch.core.types import KEY_MAX
from tests.conftest import make_keys
from tests.test_torch_sharded import _mixed_router, assert_same_state, to_port
from tests.test_torch_uplif import _same_rows


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps the parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_ints(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, what
    np.testing.assert_array_equal(a, b, err_msg=what)


# ---------------------------------------------------------------------------
# single index
# ---------------------------------------------------------------------------


def test_range_query_matches_oracle():
    """The oracle of ``tests/test_uplif_invariants.py``: wide ranges after
    a shuffled insert batch return exactly the sorted keys in [lo, hi]."""
    keys = make_keys(15000, 33)
    cfg = dict(batch_bucket=512)
    jidx = JaxUpLIF(keys, keys * 2, JaxConfig(**cfg))
    tidx = UpLIF(keys, keys * 2, UpLIFConfig(**cfg), device="cpu")
    r = np.random.default_rng(34)
    new = np.setdiff1d(r.integers(0, 1 << 48, 5000).astype(np.int64), keys)
    r.shuffle(new)
    jidx.insert(new, new * 2)
    tidx.insert(new, new * 2)
    allk = np.sort(np.concatenate([keys, new]))
    for _ in range(4):
        lo = int(r.integers(0, 1 << 48))
        hi = lo + int(r.integers(1 << 38, 1 << 44))
        tk, tv = tidx.range_query(lo, hi, max_out=2048)
        want = allk[(allk >= lo) & (allk <= hi)][:2048]
        np.testing.assert_array_equal(tk, want)
        np.testing.assert_array_equal(tv, want * 2)
        jk, jv = jidx.range_query(lo, hi, max_out=2048)
        _same_rows(([jk], [jv]), ([tk], [tv]), "oracle range")


def test_adjusted_predict_is_exact_rank():
    keys = make_keys(10000, 35)
    cfg = dict(batch_bucket=512)
    jidx = JaxUpLIF(keys, keys, JaxConfig(**cfg))
    tidx = UpLIF(keys, keys, UpLIFConfig(**cfg), device="cpu")
    r = np.random.default_rng(36)
    new = np.setdiff1d(r.integers(0, 1 << 48, 3000).astype(np.int64), keys)
    r.shuffle(new)
    jidx.insert(new, new)
    tidx.insert(new, new)
    allk = np.sort(np.concatenate([keys, new]))
    q = np.concatenate([r.choice(allk, 500), r.integers(0, 1 << 49, 100)])
    pred = tidx.adjusted_predict(q)
    np.testing.assert_array_equal(pred, np.searchsorted(allk, q, "left"))
    _same_ints(jidx.adjusted_predict(q), pred, "adjusted_predict")


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("locate", ["fused", "mixed"])
def test_router_ranges_and_rank_match_jax(locate):
    """Wide ranges that straddle shard boundaries (``tests/
    test_fops_sharded.py``), under a uniform and a mixed per-shard locate
    assignment; ``adjusted_predict`` equals JAX's and, before any delete,
    the exact oracle."""
    keys = make_keys(6000, 107)
    jidx = _mixed_router(keys, locate)
    tidx = to_port(jidx)
    r = np.random.default_rng(108)
    new = np.setdiff1d(r.integers(0, 1 << 48, 3000).astype(np.int64), keys)
    r.shuffle(new)
    jidx.insert(new, new * 2)
    tidx.insert(new, new * 2)
    assert_same_state(jidx.state, tidx.state, "after insert")

    allk = np.sort(np.concatenate([keys, new]))
    q0 = np.concatenate([r.choice(allk, 400), jidx.boundaries,
                         jidx.boundaries - 1, [0, 1 << 49]])
    got = tidx.adjusted_predict(q0)
    np.testing.assert_array_equal(got, np.searchsorted(allk, q0, "left"))
    _same_ints(jidx.adjusted_predict(q0), got, "router adjusted_predict")

    dels = np.concatenate([keys[1000:1200], new[:200]])
    _same_ints(jidx.delete(dels), tidx.delete(dels), "delete hits")
    los = np.sort(r.choice(keys, 10)).astype(np.int64)
    his = los + (1 << 45)  # wide ranges span shard boundaries
    los = np.concatenate([los, jidx.boundaries - 3, [0]])
    his = np.concatenate([his, jidx.boundaries + 3, [KEY_MAX]])
    _same_rows(jidx.range_query_batch(los, his, 256),
               tidx.range_query_batch(los, his, 256), "router ranges")
    _same_ints(jidx.adjusted_predict(q0), tidx.adjusted_predict(q0),
               "adjusted_predict after deletes")
    live = np.setdiff1d(allk, dels)
    for a, b in zip(los[:4], his[:4]):
        k, v = tidx.range_query(int(a), int(b), max_out=256)
        want = live[(live >= a) & (live <= b)][:256]
        np.testing.assert_array_equal(k, want)
        np.testing.assert_array_equal(v, want * 2)


def test_srank_with_many_queries_per_slot():
    """``srank`` on a batch far larger than a shard's slot count (the
    case where the reference's [N, cap] reduce is largest relative to the
    state) equals JAX's."""
    keys = make_keys(300, 41)
    jidx = JaxRouter(keys, keys, JaxConfig(batch_bucket=256), n_shards=3)
    tidx = to_port(jidx)
    assert tidx.state.slots.keys.shape[1] <= 1024
    r = np.random.default_rng(42)
    fresh = np.setdiff1d(r.integers(0, int(keys[-1]), 200), keys)
    jidx.insert(fresh, fresh)
    tidx.insert(fresh, fresh)
    jidx.delete(keys[::5])
    tidx.delete(keys[::5])
    q = np.concatenate([r.integers(0, int(keys[-1]) + 99, 8000),
                        keys, fresh, [0, KEY_MAX]]).astype(np.int64)
    jr = jfops.srank(jidx.state, jnp.asarray(q), jidx._jbounds, jidx._jcodes,
                     static=jidx._static())
    tr = fops.srank(tidx.state, torch.tensor(q), tidx._tbounds, tidx._codes,
                    static=tidx._static())
    _same_ints(np.asarray(jr), tr.numpy(), "srank")


# ---------------------------------------------------------------------------
# mixed waves
# ---------------------------------------------------------------------------


def test_padded_width_matches_jax():
    for n in list(range(0, 2100, 7)) + [5000, 70000]:
        for floor, ceiling in ((256, None), (256, 2048), (64, 1024)):
            assert padded_width(n, floor, ceiling) == jax_padded_width(
                n, floor, ceiling)


def _waves(keys, r, n_waves=3):
    """Mixed waves that insert fresh keys, delete a few earlier inserts
    and loaded keys, look up this wave's own inserts and deletes, and scan
    ranges over them; pad widths from ``padded_width``."""
    pool = np.setdiff1d(r.integers(0, int(keys[-1]), 6000), keys)
    r.shuffle(pool)
    waves, done = [], np.zeros(0, np.int64)
    for w in range(n_waves):
        ins = pool[w * 700:(w + 1) * 700]
        dels = np.concatenate([ins[:40], done[:30], keys[w * 50:w * 50 + 20]])
        look = np.concatenate([ins, dels, r.choice(keys, 300),
                               r.integers(0, 1 << 48, 50)])
        lo = np.sort(r.choice(ins, 12))
        waves.append(dict(
            insert_keys=ins, insert_vals=ins * 3 + w, delete_keys=dels,
            lookup_keys=look, range_lo=lo, range_hi=lo + (1 << 41),
            pad_insert=padded_width(len(ins), 256, 2048),
            pad_delete=padded_width(len(dels), 256, 2048),
            pad_lookup=padded_width(len(look), 256, 2048),
            range_max_out=64,
        ))
        done = np.concatenate([done, ins[40:]])
    return waves


def test_apply_wave_matches_jax():
    """The same ``MixedWave`` sequence through both routers: the same
    ``MixedWaveResult``s and the same final stacked state. Every wave
    reads its own writes: its inserts are found with their values, its
    deletes miss, and its ranges hold its inserted keys."""
    keys = make_keys(8000, 51)
    jidx = _mixed_router(keys, "mixed")
    tidx = to_port(jidx)
    r = np.random.default_rng(52)
    for w, spec in enumerate(_waves(keys, r)):
        assert spec["pad_lookup"] in (256, 512, 1024, 2048)
        jres = jidx.apply_wave(JaxWave(**spec))
        tres = tidx.apply_wave(MixedWave(**spec))
        assert isinstance(tres, MixedWaveResult)
        assert tres.n_overflow == jres.n_overflow
        for f in ("lookup_found", "lookup_vals", "delete_hit"):
            _same_ints(getattr(jres, f), getattr(tres, f), f"wave {w}: {f}")
        _same_rows((jres.range_keys, jres.range_vals),
                   (tres.range_keys, tres.range_vals), f"wave {w}: ranges")
        ins, dels = spec["insert_keys"], spec["delete_keys"]
        n_ins = len(ins)
        found, vals = tres.lookup_found, tres.lookup_vals
        kept = ~np.isin(ins, dels)
        assert found[:n_ins][kept].all()
        np.testing.assert_array_equal(vals[:n_ins][kept],
                                      spec["insert_vals"][kept])
        assert not found[n_ins:n_ins + len(dels)].any()
        for lo, hi, ks in zip(spec["range_lo"], spec["range_hi"],
                              tres.range_keys):
            inside = ins[kept & (ins >= lo) & (ins <= hi)]
            if len(ks) < spec["range_max_out"]:
                assert np.isin(inside, ks).all()
    assert_same_state(jidx.state, tidx.state, "after the waves")
    assert dataclasses.asdict(MixedWave()) == dataclasses.asdict(JaxWave())
    assert MixedWave(**spec).n_ops == JaxWave(**spec).n_ops
