"""The port's standalone BMAT against the JAX ``BMAT`` on the CPU.

Every contract of ``tests/test_bmat.py`` is held on the port with the same
numpy inputs, for both tree types at fanouts 16 and 128: rank against
searchsorted, lookups and overwritten values, last-wins dedup within a
batch, tombstone delete and compact, growth from ``capacity=4096`` and
``switch_type``; a seeded tape of merges, deletes, compacts and range
removals stands in for the hypothesis property. ``extract(lo, hi)``,
``remove_range``, ``range_bounds``, ``live_size``, ``height`` and
``memory_bytes`` (modeled or not) must equal the reference's exactly, and
so must the state arrays themselves.
"""
import numpy as np
import pytest

import repro.core  # noqa: F401 — x64
from repro.core.bmat import BMAT as JaxBMAT
from repro_torch.core.bmat import BMAT, BPMAT, RBMAT
from tests.conftest import make_keys
from tests.test_torch_bmat_card import assert_same_obs, bmat_tape, run_tape

KINDS = [(tt, fo) for tt in (RBMAT, BPMAT) for fo in (16, 128)]
IDS = [f"{tt}-f{fo}" for tt, fo in KINDS]


def _pair(tt, fo, **kw):
    return JaxBMAT(tt, fanout=fo, **kw), BMAT(tt, fanout=fo, device="cpu", **kw)


def _same_state(j, t):
    for name in ("keys", "vals", "fences", "size"):
        np.testing.assert_array_equal(
            np.asarray(getattr(j.state, name)),
            getattr(t.state, name).numpy(), err_msg=name)
    assert (j.size, j.live_size, j.capacity, j.height) == (
        t.size, t.live_size, t.capacity, t.height)
    assert j.memory_bytes() == t.memory_bytes()
    assert j.memory_bytes(modeled=True) == t.memory_bytes(modeled=True)


@pytest.mark.parametrize("tt,fo", KINDS, ids=IDS)
def test_rank_matches_searchsorted(tt, fo):
    keys = make_keys(5000, 7)
    j, t = _pair(tt, fo)
    j.merge(keys, keys + 1)
    t.merge(keys, keys + 1)
    q = np.random.default_rng(8).integers(0, 1 << 48, 3000).astype(np.int64)
    got = t.rank(q)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.searchsorted(keys, q, side="left"))
    np.testing.assert_array_equal(got, j.rank(q))
    _same_state(j, t)


@pytest.mark.parametrize("tt,fo", KINDS, ids=IDS)
def test_lookup_and_value_update(tt, fo):
    keys = make_keys(2000, 9)
    j, t = _pair(tt, fo)
    for b in (j, t):
        b.merge(keys, keys * 2)
    f, v = t.lookup(keys[::3])
    assert f.all() and np.array_equal(v, keys[::3] * 2)
    for b in (j, t):  # overwrite values
        b.merge(keys[:100], keys[:100] * 5)
    f, v = t.lookup(keys[:100])
    assert f.all() and np.array_equal(v, keys[:100] * 5)
    assert t.size == len(keys)  # no duplicates created
    absent = np.setdiff1d(
        np.random.default_rng(1).integers(0, 1 << 48, 500), keys
    )
    f, v = t.lookup(absent)
    assert not f.any() and not v.any()
    for q in (keys, absent):
        for x, y in zip(j.lookup(q), t.lookup(q)):
            np.testing.assert_array_equal(x, y)
    _same_state(j, t)


@pytest.mark.parametrize("tt,fo", KINDS, ids=IDS)
def test_batch_dedup_last_wins(tt, fo):
    j, t = _pair(tt, fo)
    k = np.asarray([5, 5, 9, 9, 9], dtype=np.int64)
    v = np.asarray([1, 2, 3, 4, 5], dtype=np.int64)
    for b in (j, t):
        b.merge(k, v)
    f, vals = t.lookup(np.asarray([5, 9], dtype=np.int64))
    assert f.all()
    assert vals[0] == 2 and vals[1] == 5
    assert t.size == 2
    _same_state(j, t)


@pytest.mark.parametrize("tt,fo", KINDS, ids=IDS)
def test_tombstone_delete_and_compact(tt, fo):
    keys = make_keys(1000, 11)
    j, t = _pair(tt, fo)
    for b in (j, t):
        b.merge(keys, keys)
    probe = np.concatenate([keys[:250], np.asarray([3, 1 << 50], np.int64)])
    hit = t.delete(probe)
    np.testing.assert_array_equal(hit, j.delete(probe))
    assert hit[:250].all() and not hit[250:].any()
    assert t.size == 1000 and t.live_size == 750
    f, _ = t.lookup(keys[:250])
    assert not f.any()
    f, _ = t.lookup(keys[250:])
    assert f.all()
    np.testing.assert_array_equal(t.delete(keys[:10]), j.delete(keys[:10]))
    assert not t.delete(keys[:10]).any()  # a tombstone is not hit again
    _same_state(j, t)
    for b in (j, t):
        b.compact()
    assert t.size == 750 and t.live_size == 750
    f, _ = t.lookup(keys[250:])
    assert f.all()
    _same_state(j, t)


@pytest.mark.parametrize("tt,fo", KINDS, ids=IDS)
def test_growth_preserves_content(tt, fo):
    j, t = _pair(tt, fo, capacity=4096)
    all_keys = []
    r = np.random.default_rng(13)
    caps = []
    for i in range(6):
        ks = np.unique(r.integers(0, 1 << 48, 3000).astype(np.int64))
        ks = np.setdiff1d(ks, np.asarray(all_keys, dtype=np.int64))
        for b in (j, t):
            b.merge(ks, ks + i)
        all_keys.extend(ks.tolist())
        caps.append(t.capacity)
        _same_state(j, t)
    assert caps[0] == 4096 and caps[-1] > 4096  # it grew
    ak = np.asarray(sorted(all_keys), dtype=np.int64)
    assert t.size == len(ak)
    f, _ = t.lookup(ak[:: max(len(ak) // 500, 1)])
    assert f.all()


@pytest.mark.parametrize("fo", [16, 128])
def test_switch_type_equivalence(fo):
    keys = make_keys(3000, 17)
    j, t = _pair(RBMAT, fo)
    for b in (j, t):
        b.merge(keys, keys)
    q = np.random.default_rng(18).integers(0, 1 << 48, 1000).astype(np.int64)
    r1 = t.rank(q)
    heights = [t.height]
    for b in (j, t):
        b.switch_type()
    assert t.tree_type == BPMAT
    heights.append(t.height)
    np.testing.assert_array_equal(r1, t.rank(q))
    np.testing.assert_array_equal(j.rank(q), t.rank(q))
    assert t.memory_bytes(modeled=True) == j.memory_bytes(modeled=True)
    t.switch_type()
    assert t.tree_type == RBMAT and t.height == heights[0]
    np.testing.assert_array_equal(r1, t.rank(q))


@pytest.mark.parametrize("tt,fo", KINDS, ids=IDS)
def test_extract_remove_range_and_bounds(tt, fo):
    keys = make_keys(4000, 23)
    j, t = _pair(tt, fo)
    for b in (j, t):
        b.merge(keys, keys * 3)
        b.delete(keys[::5])
    live = np.setdiff1d(keys, keys[::5])
    lo, hi = int(keys[1000]), int(keys[2500])
    for args in ((), (lo,), (None, hi), (lo, hi), (hi, lo)):
        jk, jv = j.extract(*args)
        tk, tv = t.extract(*args)
        np.testing.assert_array_equal(jk, tk)
        np.testing.assert_array_equal(jv, tv)
    tk, tv = t.extract(lo, hi)
    want = live[(live >= lo) & (live <= hi)]
    np.testing.assert_array_equal(tk, want)
    np.testing.assert_array_equal(tv, want * 3)
    qlo = np.random.default_rng(24).integers(0, 1 << 48, 300).astype(np.int64)
    qhi = qlo + (1 << 40)
    for x, y in zip(j.range_bounds(qlo, qhi), t.range_bounds(qlo, qhi)):
        np.testing.assert_array_equal(x, y)
    # the buffered slice: everything in [lo, hi], tombstones included
    r0, r1 = t.range_bounds(qlo, qhi)
    np.testing.assert_array_equal(r1 - r0, np.searchsorted(keys, qhi, "right")
                                  - np.searchsorted(keys, qlo, "left"))
    for b in (j, t):
        b.remove_range(lo, hi)
    _same_state(j, t)
    rest = live[(live < lo) | (live > hi)]
    tk, tv = t.extract()
    np.testing.assert_array_equal(tk, rest)
    np.testing.assert_array_equal(tv, rest * 3)
    assert t.size == t.live_size == len(rest)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("tt,fo", KINDS, ids=IDS)
def test_seeded_tape_matches_jax(tt, fo, seed):
    """The hypothesis property's stand-in: a seeded sequence of merges,
    deletes, compacts and range removals; every observation after every op
    equal to the JAX BMAT's, the ranks to searchsorted over the oracle's
    live and tombstoned keys, and the final arrays identical."""
    tape, probes, merged = bmat_tape(seed)
    j, t = _pair(tt, fo)
    assert_same_obs(run_tape(j, tape, probes, merged),
                    run_tape(t, tape, probes, merged), f"{tt} f{fo} s{seed}")
    _same_state(j, t)
    buffered = t.state.keys[: t.size].numpy()
    np.testing.assert_array_equal(
        t.rank(probes), np.searchsorted(buffered, probes, "left"))


def test_empty_bmat():
    j, t = _pair(BPMAT, 16)
    q = np.asarray([0, 5, 1 << 40], dtype=np.int64)
    np.testing.assert_array_equal(t.rank(q), [0, 0, 0])
    assert not t.lookup(q)[0].any() and not t.delete(q).any()
    for b in (j, t):
        b.merge(np.zeros(0, np.int64), np.zeros(0, np.int64))
        b.compact()
    _same_state(j, t)
    assert t.extract()[0].size == 0 and t.live_size == 0
