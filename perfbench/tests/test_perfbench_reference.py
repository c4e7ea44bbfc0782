"""The reference against a sorted-dict oracle on a short tape."""
import numpy as np
import perfbench_testlib  # noqa: F401 — the import paths

from reference import Reference, contents_mismatch, count_wrong


def test_reference_matches_a_dict_oracle():
    rng = np.random.default_rng(4)
    base = np.unique(rng.integers(0, 500, 200))
    vals = base * 3 + 1
    ref = Reference(base, vals)
    oracle = dict(zip(base.tolist(), vals.tolist()))
    queries = []
    seq = 0
    for step in range(300):
        kind = rng.integers(3)
        ks = rng.integers(0, 600, int(rng.integers(1, 6)))
        if kind == 0:
            vs = rng.integers(0, 10**6, len(ks))
            ref.insert(ks, vs, seq)
            for k, v in zip(ks.tolist(), vs.tolist()):
                oracle[k] = v
        elif kind == 1:
            want = np.asarray([k in oracle for k in ks.tolist()])
            queries.append(("delete", ks, seq, want))
            ref.delete(ks, seq)
            for k in ks.tolist():
                oracle.pop(k, None)
        else:
            want_f = np.asarray([k in oracle for k in ks.tolist()])
            want_v = np.asarray([oracle.get(k, 0) for k in ks.tolist()])
            queries.append(("lookup", ks, seq, (want_f, want_v)))
        seq += 1
    for kind, ks, s, want in queries:
        if kind == "delete":
            # a batch that deletes a key twice sees it live both times,
            # as one batch of the index would
            assert np.array_equal(ref.delete_hits(ks, s), want)
        else:
            f, v = ref.lookup(ks, s)
            assert np.array_equal(f, want[0]) and np.array_equal(v, want[1])
    keys, vals = ref.contents()
    ok = sorted(oracle.items())
    assert keys.tolist() == [k for k, _ in ok]
    assert vals.tolist() == [v for _, v in ok]
    assert ref.size() == len(oracle)


def test_the_size_before_a_sequence_counts_only_earlier_writes():
    ref = Reference(np.array([1, 2, 3]), np.array([10, 20, 30]))
    ref.insert(np.array([4, 5]), np.array([40, 50]), 1)
    ref.delete(np.array([1]), 3)
    ref.insert(np.array([6]), np.array([60]), 5)
    assert [ref.size(before=s) for s in (0, 1, 2, 4, 6)] == [3, 3, 5, 4, 5]
    assert ref.size() == 5


def test_a_later_write_of_one_batch_wins():
    ref = Reference(np.array([1, 2]), np.array([10, 20]))
    ref.insert(np.array([2, 2]), np.array([21, 22]), 0)
    f, v = ref.lookup(np.array([2]), 1)
    assert f[0] and v[0] == 22
    f, v = ref.lookup(np.array([2]), 0)      # a read of the same sequence
    assert f[0] and v[0] == 20               # does not see the write


def test_mismatch_counts():
    assert count_wrong([True, False], [5, 0], [True, False], [5, 9]) == 0
    assert count_wrong([True, True], [5, 1], [True, False], [6, 0]) == 2
    k = np.array([1, 2, 3])
    assert contents_mismatch(k, k, k, k) == 0
    assert contents_mismatch(k[:2], k[:2], k, k) == 1
    assert contents_mismatch(k, k + np.array([0, 1, 0]), k, k) == 1
    assert contents_mismatch(np.array([1, 1, 2, 3]), np.array([1, 1, 2, 3]),
                             k, k) == 1
