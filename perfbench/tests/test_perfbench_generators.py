"""The keys and waves come from the seed alone."""
import numpy as np
import perfbench_testlib  # noqa: F401 — the import paths

from perfharness import keys


def _tape(seed, rate=0.1, shift=False, n=50_000):
    k = keys.make_wikits(n, seed)
    return keys.WaveTape(k, init_frac=0.5, batch=512, write_rate=rate,
                         seed=seed, distribution_shift=shift)


def test_datasets_repeat_for_a_seed():
    for make in keys.DATASETS.values():
        a, b = make(30_000, 5_000_000_001), make(30_000, 5_000_000_001)
        assert np.array_equal(a, b)
        assert len(np.unique(a)) == len(a) == 30_000
        assert np.all(np.diff(a) > 0) and a[0] >= 0 and a[-1] < 1 << 52
        assert not np.array_equal(a, make(30_000, 7))


def test_waves_repeat_for_a_seed():
    t1, t2, t3 = _tape(11), _tape(11), _tape(12)
    assert np.array_equal(t1.init_keys, t2.init_keys)
    for _ in range(40):
        r1, i1 = t1.next_wave()
        r2, i2 = t2.next_wave()
        r3, _ = t3.next_wave()
        assert np.array_equal(r1, r2) and np.array_equal(i1, i2)
    assert not np.array_equal(r1, r3)


def test_reads_are_known_and_inserts_unseen():
    t = _tape(13)
    known = set(t.init_keys.tolist())
    inserted = set()
    for w in range(200):
        reads, ins = t.next_wave()
        assert len(reads) + len(ins) == 512 and len(ins) == 51
        assert set(reads.tolist()) <= known | inserted
        assert not (set(ins.tolist()) & (known | inserted))
        inserted |= set(ins.tolist())
    # the read pool grows with the inserts, as WorkloadRunner's does
    assert t._known_ins > 0


def test_shift_inserts_above_the_loaded_keys():
    t = _tape(14, rate=0.5, shift=True)
    top = t.init_keys.max()
    for _ in range(20):
        _, ins = t.next_wave()
        assert ins.min() > top


def test_read_only_draws_no_inserts():
    t = _tape(15, rate=0.0)
    reads, ins = t.next_wave()
    assert len(ins) == 0 and len(reads) == 512
