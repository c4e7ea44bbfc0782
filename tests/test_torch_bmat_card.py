"""The standalone BMAT on the card (skipped without one), and the seeded
op tape that ``tests/test_torch_bmat.py`` also runs against the JAX
``BMAT`` on the CPU. No JAX here: the card's observations are held to the
port's own on the CPU, exactly."""
import numpy as np
import pytest
import torch

from repro_torch.core.bmat import BMAT, BPMAT, RBMAT


def bmat_tape(seed: int, steps: int = 14):
    """A seeded sequence of merges (fresh keys, overwrites and in-batch
    duplicates), deletes (hits and misses), compacts and range removals,
    with the probe queries read after each op. The tape depends on the seed
    only, never on the BMAT it is run on."""
    r = np.random.default_rng(seed)
    merged = np.zeros(0, dtype=np.int64)
    tape = []
    for _ in range(steps):
        p = r.random()
        if p < 0.5:
            ks = r.integers(0, 1 << 30, int(r.integers(1, 1500)))
            if len(merged) and r.random() < 0.5:  # overwrite some keys
                ks = np.concatenate([ks, r.choice(merged, 200)])
            vs = r.integers(0, 1 << 30, len(ks))
            tape.append(("merge", ks.astype(np.int64), vs.astype(np.int64)))
            merged = np.union1d(merged, ks)
        elif p < 0.75:
            d = r.integers(0, 1 << 30, 100)
            if len(merged):
                d = np.concatenate([d, r.choice(merged, len(merged) // 4)])
            tape.append(("delete", d.astype(np.int64)))
        elif p < 0.9:
            tape.append(("compact",))
        else:
            lo = int(r.integers(0, 1 << 30))
            tape.append(("remove_range", lo, lo + int(r.integers(1, 1 << 27))))
    probes = r.integers(0, 1 << 30, 400).astype(np.int64)
    return tape, probes, merged


def run_tape(b, tape, probes, merged):
    """Apply ``tape`` to ``b`` and return what it observes after each op:
    ranks and lookups of the probes and of every key ever merged, the live
    entries whole and inside a range, the range bounds, the delete masks,
    and the sizes, height and memory."""
    obs = []
    lo, hi = int(probes[0]) >> 1, (int(probes[0]) >> 1) + (1 << 28)
    for op in tape:
        if op[0] == "merge":
            b.merge(op[1], op[2])
        elif op[0] == "delete":
            obs.append(b.delete(op[1]))
        elif op[0] == "compact":
            b.compact()
        else:
            b.remove_range(op[1], op[2])
        q = np.concatenate([probes, merged])
        obs.extend([b.rank(q), *b.lookup(q), *b.extract(), *b.extract(lo, hi),
                    *b.range_bounds(probes, probes + (1 << 24))])
        obs.append(np.asarray([b.size, b.live_size, b.capacity, b.height,
                               b.memory_bytes(), b.memory_bytes(modeled=True)]))
    return obs


def assert_same_obs(a, b, what):
    assert len(a) == len(b), what
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype, (what, i, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=f"{what}: observation {i}")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("tt", [RBMAT, BPMAT])
def test_bmat_tape_on_cuda_matches_cpu(cuda, tt):
    """The same seeded tape on the card and on the CPU: every observation
    equal, and the card's state never leaves the card."""
    tape, probes, merged = bmat_tape(5)
    card = BMAT(tt, fanout=16, device=cuda)
    want = run_tape(BMAT(tt, fanout=16, device="cpu"), tape, probes, merged)
    got = run_tape(card, tape, probes, merged)
    assert_same_obs(want, got, f"{tt} card against CPU")
    assert all(t.device.type == "cuda" for t in card.state)
