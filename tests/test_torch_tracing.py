"""The port's tracer (``repro_torch.tracing``) and the spans and counters
of the index path, on the CPU."""
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import tracing
from repro_torch.core import UpLIF, UpLIFConfig
from tests.conftest import make_keys

INSERT_SPANS = ["uplif.reservoir", "uplif.h2d", "uplif.h2d", "bmat.reserve",
                "fops.insert.place", "fops.insert.merge", "uplif.d2h"]


@pytest.fixture(autouse=True)
def _clean_tracer():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def keys():
    return make_keys(4000, seed=11, hi=1 << 40)


def _index(keys):
    return UpLIF(keys, config=UpLIFConfig(), device="cpu")


def _subtree_counts(snap, top):
    """Counts summed over the span ``top`` and every span under it."""
    spans, out = snap["spans"], {}
    under = {top}
    for i in range(top, len(spans)):
        if i == top or spans[i][1] in under:
            under.add(i)
            for k, n in spans[i][4].items():
                out[k] = out.get(k, 0) + n
    return out


def _tops(snap):
    return [i for i, s in enumerate(snap["spans"]) if s[1] == -1]


def test_off_records_nothing_allocates_nothing_and_reads_no_clock(
        monkeypatch):
    def no_clock():
        raise AssertionError("the clock was read")

    monkeypatch.setattr(tracing, "_clock", no_clock)
    tracemalloc.start()
    try:
        flt = [tracemalloc.Filter(True, tracing.__file__)]
        before = tracemalloc.take_snapshot().filter_traces(flt)
        held = []
        for _ in range(1000):
            with tracing.span("uplif.lookup") as s:
                tracing.count("host_syncs")
            held.append(s)
        after = tracemalloc.take_snapshot().filter_traces(flt)
    finally:
        tracemalloc.stop()
    grown = sum(d.size_diff for d in after.compare_to(before, "filename"))
    assert grown == 0
    assert all(s is tracing._OFF for s in held)
    assert tracing.span("a") is tracing.span("b") is tracing._OFF
    assert tracing.snapshot() == {"spans": [], "counts": {}, "dropped": 0}


def test_the_tracer_makes_no_tensor_operation():
    """On or off, the tracer runs no torch operation: it holds no device
    memory and never waits for the card."""

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.append(func)
            return func(*args, **(kwargs or {}))

    with Ops() as mode:
        for on in (False, True):
            if on:
                tracing.enable()
            with tracing.span("uplif.insert"):
                tracing.count("insert.keys", 3)
                with tracing.span("fops.insert.place"):
                    pass
            snap = tracing.snapshot()
    assert mode.seen == []
    for name, parent, t0, t1, counts in snap["spans"]:
        assert isinstance(t0, int) and isinstance(t1, int)
        assert all(isinstance(v, int) for v in counts.values())


def test_spans_nest_and_counts_land_in_the_innermost_span():
    tracing.enable()
    with tracing.span("a"):
        tracing.count("x")
        with tracing.span("b"):
            tracing.count("x", 2)
            tracing.count("y")
        with tracing.span("c"):
            pass
    tracing.count("x")                      # outside every span
    snap = tracing.snapshot()
    assert [(s[0], s[1]) for s in snap["spans"]] == [("a", -1), ("b", 0),
                                                     ("c", 0)]
    assert [s[4] for s in snap["spans"]] == [{"x": 1}, {"x": 2, "y": 1}, {}]
    assert snap["counts"] == {"x": 4, "y": 1}
    a, b, c = snap["spans"]
    assert a[2] <= b[2] <= b[3] <= c[2] <= c[3] <= a[3]
    tracing.disable()
    with tracing.span("d"):
        tracing.count("x")
    assert tracing.snapshot() == snap


@pytest.mark.parametrize("n_insert,syncs", [(100, 4), (5000, 5)])
def test_one_lookup_and_one_insert_count_their_host_syncs(keys, n_insert,
                                                          syncs):
    """A lookup waits for the card three times (the batch's copy, two
    reads back); an insert four (two copies, the BMAT's size, the overflow
    count), five when the BMAT grows (``_grow`` reads the size again)."""
    idx = _index(keys)
    new = make_keys(n_insert, seed=12, hi=1 << 40)
    tracing.enable()
    idx.lookup(keys[:300])
    idx.insert(new)
    snap = tracing.snapshot()
    tops = _tops(snap)
    spans = snap["spans"]
    assert [spans[i][0] for i in tops] == ["uplif.lookup", "uplif.insert"]
    look, ins = tops
    assert [s[0] for s in spans if s[1] == look] == ["uplif.h2d",
                                                     "fops.lookup",
                                                     "uplif.d2h"]
    assert [s[0] for s in spans if s[1] == ins] == INSERT_SPANS
    assert _subtree_counts(snap, look) == {"host_syncs": 3}
    assert _subtree_counts(snap, ins)["host_syncs"] == syncs
    assert _subtree_counts(snap, ins)["insert.keys"] == n_insert


def test_no_host_sync_under_a_dispatch_span(keys):
    idx = _index(keys)
    tracing.enable()
    for seed in range(3):
        idx.lookup(keys[seed::7])
        idx.insert(make_keys(5000, seed=20 + seed, hi=1 << 40))
    snap = tracing.snapshot()
    spans = snap["spans"]
    dispatch = set()
    for i, (name, parent, *_rest) in enumerate(spans):
        if name.startswith("fops.") or parent in dispatch:
            dispatch.add(i)
    assert {spans[i][0] for i in dispatch} == {"fops.lookup",
                                               "fops.insert.place",
                                               "fops.insert.merge"}
    assert all("host_syncs" not in spans[i][4] for i in dispatch)
    assert snap["counts"]["host_syncs"] == 3 * 3 + 3 * 4 + 1   # one growth


def test_the_overflow_count_is_what_insert_returns(keys):
    """A hot spot between two loaded keys cannot all go in place."""
    idx = _index(keys)
    tracing.enable()
    lo = int(keys[2000])
    hot = lo + 1 + np.arange(3000, dtype=np.int64)
    over = idx.insert(hot) + idx.insert(make_keys(300, seed=5, hi=1 << 40))
    assert over > 0
    snap = tracing.snapshot()
    assert snap["counts"]["insert.overflow"] == over
    assert snap["counts"]["insert.keys"] == 3300
    assert sum(_subtree_counts(snap, i).get("insert.overflow", 0)
               for i in _tops(snap)) == over


def test_a_profiler_turns_the_tracer_on_and_sees_none_of_its_spans(keys):
    idx = _index(keys)
    idx.lookup(keys[:10])
    assert tracing.snapshot()["spans"] == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        idx.lookup(keys[:300])
        idx.insert(make_keys(100, seed=3, hi=1 << 40))
    snap = tracing.snapshot()
    names = {s[0] for s in snap["spans"]}
    assert {"uplif.lookup", "uplif.insert", "fops.lookup",
            "fops.insert.place"} <= names
    events = {e.name for e in prof.events()}
    assert events and not names & events
    idx.lookup(keys[:10])                   # the profiler has stopped
    assert tracing.snapshot() == snap


def test_the_buffer_stops_at_its_bound_and_counts_what_it_drops(
        monkeypatch):
    monkeypatch.setattr(tracing, "CAPACITY", 3)
    tracing.enable()
    with tracing.span("a"):
        for i in range(4):
            with tracing.span(f"b{i}"):
                tracing.count("x")
    snap = tracing.snapshot()
    assert [s[0] for s in snap["spans"]] == ["a", "b0", "b1"]
    assert snap["dropped"] == 2
    assert snap["counts"] == {"x": 4}       # the totals keep every count
    assert [s[4] for s in snap["spans"]] == [{}, {"x": 1}, {"x": 1}]
    tracing.reset()
    assert tracing.snapshot() == {"spans": [], "counts": {}, "dropped": 0}


def test_the_rounds_are_counted_and_none_takes_k7_on_the_cpu(keys):
    """Each Movement round counts ``insert.rounds``; on the CPU the round
    is K7's plain version, so ``insert.rounds_kernel`` is never counted."""
    idx = _index(keys)
    tracing.enable()
    for seed in range(2):
        idx.insert(make_keys(500, seed=30 + seed, hi=1 << 40))
    counts = tracing.snapshot()["counts"]
    assert counts["insert.rounds"] == 2 * idx.cfg.insert_rounds
    assert "insert.rounds_kernel" not in counts


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_every_round_takes_k7_on_the_card(cuda, keys):
    idx = UpLIF(keys, config=UpLIFConfig(), device=cuda)
    tracing.enable()
    for seed in range(3):
        idx.insert(make_keys(500, seed=40 + seed, hi=1 << 40))
    snap = tracing.snapshot()
    rounds = 3 * idx.cfg.insert_rounds
    assert snap["counts"]["insert.rounds"] == rounds
    assert snap["counts"]["insert.rounds_kernel"] == rounds
    for top in _tops(snap):
        assert _subtree_counts(snap, top)["insert.rounds_kernel"] == \
            idx.cfg.insert_rounds


@pytest.mark.gpu
def test_no_host_sync_in_the_placement_on_the_card(cuda, keys):
    """The placement (``fops.insert`` without the merge: the subset
    retrain's call, K7's every round) runs with the card's sync check on:
    any operation that waits for the card raises."""
    from repro_torch.core import fops

    idx = UpLIF(keys, config=UpLIFConfig(), device=cuda)
    new = torch.tensor(make_keys(2048, seed=50, hi=1 << 40), device=cuda)
    fops.insert(idx.fstate, new, new + 1, static=idx.fstatic(),
                merge_overflow=False)              # warm: the library loads
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, res = fops.insert(idx.fstate, new, new + 1,
                                 static=idx.fstatic(), merge_overflow=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert not bool(res.pending.all())
    assert int(state.counters.n_inplace) > 0
