"""K7, the window insert, on the card (skipped without one): the kernel
pair against its plain version byte for byte, on batches that reach every
branch of a Movement round, over one index's slot view and over the
router's flat view of stacked shards; and an index's op tape on the card
against the same tape on the CPU. No JAX here: ``tests/
test_torch_window_insert.py`` holds the plain version to the JAX package's
round on the same cases."""
import numpy as np
import pytest
import torch

from repro_torch.core import UpLIF, UpLIFConfig
from repro_torch.core.types import KEY_MAX, TOMBSTONE
from repro_torch.kernels import ops
from repro_torch.kernels.window_insert import (
    window_insert,
    window_insert_plain,
)
from tests.conftest import make_keys

MOVEMENT_K = 6
ROWS = 24            # grid rows a shard
ROW_KINDS = ("half", "full", "sparse", "dense", "empty", "tail", "head",
             "half", "one", "dense", "empty", "empty", "tail", "full")
CASES = ("many_in_one_row", "margins", "left_run", "edge_rows",
         "duplicates", "no_pending", "random")
VIEWS = ("single", "stacked")


def _row_occupancy(r, kind, W):
    if kind == "full":
        return np.ones(W, bool)
    if kind == "empty":
        return np.zeros(W, bool)
    if kind == "one":                      # one occupied slot, mid-row
        occ = np.zeros(W, bool)
        occ[W // 2] = True
        return occ
    dens = {"half": 0.5, "sparse": 0.1, "dense": 0.9}.get(kind, 0.7)
    occ = r.random(W) < dens
    if kind == "tail":                     # an empty run from the row before
        occ[: W // 2] = False
    elif kind == "head":                   # an empty run into the row after
        occ[W // 2:] = False
    return occ


def shard_slots(r, W, rows=ROWS, base=1000):
    """One shard's slot arrays (keys, vals, occ) of ``rows`` W-rows, each
    row's occupancy of a kind of ``ROW_KINDS`` in turn, the occupied keys
    increasing by gaps of 2 to 2000, every empty slot filled forward with
    the next occupied key (KEY_MAX in the tail), a few values tombstones."""
    occ = np.concatenate([_row_occupancy(r, ROW_KINDS[i % len(ROW_KINDS)], W)
                          for i in range(rows)])
    live = base + np.cumsum(r.integers(2, 2000, int(occ.sum())))
    keys = np.full(occ.shape, KEY_MAX, dtype=np.int64)
    keys[occ] = live
    nxt = KEY_MAX
    for t in range(len(keys) - 1, -1, -1):
        if occ[t]:
            nxt = keys[t]
        else:
            keys[t] = nxt
    vals = np.where(occ, keys + 1, 0).astype(np.int64)
    vals[occ & (r.random(len(occ)) < 0.05)] = TOMBSTONE
    return keys, vals, occ


def _between(r, live, n):
    """``n`` fresh keys, each strictly between two neighbouring live keys
    (or below the first / above the last)."""
    lo = np.concatenate([[0], live])
    hi = np.concatenate([live, [live[-1] + 5000]])
    i = r.integers(0, len(lo), n)
    return lo[i] + 1 + (r.random(n) * (hi[i] - lo[i] - 1)).astype(np.int64)


def _row_keys(r, keys, occ, row, W, n):
    """``n`` fresh keys whose insertion slot falls inside ``row``."""
    sl = slice(row * W, (row + 1) * W)
    live = keys[sl][occ[sl]]
    if len(live) < 2:
        return np.zeros(0, np.int64)
    i = r.integers(0, len(live) - 1, n)
    span = live[i + 1] - live[i]
    return live[i] + 1 + (r.random(n) * (span - 1)).astype(np.int64)


def batch_for(case, r, keys, occ, W):
    """(fresh keys, pending mask, icap override or None) for one shard."""
    cap = len(keys)
    live = keys[occ]
    icap = None
    pend = None
    if case == "many_in_one_row":
        q = np.concatenate([_row_keys(r, keys, occ, 0, W, 60),
                            _row_keys(r, keys, occ, 3, W, 60),
                            _between(r, live, 20)])
    elif case == "margins":
        # keys just below and above the slots at and inside each margin
        ts = np.array([0, 1, 2, 3, W - 3, W - 2, W - 1])
        at = (np.arange(cap // W)[:, None] * W + ts[None, :]).ravel()
        near = keys[at][keys[at] < KEY_MAX]
        q = np.concatenate([near - 1, near + 1])
    elif case == "left_run":
        # rows whose first slots are empty after an empty row end
        rows = [i for i in range(cap // W)
                if ROW_KINDS[i % len(ROW_KINDS)] in ("tail", "empty", "one")]
        q = np.concatenate([_between(r, live, 30)]
                           + [_row_keys(r, keys, occ, i, W, 4) for i in rows]
                           + [keys[i * W: i * W + 3][keys[i * W: i * W + 3]
                                                      < KEY_MAX] - 1
                              for i in rows])
    elif case == "edge_rows":
        # below every key (row 0), above every key (the last row), and a
        # locate span that ends before the insertion slot
        q = np.concatenate([live[0] - 1 - np.arange(6), live[-1] + 1
                            + np.arange(6), _between(r, live, 40)])
        icap = "short"
    elif case == "duplicates":
        q = _between(r, live, 80)
        q = np.concatenate([q, q[:30], np.full(20, KEY_MAX)])
        pend = q != KEY_MAX
        pend[80:] &= r.random(len(q) - 80) < 0.5   # some repeats pending too
    elif case == "no_pending":
        q = _between(r, live, 50)
        pend = np.zeros(len(q), bool)
    else:
        q = _between(r, live, 300)
    q = q.astype(np.int64)
    if pend is None:
        pend = q != KEY_MAX
    return q, pend, icap


def make_case(case, view, W, seed=0):
    """A slot view with its scratch row and one round's inputs, as numpy:
    (sk, sv, so of total + W slots, keys, vals, j, icap, pending, sid or
    None, cap, total)."""
    r = np.random.default_rng([seed, CASES.index(case), VIEWS.index(view), W])
    S = 1 if view == "single" else 3
    parts, qs, ps, js, ics, sids = [], [], [], [], [], []
    base = 1000
    for s in range(S):
        k, v, o = shard_slots(r, W, base=base)
        base = int(k[o][-1]) + 10_000
        parts.append((k, v, o))
        q, p, icap = batch_for(case, r, k, o, W)
        j = np.searchsorted(k, q, side="right") - 1
        ic = np.full(len(q), len(k) - 1)
        if icap == "short":
            short = r.random(len(q)) < 0.3
            ic[short] = np.maximum(j[short] - r.integers(0, 3 * W, short.sum()),
                                   -1)
        qs.append(q), ps.append(p), js.append(j), ics.append(ic)
        sids.append(np.full(len(q), s))
    cap = len(parts[0][0])
    total = S * cap
    sk, sv, so = (np.concatenate([p[i] for p in parts]) for i in range(3))
    sk, sv, so = (np.concatenate([a, a[-W:]]) for a in (sk, sv, so))
    keys = np.concatenate(qs)
    perm = r.permutation(len(keys))      # batch order mixes the shards
    keys = keys[perm]
    vals = (keys * 3 + 7).astype(np.int64)
    vals[keys == KEY_MAX] = 0
    sid = np.concatenate(sids)[perm] if S > 1 else None
    return dict(sk=sk, sv=sv, so=so, keys=keys, vals=vals,
                j=np.concatenate(js)[perm].astype(np.int64),
                icap=np.concatenate(ics)[perm].astype(np.int64),
                pending=np.concatenate(ps)[perm], sid=sid, cap=cap,
                total=total)


def run_round(fn, c, W, device, counters=True):
    """One round of ``fn`` (``window_insert`` or its plain version) on
    ``device``; returns every byte it produced as numpy: the slot view
    (without the scratch row), ok, failed_span and the two counters."""
    t = {k: torch.tensor(c[k], device=device)
         for k in ("sk", "sv", "so", "keys", "vals", "j", "icap", "pending")}
    sid = None if c["sid"] is None else torch.tensor(c["sid"],
                                                       device=device)
    n_placed = min_span = None
    if counters:
        n_placed = torch.zeros((), dtype=torch.int64, device=device)
        min_span = torch.full((), KEY_MAX, dtype=torch.int64, device=device)
    ok, span = fn(t["sk"], t["sv"], t["so"], t["keys"], t["vals"], t["j"],
                  t["icap"], t["pending"], sid, cap=c["cap"],
                  total=c["total"], window=W, movement_k=MOVEMENT_K,
                  n_placed=n_placed, min_span=min_span)
    total = c["total"]
    out = {"sk": t["sk"][:total], "sv": t["sv"][:total],
           "so": t["so"][:total], "ok": ok, "failed_span": span}
    if counters:
        out.update(n_placed=n_placed, min_span=min_span)
    return {k: v.cpu().numpy() for k, v in out.items()}


def assert_same_round(a, b, what):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, f"{what}: {k} dtype"
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what}: {k}")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("W", [16, 32, 64, 128])
@pytest.mark.parametrize("view", VIEWS)
@pytest.mark.parametrize("case", CASES)
def test_k7_equals_its_plain_version(cuda, case, view, W):
    c = make_case(case, view, W)
    ops.reset_launch_counts()
    got = run_round(window_insert, c, W, cuda)
    torch.cuda.synchronize()
    assert ops.launch_counts()["window_insert"] == 2
    want = run_round(window_insert_plain, c, W, "cpu")
    assert_same_round(got, want, f"{case}, {view}, W {W}")
    # every case but the empty one places keys and fails windows
    placed, failed = got["ok"].any(), (got["failed_span"] < KEY_MAX).any()
    assert (placed and failed) == (case != "no_pending")


@pytest.mark.gpu
@pytest.mark.parametrize("view", VIEWS)
def test_k7_without_counters_and_in_rounds(cuda, view):
    """The counters are optional, and a key placed in one round is not
    pending in the next: three rounds on the card equal three plain ones."""
    c = make_case("many_in_one_row", view, 64, seed=3)
    outs = []
    for device, fn in ((cuda, window_insert), ("cpu", window_insert_plain)):
        cc = dict(c)
        rounds = []
        for _ in range(3):
            res = run_round(fn, cc, 64, device, counters=False)
            rounds.append(res)
            cc = dict(cc, pending=cc["pending"] & ~res["ok"],
                      sk=np.concatenate([res["sk"], c["sk"][-64:]]),
                      sv=np.concatenate([res["sv"], c["sv"][-64:]]),
                      so=np.concatenate([res["so"], c["so"][-64:]]))
        outs.append(rounds)
    for i, (a, b) in enumerate(zip(*outs)):
        assert_same_round(a, b, f"{view}, round {i}")
    assert sum(int(r["ok"].sum()) for r in outs[0]) > int(
        outs[0][0]["ok"].sum())


def _state_arrays(idx):
    s = idx.fstate
    return [a.cpu().numpy() for a in (*s.slots, *s.bmat, *s.counters)]


def index_tape(seed, keys):
    """A seeded tape of index operations over ``keys`` (the loaded keys):
    fresh inserts, a hot spot that overflows to the BMAT, deletes of loaded
    and buffered keys, revivals of deleted keys, upserts of loaded keys,
    and subset retrains."""
    r = np.random.default_rng(seed)
    lo, hi = int(keys[0]), int(keys[-1])
    seen = keys
    tape = []
    for step in range(10):
        fresh = r.integers(lo, hi, 700).astype(np.int64)
        tape.append(("insert", fresh))
        seen = np.union1d(seen, fresh)
        if step % 3 == 0:
            a = int(r.choice(keys[:-1]))
            tape.append(("insert", a + 1 + np.arange(400, dtype=np.int64)))
        victims = r.choice(seen, 300, replace=False)
        tape.append(("delete", victims))
        tape.append(("insert", np.concatenate([victims[:150],
                                               r.choice(keys, 100)])))
        if step % 4 == 3:
            tape.append(("retrain_subset",))
    return tape


@pytest.mark.gpu
def test_index_tape_on_the_card_equals_the_cpu(cuda):
    keys = make_keys(30_000, seed=5, hi=1 << 40)
    cfg = UpLIFConfig(batch_bucket=256)
    card = UpLIF(keys, keys + 1, cfg, device=cuda)
    host = UpLIF(keys, keys + 1, cfg, device="cpu")
    ops.reset_launch_counts()
    for i, op in enumerate(index_tape(9, keys)):
        res = []
        for idx in (card, host):
            if op[0] == "insert":
                res.append(idx.insert(op[1], op[1] * 2 + 1))
            elif op[0] == "delete":
                res.append(idx.delete(op[1]))
            else:
                res.append(idx.retrain_subset())
        np.testing.assert_array_equal(res[0], res[1], err_msg=f"op {i}")
        for a, b in zip(_state_arrays(card), _state_arrays(host)):
            np.testing.assert_array_equal(a, b, err_msg=f"op {i} {op[0]}")
    assert ops.launch_counts()["window_insert"] > 0
    assert card.n_overflow > 0
    probe = np.concatenate([keys[::7], keys[:50] + 1])
    for a, b in zip(card.lookup(probe), host.lookup(probe)):
        np.testing.assert_array_equal(a, b)
