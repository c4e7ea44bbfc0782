"""The port's kernel-level predict/search/rank API against the JAX package,
on the CPU: K5 (spline lookup), K4 (tile search) and the ``ops`` entries
``spline_lookup``, ``route_and_search`` and ``bmat_rank`` built on them.

K4 and K5 run their plain torch versions here and are held to the Pallas
kernels in interpret mode (and K5, below radix shift 32, to the reference's
plain ``ref.spline_lookup_ref``) with zero tolerance: K4 is an integer
count and K5 repeats the reference's float32 roundings operation for
operation, so the positions must agree bit for bit. The tests marked
``gpu`` hold the CUDA kernels to the plain versions and skip without a
card.
"""
from fractions import Fraction

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401 — x64
import jax.numpy as jnp
from repro.core.radix_spline import build_radix_spline as jax_build_rs
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.spline_lookup import Q_BLK as SPL_Q_BLK, spline_lookup_pallas
from repro.kernels.tile_search import tile_search_pallas
from repro_torch.core.convert import model_from_numpy
from repro_torch.kernels import ops, tile_search as tmod
from repro_torch.kernels.ref import fma_f32
from repro_torch.kernels.spline_lookup import (
    spline_lookup, spline_lookup_paths, spline_lookup_plain,
)
from repro_torch.kernels.tile_search import (
    Q_BLK, TILE, tile_search, tile_search_plain,
)
from tests.conftest import make_keys

I64_MAX = np.iinfo(np.int64).max
# key domains: wikits-like (shift 14), a mid domain (shift 28) whose
# above-domain queries wrap the reference's int32 bucket, fb-like (shift 36)
DOMAINS = {"wikits": 1 << 30, "wrap": 1 << 44, "fb": 1 << 52}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps the parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# the exact fused multiply-add of the plain versions
# ---------------------------------------------------------------------------


def _round_f32(x: Fraction) -> np.float32:
    """The float32 nearest to ``x``, ties to even."""
    g = np.float32(float(x))
    best = None
    for c in (np.nextafter(g, np.float32(-np.inf)), g,
              np.nextafter(g, np.float32(np.inf))):
        d = abs(Fraction(float(c)) - x)
        if best is None or d < best[0] or (
                d == best[0] and int(c.view(np.int32)) % 2 == 0):
            best = (d, c)
    return best[1]


def test_fma_f32_rounds_once():
    """``fma_f32`` equals the exactly rounded a*b + c, also where the
    float64 sum lands on a float32 tie that a second rounding would
    break the wrong way (the first case)."""
    r = np.random.default_rng(0)
    a = np.concatenate([[2.0 ** -24 * (1 + 2.0 ** -23)], r.random(1500)])
    b = np.concatenate([[1 - 2.0 ** -23], r.normal(0, 1e6, 1500)])
    c = np.concatenate([[1 + 2.0 ** -23], r.normal(0, 1e7, 1500)])
    a, b, c = (x.astype(np.float32) for x in (a, b, c))
    got = fma_f32(*(torch.tensor(x) for x in (a, b, c))).numpy()
    want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y))
                                + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], dtype=np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    twice = (a[:1].astype(np.float64) * b[:1] + c[:1]).astype(np.float32)
    assert twice[0] != got[0]  # the double-rounding case is really there


# ---------------------------------------------------------------------------
# K5 — spline lookup
# ---------------------------------------------------------------------------


def _spline(domain, n=1 << 15, seed=3):
    hi = DOMAINS[domain]
    keys = make_keys(n, seed, hi=hi)
    pos = np.arange(len(keys), dtype=np.int64) * 2
    model, static = jax_build_rs(keys, pos, radix_bits=16, max_error=24)
    return keys, model, static


def _k5_queries(keys, shift, seed, n=1500):
    """Hits, misses, keys above the domain (some whose ``q >> shift``
    exceeds int32 when the shift is below 32), 0 and int64 max."""
    r = np.random.default_rng(seed)
    top = int(keys[-1])
    parts = [r.choice(keys, n // 3), r.integers(0, top, n // 3),
             top + 1 + r.integers(0, 1 << 40, n // 6)]
    if shift < 32:
        parts.append(r.integers(1 << (shift + 31), 1 << (shift + 33), 64))
    parts.append([0, top, I64_MAX])
    return np.concatenate(parts).astype(np.int64)


def _same_bits(a, b):
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


@pytest.mark.parametrize("domain", ["wikits", "wrap", "fb"])
def test_spline_lookup_matches_jax(domain):
    """K5's plain version equals the Pallas kernel (shift >= 32) or the
    reference's plain path (shift < 32) bit for bit, and the port's
    ``ops.spline_lookup`` equals JAX's."""
    keys, m, st = _spline(domain)
    shift = int(m.shift)
    assert (shift >= 32) == (domain == "fb")
    q = _k5_queries(keys, shift, seed=len(domain))
    if shift < 32:
        wrapped = (q >> shift) >= (1 << 31)
        assert wrapped.any()  # the int32 wrap is exercised
    tm = model_from_numpy([np.asarray(a) for a in m], device="cpu")
    tq = torch.tensor(q)

    got = spline_lookup_plain(tm.table, tm.spline_keys, tm.spline_pos, tq,
                              shift=shift, n_iters=st.n_search_iters).numpy()
    sk_hi, sk_lo = jops.split_key(m.spline_keys)
    qh, n = jops._pad_to(jops.split_key(jnp.asarray(q))[0], SPL_Q_BLK, 0)
    ql, _ = jops._pad_to(jops.split_key(jnp.asarray(q))[1], SPL_Q_BLK, 0)
    sp32 = m.spline_pos.astype(jnp.float32)
    if shift >= 32:
        want = spline_lookup_pallas(m.table, sk_hi, sk_lo, sp32, qh, ql,
                                    shift=shift, n_iters=st.n_search_iters,
                                    interpret=True)
    else:
        want = jref.spline_lookup_ref(m.table, sk_hi, sk_lo, sp32, qh, ql,
                                      shift, st.n_search_iters)
    _same_bits(got, np.asarray(want)[:n])

    port = ops.spline_lookup(tm.table, tm.spline_keys, tm.spline_pos,
                             tm.shift, tq, st.n_search_iters)
    jax = jops.spline_lookup(m.table, m.spline_keys, m.spline_pos, shift,
                             jnp.asarray(q), st.n_search_iters)
    assert port.dtype == torch.float32
    _same_bits(port.numpy(), np.asarray(jax))


def test_spline_lookup_roundings_differ_across_the_split():
    """The two K5 modes are different arithmetic, so neither can stand in
    for the other: on the fb model the reference's plain rounding (run at
    the same shift) differs from the Pallas rounding that K5 computes
    there on some queries, by at most a few float32 ulps."""
    keys, m, st = _spline("fb")
    tm = model_from_numpy([np.asarray(a) for a in m], device="cpu")
    r = np.random.default_rng(9)
    q = np.sort(r.integers(int(keys[0]), int(keys[-1]), 1 << 15))
    got = spline_lookup_plain(tm.table, tm.spline_keys, tm.spline_pos,
                              torch.tensor(q), shift=36,
                              n_iters=st.n_search_iters).numpy()
    sk_hi, sk_lo = jops.split_key(m.spline_keys)
    qh, ql = jops.split_key(jnp.asarray(q))
    other = np.asarray(jref.spline_lookup_ref(
        m.table, sk_hi, sk_lo, m.spline_pos.astype(jnp.float32), qh, ql, 36,
        st.n_search_iters))
    differ = got != other
    assert differ.any()
    assert np.abs(got - other).max() <= 4 * np.spacing(np.abs(got).max())


def _k5_edge(case):
    """A K5 edge case: (model arrays as numpy, shift, n_iters, queries,
    the kernel paths it must reach). Splines over 3000 keys with a knot
    per key and 16 radix buckets (about 190 knots a bucket) or an error
    bound of 2 and 512 buckets (up to 10 knots a bucket), both modes, plus
    an ``n_iters`` too small to converge, a table whose last entries equal
    the knot count (lo > hi after the clamp), the knots of one bucket in
    reverse (the knots <= q no longer come first), and the int32 wrap of
    ``q >> shift`` below shift 32. Every query set has hits, misses, keys
    below the first and above the last knot, 0 and int64 max."""
    fb = case.endswith("fb")
    wide = case.startswith(("wide", "iters1", "lo>hi"))
    hi = DOMAINS["fb" if fb else "wrap" if case == "wrap" else "wikits"]
    keys = make_keys(3000, 17, hi=hi)
    keys = keys[keys > 5]
    radix_bits = 4 if wide else 14 if case == "wrap" else 9
    model, static = jax_build_rs(keys, np.arange(len(keys)) * 3,
                                 radix_bits=radix_bits,
                                 max_error=1 if wide else 2)
    table, sk, sp = (np.array(a) for a in model[:3])
    shift, n_iters = int(model.shift), static.n_search_iters
    paths = {1} if wide else {0}
    if case.startswith("iters1"):
        n_iters, paths = 1, {2}
    elif case.startswith("lo>hi"):
        table[-3:] = len(sk)
        paths = {2}
    # the widest bucket's knots
    bb = int(np.argmax(np.diff(table.astype(np.int64))))
    a, b = int(table[bb]), int(table[bb + 1])
    if case.startswith("unsorted"):
        sk[a:b] = sk[a:b][::-1].copy()
        paths = {2}
    r = np.random.default_rng(len(case))
    q = [r.choice(keys, 500), r.integers(0, hi, 500),
         hi + r.integers(0, 1 << 40, 100), sk[max(a - 1, 0):b + 1],
         [0, 1, keys[0] - 1, keys[0], keys[-1], keys[-1] + 1, I64_MAX]]
    if shift < 32:
        q.append(r.integers(1 << (shift + 31), 1 << (shift + 33), 64))
    return (table, sk, sp), shift, n_iters, np.concatenate(q).astype(
        np.int64), paths


K5_EDGES = ["narrow wikits", "narrow fb", "wide wikits", "wide fb",
            "iters1 wikits", "iters1 fb", "lo>hi wikits", "lo>hi fb",
            "unsorted wikits", "unsorted fb", "wrap"]


@pytest.mark.parametrize("case", K5_EDGES)
def test_spline_lookup_plain_at_the_edges(case):
    """K5's plain version against the Pallas body (shift >= 32) or the
    reference's plain path (shift < 32), bit for bit, on the edge cases of
    the kernel's two paths; ``spline_lookup_paths`` says the case reaches
    the path it is there for."""
    (table, sk, sp), shift, n_iters, q, paths = _k5_edge(case)
    assert (shift >= 32) == case.endswith("fb")
    if case == "wrap":
        assert ((q >> shift) >= 1 << 31).any()
    t = torch.as_tensor
    got = spline_lookup_plain(t(table), t(sk), t(sp), t(q), shift=shift,
                              n_iters=n_iters).numpy()
    sk_hi, sk_lo = jops.split_key(jnp.asarray(sk))
    qh, n = jops._pad_to(jops.split_key(jnp.asarray(q))[0], SPL_Q_BLK, 0)
    ql, _ = jops._pad_to(jops.split_key(jnp.asarray(q))[1], SPL_Q_BLK, 0)
    sp32 = jnp.asarray(sp.astype(np.float32))
    if shift >= 32:
        want = spline_lookup_pallas(jnp.asarray(table), sk_hi, sk_lo, sp32,
                                    qh, ql, shift=shift, n_iters=n_iters,
                                    interpret=True)
    else:
        want = jref.spline_lookup_ref(jnp.asarray(table), sk_hi, sk_lo, sp32,
                                      qh, ql, shift, n_iters)
    _same_bits(got, np.asarray(want)[:n])
    path, rounds = spline_lookup_paths(t(table), t(sk), t(q), shift=shift,
                                       n_iters=n_iters)
    assert paths <= set(path.tolist()), case
    assert int(rounds.max()) <= -(-max(n_iters, 0) // 5)


# ---------------------------------------------------------------------------
# K4 — tile search
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sorted_tiles", [True, False])
def test_tile_search_plain_matches_pallas(sorted_tiles):
    """K4's plain version equals ``tile_search_pallas`` exactly, on sorted
    tiles and on unsorted ones (compare-count needs no order)."""
    r = np.random.default_rng(int(sorted_tiles))
    n_tiles = 6
    tiles = r.integers(0, 1 << 48, (n_tiles, TILE)).astype(np.int64)
    if sorted_tiles:
        tiles = np.sort(tiles, axis=1)
    q = r.integers(0, 1 << 48, (n_tiles, Q_BLK)).astype(np.int64)
    q[0, :8] = tiles[0, :8]
    q[1, 0], q[1, 1], q[2, 0] = I64_MAX, 0, tiles[2].max()
    th, tl = jops.split_key(jnp.asarray(tiles))
    qh, ql = jops.split_key(jnp.asarray(q))
    want = np.asarray(tile_search_pallas(th, tl, qh, ql, interpret=True))
    got = tile_search_plain(
        torch.tensor(tiles.reshape(-1)), torch.tensor(q.reshape(-1)),
        torch.arange(n_tiles), torch.arange(n_tiles + 1) * Q_BLK,
    )
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().reshape(n_tiles, Q_BLK), want)


def test_tile_search_passes_and_padding():
    """A pass writes only its block of each segment; the last, partial
    tile counts as padded with int64 max."""
    r = np.random.default_rng(4)
    cap = 2 * TILE + 100
    slots = np.sort(r.integers(0, 1 << 40, cap)).astype(np.int64)
    q = np.concatenate([np.full(Q_BLK + 10, I64_MAX),
                        r.integers(0, 1 << 40, 7)]).astype(np.int64)
    seg_tile = torch.tensor([2, 0])
    seg_start = torch.tensor([0, Q_BLK + 10, len(q)])
    args = (torch.tensor(slots), torch.tensor(q), seg_tile, seg_start)
    first = tile_search_plain(*args, pass_idx=0)
    assert (first[:Q_BLK] == TILE - 1).all()  # 100 keys + 1948 padding
    assert (first[Q_BLK:Q_BLK + 10] == -1).all()  # not in pass 0
    both = tile_search_plain(*args, pass_idx=1, out=first.clone())
    assert (both[:Q_BLK + 10] == TILE - 1).all()
    want = np.searchsorted(slots[:TILE], q[-7:], side="right") - 1
    np.testing.assert_array_equal(both[-7:].numpy(), want)


def _k4_case(seed, cap, sizes, sorted_tiles=True, empty=3):
    """Slot keys and K4 inputs: one segment per entry of ``sizes`` (its
    query count), each on its own tile, the last on the ragged last tile,
    then ``empty`` unused segments that start and end at n. Queries mix
    random keys, the tile's own keys, 0 and int64 max."""
    r = np.random.default_rng(seed)
    slots = r.integers(0, 1 << 48, cap).astype(np.int64)
    if sorted_tiles:
        slots.sort()
    n_tiles = -(-cap // TILE)
    tiles = np.concatenate([
        np.sort(r.choice(n_tiles - 1, len(sizes) - 1, replace=False)),
        [n_tiles - 1]]).astype(np.int64)
    qs = []
    for t, m in zip(tiles, sizes):
        own = slots[t * TILE:(t + 1) * TILE]
        q = np.concatenate([r.integers(0, 1 << 48, m), r.choice(own, m),
                            [0, I64_MAX]])
        qs.append(r.permutation(q)[:m])
    q = np.concatenate(qs).astype(np.int64)
    seg_tile = np.concatenate([tiles, np.zeros(empty, np.int64)])
    seg_start = np.concatenate([[0], np.cumsum(sizes),
                                np.full(empty, len(q))]).astype(np.int64)
    return slots, q, seg_tile, seg_start


def _k4_oracle(slots, q, seg_tile, seg_start, pass_lo, pass_hi):
    """numpy K4: each entry of the passes, the count of its tile's keys
    (the last tile padded with int64 max) <= q, minus one; -1 elsewhere."""
    out = np.full(len(q), -1, np.int32)
    padded = np.concatenate([slots, np.full(-len(slots) % TILE, I64_MAX)])
    for t, a, b in zip(seg_tile, seg_start[:-1], seg_start[1:]):
        lo, hi = a + pass_lo * Q_BLK, min(a + pass_hi * Q_BLK, b)
        tile = padded[t * TILE:(t + 1) * TILE]
        for i in range(lo, hi):
            out[i] = int((tile <= q[i]).sum()) - 1
    return out


K4_SIZES = [1, Q_BLK, Q_BLK + 1, 1100]  # 1100: three passes


@pytest.mark.parametrize("pass_lo,pass_hi", [(0, 1), (1, 2), (2, 3), (0, 2),
                                             (1, 3), (0, 3), (0, 9)])
def test_tile_search_plain_pass_range(pass_lo, pass_hi):
    """One call over the passes ``[pass_lo, pass_hi)`` equals the
    single-pass calls applied in order, and the numpy oracle; segments of
    1, 512, 513 and 1100 queries, the last on a ragged last tile."""
    cap = 5 * TILE + 333
    case = _k4_case(pass_lo * 10 + pass_hi, cap, K4_SIZES)
    args = [torch.tensor(a) for a in case]
    got = tile_search_plain(*args, pass_idx=pass_lo, pass_hi=pass_hi)
    in_turn = None
    for p in range(pass_lo, pass_hi):
        in_turn = tile_search_plain(*args, pass_idx=p, out=in_turn)
    assert torch.equal(got, in_turn)
    np.testing.assert_array_equal(got.numpy(),
                                  _k4_oracle(*case, pass_lo, pass_hi))


@pytest.mark.parametrize("pass_lo,pass_hi", [(1, 1), (2, 1), (-1, 0)])
def test_tile_search_rejects_an_empty_pass_range(pass_lo, pass_hi):
    args = [torch.tensor(a) for a in _k4_case(0, 3 * TILE, [1, 2])]
    for fn in (tile_search, tile_search_plain):
        with pytest.raises(ValueError):
            fn(*args, pass_idx=pass_lo, pass_hi=pass_hi)


def _route_case(seed, cap, n):
    r = np.random.default_rng(seed)
    slots = np.sort(r.integers(0, 1 << 48, cap)).astype(np.int64)
    q = np.concatenate([r.integers(0, 1 << 48, n - 2), [0, I64_MAX]])
    q = q.astype(np.int64)
    noise = r.integers(-300, 300, n)
    pred = (np.searchsorted(slots, q) + noise).astype(np.float32)
    pred[:3] = [-7.5, cap + 5000.0, 2047.9]  # clipped and truncated edges
    return slots, q, pred


@pytest.mark.parametrize("cap", [10_000, 30_000])
def test_route_and_search_matches_jax(cap):
    """Same ``ok`` and ``j`` as JAX's ``route_and_search`` when no tile
    overflows, including predictions that need clipping and a cap that is
    no multiple of the tile."""
    slots, q, pred = _route_case(cap, cap, 1024)
    jj, jok = jops.route_and_search(jnp.asarray(slots), jnp.asarray(q),
                                    jnp.asarray(pred))
    tj, tok = ops.route_and_search(torch.tensor(slots), torch.tensor(q),
                                   torch.tensor(pred))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert tok.all()
    np.testing.assert_array_equal(tj.numpy(), np.asarray(jj))
    # where the prediction lands in the right tile, j is the global answer
    right = np.searchsorted(slots, q, side="right") - 1
    tile = np.clip(pred.astype(np.int64) // TILE, 0, (cap - 1) // TILE)
    inside = (right >= tile * TILE - 1) & (right < (tile + 1) * TILE)
    # int64 max also counts the padding of the last, partial tile
    top = q == I64_MAX
    np.testing.assert_array_equal(tj.numpy()[inside & ~top],
                                  right[inside & ~top])
    assert (tj.numpy()[top] == (tile[top] + 1) * TILE - 1).all()


def test_route_and_search_overflowing_tile():
    """600 queries all predicted into tile 0 of 4096 slots: ``ok`` equals
    JAX's (the first 512 in batch order), and every ``ok`` ``j`` equals the
    searchsorted oracle — including the query whose entry the reference's
    overflow scatter overwrites (ROADMAP §3)."""
    r = np.random.default_rng(13)
    slots = np.sort(r.integers(0, 1 << 48, 4096)).astype(np.int64)
    q = r.integers(0, 1 << 48, 600).astype(np.int64)
    pred = np.zeros(600, np.float32)
    jj, jok = jops.route_and_search(jnp.asarray(slots), jnp.asarray(q),
                                    jnp.asarray(pred))
    tj, tok = ops.route_and_search(torch.tensor(slots), torch.tensor(q),
                                   torch.tensor(pred))
    jok = np.asarray(jok)
    np.testing.assert_array_equal(tok.numpy(), jok)
    assert jok.sum() == Q_BLK and jok[:Q_BLK].all()
    oracle = np.searchsorted(slots[:TILE], q, side="right") - 1
    np.testing.assert_array_equal(tj.numpy()[jok], oracle[jok])
    assert (tj.numpy()[~jok] == -1).all()
    bad = np.nonzero(np.asarray(jj)[jok] != oracle[jok])[0]
    assert list(bad) in ([], [Q_BLK - 1])  # the reference's one victim


# ---------------------------------------------------------------------------
# ops.bmat_rank, both routes
# ---------------------------------------------------------------------------


def _rank_buffer(r, cap, n, hi, fanout):
    arr = np.full(cap, I64_MAX, np.int64)
    arr[:n] = np.sort(r.integers(0, hi, n).astype(np.int64))
    fences = np.concatenate([arr[::fanout], [I64_MAX]])
    return arr, fences


@pytest.mark.parametrize("cap,fanout", [(4096, 8), (4096, 64), (65536, 16)])
def test_bmat_rank_k2_route_matches_jax(cap, fanout):
    r = np.random.default_rng(cap + fanout)
    arr, fences = _rank_buffer(r, cap, cap // 2, 1 << 48, fanout)
    q = np.concatenate([r.integers(0, 1 << 48, 1000), r.choice(arr, 24),
                        [0, I64_MAX]]).astype(np.int64)
    got = ops.bmat_rank(torch.tensor(arr), torch.tensor(fences),
                        torch.tensor(q), fanout)
    want = np.asarray(jops.bmat_rank(jnp.asarray(arr), jnp.asarray(fences),
                                     jnp.asarray(q), fanout))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.searchsorted(arr, q, "left"))


def test_bmat_rank_tiled_route_matches_jax(monkeypatch):
    """Above ``TILED_RANK_ABOVE`` keys the rank takes the tiled K4
    composition, as the reference does, and stays exact under a
    duplicated batch that needs more than one pass; one K4 call runs every
    pass (``ceil(n / Q_BLK)`` bound every segment)."""
    r = np.random.default_rng(11)
    cap = 2 * ops.TILED_RANK_ABOVE
    n = cap - 777
    arr, fences = _rank_buffer(r, cap, n, 1 << 52, 16)
    q = np.concatenate([
        r.integers(0, 1 << 52, 1024), r.choice(arr[:n], 512),
        np.full(Q_BLK + 100, arr[5]),  # one tile, two passes
        np.full(2 * Q_BLK + 3, arr[n - 1]),  # one tile, three passes
        [0, 1, arr[0], arr[n - 1], 1 << 52, I64_MAX],
    ]).astype(np.int64)
    passes = []
    plain = tmod.tile_search_plain

    def spy(*a, **k):
        passes.append((k["pass_idx"], k["pass_hi"]))
        return plain(*a, **k)

    monkeypatch.setattr(tmod, "tile_search_plain", spy)
    got = ops.bmat_rank(torch.tensor(arr), torch.tensor(fences),
                        torch.tensor(q), 16)
    assert passes == [(0, -(-len(q) // Q_BLK))]
    want = np.asarray(jops.bmat_rank(jnp.asarray(arr), jnp.asarray(fences),
                                     jnp.asarray(q), 16))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.searchsorted(arr, q, "left"))


def test_bmat_rank_tiled_on_a_ragged_last_tile():
    """A buffer whose last tile is partial: the rank clips to cap."""
    r = np.random.default_rng(12)
    cap = ops.TILED_RANK_ABOVE + 1000
    arr = np.sort(r.integers(0, 1 << 50, cap)).astype(np.int64)
    fences = np.concatenate([arr[::16], [I64_MAX]])
    q = np.concatenate([r.integers(0, 1 << 50, 700), arr[-3:],
                        [arr[-1] + 1, I64_MAX]]).astype(np.int64)
    got = ops.bmat_rank(torch.tensor(arr), torch.tensor(fences),
                        torch.tensor(q), 16)
    np.testing.assert_array_equal(got.numpy(), np.searchsorted(arr, q, "left"))


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions (skip without a card)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("domain", ["wikits", "wrap", "fb"])
def test_spline_lookup_cuda_matches_plain(cuda, domain):
    keys, m, st = _spline(domain)
    tm = model_from_numpy([np.asarray(a) for a in m], device=cuda)
    q = torch.tensor(_k5_queries(keys, int(m.shift), seed=1), device=cuda)
    kw = dict(shift=int(m.shift), n_iters=st.n_search_iters)
    got = spline_lookup(tm.table, tm.spline_keys, tm.spline_pos, q, **kw)
    want = spline_lookup_plain(tm.table, tm.spline_keys, tm.spline_pos, q,
                               **kw)
    torch.cuda.synchronize()
    _same_bits(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("case", K5_EDGES)
def test_spline_lookup_cuda_at_the_edges(cuda, case):
    """K5's kernel against its plain version, bit for bit, on every edge
    case of its one-round and bisect paths, also with ``n_iters`` 0 and
    ``n_iters`` far above what the ranges need."""
    (table, sk, sp), shift, n_iters, q, _ = _k5_edge(case)
    t = lambda a: torch.as_tensor(a, device=cuda)  # noqa: E731
    args = (t(table), t(sk), t(sp), t(q))
    for it in (n_iters, 0, 2 * n_iters + 7):
        before = spline_lookup.launches
        got = spline_lookup(*args, shift=shift, n_iters=it)
        torch.cuda.synchronize()
        assert spline_lookup.launches == before + 1
        want = spline_lookup_plain(*args, shift=shift, n_iters=it)
        _same_bits(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.gpu
def test_spline_lookup_below_shift_32_launches_k5(cuda):
    keys, m, st = _spline("wikits")
    assert int(m.shift) < 32
    tm = model_from_numpy([np.asarray(a) for a in m], device=cuda)
    q = torch.tensor(keys[:100], device=cuda)
    ops.reset_launch_counts()
    ops.spline_lookup(tm.table, tm.spline_keys, tm.spline_pos, tm.shift, q,
                      st.n_search_iters)
    assert ops.launch_counts()["spline_lookup"] == 1


@pytest.mark.gpu
def test_tile_search_cuda_matches_plain(cuda):
    slots, q, pred = _route_case(5, 30_000, 2048)
    dup = np.full(Q_BLK + 40, slots[7])
    q = np.concatenate([q, dup])
    pred = np.concatenate([pred, np.zeros(len(dup), np.float32)])
    ts, tq, tp = (torch.tensor(a, device=cuda) for a in (slots, q, pred))
    ops.reset_launch_counts()
    j, ok = ops.route_and_search(ts, tq, tp)
    assert ops.launch_counts()["tile_search"] == 1
    j0, ok0 = ops.route_and_search(ts.cpu(), tq.cpu(), tp.cpu())
    np.testing.assert_array_equal(ok.cpu().numpy(), ok0.numpy())
    np.testing.assert_array_equal(j.cpu().numpy(), j0.numpy())
    k4_in = ops._route_tiles(ts, tq, tp)[3]
    for p in range(2):
        got = tile_search(ts, *k4_in, pass_idx=p)
        want = tile_search_plain(ts, *k4_in, pass_idx=p)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def _on(cuda, case, offset=0):
    """A K4 case on the card; ``offset`` 1 leaves the slot array only
    8-byte aligned (a view one key into its storage)."""
    slots = np.concatenate([np.zeros(offset, np.int64), case[0]])
    return [torch.as_tensor(slots, device=cuda)[offset:]] + [
        torch.as_tensor(a, device=cuda) for a in case[1:]]


@pytest.mark.gpu
@pytest.mark.parametrize("sorted_tiles", [True, False])
@pytest.mark.parametrize("cap", [5 * TILE + 333, 5 * TILE + 334])
def test_tile_search_cuda_pass_range(cuda, sorted_tiles, cap):
    """K4 over a pass range in one launch equals its plain version, the
    same kernel's passes in turn and the numpy oracle: sorted and unsorted
    tiles, a ragged last tile of an odd and an even key count, segments of
    1, 512, 513 and 1100 queries, a 16-byte and an 8-byte aligned slot
    array."""
    case = _k4_case(cap, cap, K4_SIZES, sorted_tiles)
    for offset in (0, 1):
        args = _on(cuda, case, offset)
        assert args[0].data_ptr() % 16 == 8 * offset
        for lo, hi in ((0, 1), (1, 3), (0, 3), (0, 9)):
            before = tile_search.launches
            got = tile_search(*args, pass_idx=lo, pass_hi=hi)
            assert tile_search.launches == before + 1
            in_turn = None
            for p in range(lo, hi):
                in_turn = tile_search(*args, pass_idx=p, out=in_turn)
            want = tile_search_plain(*args, pass_idx=lo, pass_hi=hi)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (offset, lo, hi)
            assert torch.equal(got, in_turn), (offset, lo, hi)
            np.testing.assert_array_equal(got.cpu().numpy(),
                                          _k4_oracle(*case, lo, hi))


@pytest.mark.gpu
def test_tile_search_cuda_more_segments_than_ctas(cuda):
    """3000 segments, more than the grid's CTAs (about six per SM), each CTA
    walking several; one segment of 600 queries takes two passes."""
    r = np.random.default_rng(8)
    sizes = list(r.integers(1, 4, 2999)) + [600]
    case = _k4_case(8, 3000 * TILE - 5, sizes, sorted_tiles=False)
    args = _on(cuda, case)
    for lo, hi in ((0, 1), (1, 2), (0, 2)):
        got = tile_search(*args, pass_idx=lo, pass_hi=hi)
        want = tile_search_plain(*args, pass_idx=lo, pass_hi=hi)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (lo, hi)
        assert int((got >= 0).sum()) > 0


@pytest.mark.gpu
def test_bmat_rank_tiled_launches_k4_once(cuda):
    """The tiled rank on the card: one K4 launch for a batch that needs
    three passes, exact against searchsorted and the CPU."""
    r = np.random.default_rng(11)
    cap = 2 * ops.TILED_RANK_ABOVE
    arr, fences = _rank_buffer(r, cap, cap - 777, 1 << 52, 16)
    q = np.concatenate([r.integers(0, 1 << 52, 1024),
                        np.full(2 * Q_BLK + 3, arr[cap - 778]),
                        [0, 1, I64_MAX]]).astype(np.int64)
    ta, tf, tq = (torch.as_tensor(a, device=cuda) for a in (arr, fences, q))
    ops.reset_launch_counts()
    got = ops.bmat_rank(ta, tf, tq, 16)
    torch.cuda.synchronize()
    assert ops.launch_counts()["tile_search"] == 1
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  np.searchsorted(arr, q, "left"))
    cpu = ops.bmat_rank(ta.cpu(), tf.cpu(), tq.cpu(), 16)
    np.testing.assert_array_equal(got.cpu().numpy(), cpu.numpy())
