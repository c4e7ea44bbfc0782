"""K1, the fused locate, across the shapes its CUDA kernel handles.

The kernel counts where the reference bisects: the knots <= q in the
bucket's range (one 32-lane round) and the slot keys <= q in the 3-row span
(a probe per 32-key chunk of the address space, then one chunk). That
equals the bisects only on sorted arrays and converging knot searches, so
the CPU tests here check that invariant on the JAX UpLIF's own states after
its op tapes, and hold the plain version to the Pallas kernel (interpret
mode, zero tolerance) on the edge cases the kernel's index arithmetic has
to get right: windows of 16 to 128, capacities below 3W, spans clipped at
both ends, duplicate runs and KEY_MAX tails, queries below and above the
span. The ``gpu`` tests hold the CUDA kernel to the plain version on the
same cases, exactly, in both interpolation modes.
"""
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401 — x64
import jax.numpy as jnp
from repro.core import UpLIF as JaxUpLIF
from repro.core.uplif import UpLIFConfig as JaxConfig
from repro.kernels.ops import split_key
from repro.kernels.spline_lookup import LOC_Q_BLK, fused_locate_pallas
from repro_torch.core.radix_spline import build_radix_spline
from repro_torch.core.types import KEY_MAX
from repro_torch.kernels.spline_lookup import (
    fused_locate, fused_locate_plain, knot_segment_plain, span_length,
)
from tests.test_locate_fused import _tape

# per-shard key domains: radix shifts 16, 26, 36 and 48 at 4 radix bits
DOMAINS = (1 << 20, 1 << 30, 1 << 40, 1 << 52)
RADIX_BITS = 4
# per-shard spline error bounds: from a knot per key (knot ranges wider
# than one 32-lane round) to a few knots
MAX_ERRORS = (1, 4, 16, 64)


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


def _k1_shard(r, window, cap, dom, max_error):
    """One shard: keys at random slots of ``cap`` with the gaps filled
    forward, a run of 2W duplicates, a KEY_MAX tail, and a radix spline
    with up to 2W of noise on its knot positions, so that predictions miss
    the span on either side."""
    n_live = max(2, cap // 3)
    keys = np.unique(r.integers(1, dom, 2 * n_live))[:n_live].astype(np.int64)
    used = np.setdiff1d(np.arange(cap - window // 2),
                        np.arange(cap // 3, cap // 3 + 2 * window))
    pos = np.sort(r.choice(used, len(keys), replace=False))
    owner = np.maximum.accumulate(
        np.where(np.isin(np.arange(cap), pos), np.arange(cap), -1))
    slots = keys[np.searchsorted(pos, np.maximum(owner, pos[0]))]
    slots[pos[-1] + 1 + int(r.integers(0, 3)):] = KEY_MAX
    model, static = build_radix_spline(keys, pos, radix_bits=RADIX_BITS,
                                       max_error=max_error, device="cpu")
    noise = r.integers(-2 * window, 2 * window + 1, len(model.spline_pos))
    model.spline_pos[:] = torch.as_tensor(np.clip(np.maximum.accumulate(
        model.spline_pos.numpy() + noise), 0, cap - 1))
    return keys, slots, model, static.n_search_iters


def _k1_case(window, n_shards, small, seed):
    """S stacked shards (flat over the shard axis, knots padded with the
    last knot) and a query pool with a shard id each: hits, misses, keys
    below and above the domain, the span's duplicate keys, 0 and KEY_MAX.
    ``small`` makes cap < 3W (the span is the whole shard)."""
    r = np.random.default_rng(seed)
    cap = 2 * window + 5 if small else 24 * window + 8
    shards = [_k1_shard(r, window, cap, DOMAINS[s % len(DOMAINS)],
                        MAX_ERRORS[s % len(MAX_ERRORS)])
              for s in range(n_shards)]
    n_knots = max(m.spline_keys.shape[0] for _, _, m, _ in shards)
    pad = lambda a: np.concatenate(  # noqa: E731
        [a, np.repeat(a[-1:], n_knots - len(a))])
    q, sid = [], []
    for s, (keys, slots, _, _) in enumerate(shards):
        dom = DOMAINS[s % len(DOMAINS)]
        part = np.concatenate([
            r.choice(keys, 300), r.integers(0, dom, 300),
            dom + r.integers(0, 1 << 40, 40), r.choice(slots, 60),
            [0, 1, keys[0] - 1, keys[0], keys[-1], keys[-1] + 1,
             KEY_MAX - 1, KEY_MAX, KEY_MAX],
        ]).astype(np.int64)
        q.append(part)
        sid.append(np.full(len(part), s, np.int64))
    order = r.permutation(sum(len(p) for p in q))
    return dict(
        table=np.concatenate([m.table.numpy() for _, _, m, _ in shards]),
        knots=np.concatenate([pad(m.spline_keys.numpy())
                              for _, _, m, _ in shards]),
        pos=np.concatenate([pad(m.spline_pos.numpy())
                            for _, _, m, _ in shards]),
        shift=np.asarray([int(m.shift) for _, _, m, _ in shards], np.int32),
        slots=np.concatenate([sl for _, sl, _, _ in shards]),
        n_table=shards[0][2].table.shape[0], n_knots=n_knots, cap=cap,
        window=window, rs_iters=max(it for _, _, _, it in shards),
        queries=np.concatenate(q)[order], sid=np.concatenate(sid)[order],
    )


def _kw(f, rs_iters=None, **extra):
    return dict(n_table=f["n_table"], n_knots=f["n_knots"], cap=f["cap"],
                window=f["window"],
                rs_iters=f["rs_iters"] if rs_iters is None else rs_iters,
                **extra)


def _plain(f, q, sid, **kw):
    t = torch.as_tensor
    j, start = fused_locate_plain(
        t(f["table"]), t(f["knots"]), t(f["pos"]), t(f["shift"]),
        t(f["slots"]), t(q), None if sid is None else t(sid), **_kw(f, **kw))
    return j.numpy(), start.numpy()


def _pallas(f, q, sid, rs_iters):
    pad = -len(q) % LOC_Q_BLK
    qp = np.concatenate([q, np.full(pad, KEY_MAX, np.int64)])
    sp = np.concatenate([sid, np.zeros(pad, np.int64)])
    sk_hi, sk_lo = split_key(jnp.asarray(f["knots"]))
    sl_hi, sl_lo = split_key(jnp.asarray(f["slots"]))
    q_hi, q_lo = split_key(jnp.asarray(qp))
    i32 = lambda x: jnp.asarray(x.astype(np.int32))  # noqa: E731
    j, start = fused_locate_pallas(
        jnp.asarray(f["table"]), sk_hi, sk_lo,
        jnp.asarray(f["pos"].astype(np.float32)), sl_hi, sl_lo, q_hi, q_lo,
        i32(sp * f["n_table"]), i32(sp * f["n_knots"]), i32(sp * f["cap"]),
        i32(f["shift"][sp]), interpret=True, **_kw(f, rs_iters),
    )
    return np.asarray(j)[: len(q)], np.asarray(start)[: len(q)]


def _knot_ranges(f, q, sid):
    """The knot bisect's candidate range [lo, hi] per query (flat)."""
    nt, nk = f["n_table"], f["n_knots"]
    b = np.clip(q >> f["shift"][sid].astype(np.int64), 0, nt - 3)
    t0 = f["table"][sid * nt + b].astype(np.int64)
    t1 = f["table"][sid * nt + b + 1].astype(np.int64)
    return sid * nk + np.maximum(t0, 1) - 1, sid * nk + np.clip(t1, 0, nk - 2)


@pytest.mark.parametrize("window", [16, 32, 64, 128])
def test_fused_locate_plain_matches_pallas_at_the_edges(window):
    """The plain K1 equals the Pallas kernel on the edge cases, with the
    model's ``rs_iters`` and with 1 step (a knot bisect that stops before
    converging), for 4 stacked shards at cap > 3W and cap < 3W; and the
    cases do reach the edges the CUDA kernel's counting has to get right."""
    for small in (False, True):
        f = _k1_case(window, 4, small, seed=window + small)
        q, sid = f["queries"], f["sid"]
        L = span_length(window, f["cap"])
        for rs_iters in (f["rs_iters"], 1):
            j_ref, start_ref = _pallas(f, q, sid, rs_iters)
            j, start = _plain(f, q, sid, rs_iters=rs_iters)
            np.testing.assert_array_equal(j, j_ref)
            np.testing.assert_array_equal(start, start_ref)
        j, start = _plain(f, q, sid)
        assert (start == 0).any() and (j == start - 1).any()
        assert (j == start + L - 1).any()          # every span key <= q
        assert (q == KEY_MAX).any()
        found = j >= start
        assert (f["slots"][sid[found] * f["cap"] + j[found]] == q[found]).any()
        if small:
            assert L == f["cap"] and (start == 0).all()
        else:
            assert (start == f["cap"] - L).any()   # clipped at the top
            assert ((j == start - 1) & (start > 0)).any()  # below the span
        lo, hi = _knot_ranges(f, q, sid)
        assert (hi - lo + 1 > 2).any()  # rs_iters = 1 leaves some unconverged


@pytest.mark.parametrize("seed,window,max_error,movement_k", [
    (0, 64, 24, 6), (1, 16, 2, 4), (2, 32, 8, 6), (3, 128, 24, 6)])
def test_counting_equals_the_bisects_on_jax_index_states(
        seed, window, max_error, movement_k):
    """The invariant the CUDA K1 rests on, on the JAX UpLIF's own slot
    array and model after an op tape (inserts, deletes, revivals, value
    updates): the slot keys never decrease, every knot range converges in
    ``rs_iters`` steps, ``lo + count(knots[lo+1 .. hi] <= q)`` is the plain
    version's knot segment, and ``start - 1 + count(span <= q)`` its j."""
    base, vals, ops_tape, probes, _ = _tape(seed)
    idx = JaxUpLIF(base, vals, JaxConfig(
        locate="spline", window=window, max_error=max_error,
        movement_k=movement_k))
    for op in ops_tape:
        if op[0] == "insert":
            idx.insert(op[1], op[2])
        else:
            idx.delete(op[1])
    slots = np.array(idx.slots.keys)
    m = idx.rs_model
    rs_iters = idx.fstatic().rs_iters
    f = dict(table=np.array(m.table), knots=np.array(m.spline_keys),
             pos=np.array(m.spline_pos),
             shift=np.array(m.shift, np.int32).reshape(1), slots=slots,
             n_table=m.table.shape[0], n_knots=m.spline_keys.shape[0],
             cap=len(slots), window=window, rs_iters=rs_iters)
    q = np.concatenate([probes, slots[::5], [0, KEY_MAX - 1, KEY_MAX]])
    sid = np.zeros(len(q), np.int64)
    assert (np.diff(slots) >= 0).all()

    lo, hi = _knot_ranges(f, q, sid)
    assert (hi - lo + 1 <= 1 << rs_iters).all()
    counted = np.asarray([a + np.count_nonzero(f["knots"][a + 1:b + 1] <= x)
                          for a, b, x in zip(lo, hi, q)])
    t = torch.as_tensor
    seg = knot_segment_plain(t(f["table"]), t(f["knots"]), t(f["shift"]),
                             t(q), n_table=f["n_table"],
                             n_knots=f["n_knots"], rs_iters=rs_iters)
    np.testing.assert_array_equal(counted, seg.numpy())

    j, start = _plain(f, q, None)
    L = span_length(window, len(slots))
    span = slots[start[:, None] + np.arange(L)]
    np.testing.assert_array_equal(start - 1 + (span <= q[:, None]).sum(1), j)


@pytest.mark.gpu
@pytest.mark.parametrize("interp64", [False, True])
@pytest.mark.parametrize("window", [16, 32, 64, 128])
def test_fused_locate_cuda_equals_plain_across_shapes(cuda, window, interp64):
    """The CUDA K1 against the plain version, exactly: cap > 3W and
    cap < 3W, 1 and 4 stacked shards with shard ids and without (all
    shard 0), a slot array that starts 0, 8, 56 and 248 bytes into its
    allocation (the kernel's chunks start on 256-byte boundaries), the
    model's ``rs_iters`` and 1 (the kernel's bisect branch), batches of 1,
    31 and 4097 queries."""
    for n_shards in (1, 4):
        for small in (False, True):
            f = _k1_case(window, n_shards, small, seed=window + small)
            dev = {k: torch.as_tensor(f[k], device=cuda)
                   for k in ("table", "knots", "pos", "shift")}
            for lead in (0, 1, 7, 31):
                buf = torch.zeros(len(f["slots"]) + lead, dtype=torch.int64,
                                  device=cuda)
                buf[lead:] = torch.as_tensor(f["slots"])
                slots = buf[lead:]
                for rs_iters, n in ((f["rs_iters"], 1), (f["rs_iters"], 31),
                                    (f["rs_iters"], 4097), (1, 4097)):
                    q = torch.as_tensor(np.resize(f["queries"], n),
                                        device=cuda)
                    s = torch.as_tensor(np.resize(f["sid"], n), device=cuda)
                    for sid in (None, s):
                        args = (dev["table"], dev["knots"], dev["pos"],
                                dev["shift"], slots, q, sid)
                        kw = _kw(f, rs_iters, interp64=interp64)
                        before = fused_locate.launches
                        j, start = fused_locate(*args, **kw)
                        torch.cuda.synchronize()
                        assert fused_locate.launches == before + 1
                        j0, start0 = fused_locate_plain(*args, **kw)
                        case = (n_shards, small, lead, rs_iters, n,
                                sid is None)
                        assert torch.equal(j, j0), case
                        assert torch.equal(start, start0), case
