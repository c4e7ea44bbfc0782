"""The port's kernels and host builders against the JAX package, on the CPU.

K1 and K2 run their plain torch versions here (the CUDA kernels have no
CPU mode) and are held to the Pallas kernels in interpret mode with zero
tolerance: both are integer searches around one float32 interpolation, and
the plain K1 reproduces the fused multiply-add that the Pallas reference
run computes for the lerp (see ``repro_torch/kernels/spline_lookup.py``).
The tests marked ``gpu`` hold the CUDA kernels to the plain versions and
skip without a card.
"""
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401 — x64
import jax.numpy as jnp
from repro.core import bmat as jbmat
from repro.core.gmm import init_gmm_uniform as jax_init_gmm
from repro.core.nullifier import nullify as jax_nullify
from repro.core.radix_spline import build_radix_spline as jax_build_rs
from repro.kernels.bmat_rank import OFF_Q_BLK, bmat_rank_offset_pallas
from repro.kernels.gmm_estep import N_BLK as GMM_N_BLK, gmm_estep_pallas
from repro.kernels.ops import split_key
from repro.kernels.spline_lookup import LOC_Q_BLK, fused_locate_pallas
from repro_torch.core import bmat as tbmat
from repro_torch.core.gmm import init_gmm_uniform
from repro_torch.core.nullifier import nullify
from repro_torch.core.radix_spline import build_radix_spline
from repro_torch.core.types import KEY_MAX
from repro_torch.kernels import ops
from repro_torch.kernels.bmat_rank import bmat_rank, bmat_rank_plain
from repro_torch.kernels.gmm_estep import gmm_estep
from repro_torch.kernels.ref import gmm_estep_plain
from repro_torch.kernels.spline_lookup import fused_locate, fused_locate_plain
from tests.conftest import make_keys

WINDOW = 64
RS_ITERS = 8
# per-shard key domains: radix shift 4 (below 32), 36 and 26
DOMAINS = {"small": 1 << 20, "big": 1 << 52, "mid": 1 << 42}


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


def _shard(n, hi, seed):
    keys = make_keys(n, seed, hi=hi)
    gmm = init_gmm_uniform(float(keys[0]), float(keys[-1]))
    res = nullify(keys, keys + 1, gmm, d_max=32, tail_slack=WINDOW,
                  align=WINDOW, device="cpu")
    model, static = build_radix_spline(keys, res.positions, max_error=24,
                                       device="cpu")
    return keys, res.slots.keys.numpy(), model, static


def _flat_index(domains, n=3000):
    """S shards flattened over the shard axis, padded to common sizes."""
    shards = [_shard(n + 97 * s, DOMAINS[d], 11 + s)
              for s, d in enumerate(domains)]
    cap = max(len(sl) for _, sl, _, _ in shards)
    n_knots = max(m.spline_keys.shape[0] for _, _, m, _ in shards)
    table, knots, pos, slots, shift = [], [], [], [], []
    for _, sl, m, _ in shards:
        sk, sp = m.spline_keys.numpy(), m.spline_pos.numpy()
        pad = n_knots - len(sk)
        knots.append(np.concatenate([sk, np.repeat(sk[-1:], pad)]))
        pos.append(np.concatenate([sp, np.repeat(sp[-1:], pad)]))
        slots.append(np.concatenate(
            [sl, np.full(cap - len(sl), KEY_MAX, np.int64)]))
        table.append(m.table.numpy())
        shift.append(int(m.shift))
    return dict(
        keys=[k for k, _, _, _ in shards],
        table=np.concatenate(table), knots=np.concatenate(knots),
        pos=np.concatenate(pos),
        slots=np.concatenate(slots), shift=np.asarray(shift, np.int32),
        n_table=len(table[0]), n_knots=n_knots, cap=cap,
    )


def _queries(shard_keys, domains, seed, n_per=400):
    """Hits, misses, above-domain keys and KEY_MAX padding, per shard."""
    r = np.random.default_rng(seed)
    q, sid = [], []
    for s, (keys, d) in enumerate(zip(shard_keys, domains)):
        hi = DOMAINS[d]
        part = np.concatenate([
            r.choice(keys, n_per),                                 # hits
            r.integers(0, hi, n_per),                              # misses
            hi + r.integers(0, 1 << 50, n_per // 4),               # above
            [0, keys[0], keys[-1], keys[-1] + 1, KEY_MAX, KEY_MAX],
        ]).astype(np.int64)
        q.append(part)
        sid.append(np.full(len(part), s, np.int64))
    return np.concatenate(q), np.concatenate(sid)


def _pallas_locate(f, q, sid):
    pad = -len(q) % LOC_Q_BLK
    qp = np.concatenate([q, np.full(pad, KEY_MAX, np.int64)])
    sp = np.concatenate([sid, np.zeros(pad, np.int64)])
    sk_hi, sk_lo = split_key(jnp.asarray(f["knots"]))
    sl_hi, sl_lo = split_key(jnp.asarray(f["slots"]))
    q_hi, q_lo = split_key(jnp.asarray(qp))
    i32 = lambda x: jnp.asarray(x.astype(np.int32))  # noqa: E731
    j, start = fused_locate_pallas(
        jnp.asarray(f["table"]), sk_hi, sk_lo,
        jnp.asarray(f["pos"].astype(np.float32)),
        sl_hi, sl_lo, q_hi, q_lo,
        i32(sp * f["n_table"]), i32(sp * f["n_knots"]), i32(sp * f["cap"]),
        i32(f["shift"][sp]),
        n_table=f["n_table"], n_knots=f["n_knots"], cap=f["cap"],
        window=WINDOW, rs_iters=RS_ITERS, interpret=True,
    )
    return np.asarray(j)[: len(q)], np.asarray(start)[: len(q)]


def _torch_locate(fn, f, q, sid, device="cpu", **kw):
    t = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    j, start = fn(
        t(f["table"]), t(f["knots"]), t(f["pos"]), t(f["shift"]),
        t(f["slots"]), t(q), None if sid is None else t(sid),
        n_table=f["n_table"], n_knots=f["n_knots"], cap=f["cap"],
        window=WINDOW, rs_iters=RS_ITERS, **kw,
    )
    return j.cpu().numpy(), start.cpu().numpy()


@pytest.mark.parametrize("domains", [("small",), ("big",),
                                     ("small", "big", "mid")])
def test_fused_locate_plain_matches_pallas(domains):
    f = _flat_index(domains)
    assert sorted(set(f["shift"] < 32)) == sorted({d == "small" for d in domains})
    q, sid = _queries(f["keys"], domains, seed=len(domains))
    j_ref, start_ref = _pallas_locate(f, q, sid)
    j, start = _torch_locate(fused_locate_plain, f, q, sid)
    np.testing.assert_array_equal(j, j_ref)
    np.testing.assert_array_equal(start, start_ref)
    # the wrapper takes the plain version for CPU tensors, and counts no launch
    before = ops.launch_counts()
    j2, _ = _torch_locate(fused_locate, f, q, sid)
    np.testing.assert_array_equal(j2, j_ref)
    assert ops.launch_counts() == before
    if len(domains) == 1:  # a single shard needs no shard ids
        j3, start3 = _torch_locate(fused_locate, f, q, None)
        np.testing.assert_array_equal(j3, j_ref)
        np.testing.assert_array_equal(start3, start_ref)
    # hits are found exactly: the slot at j holds the query key
    hits = np.isin(q, np.concatenate(f["keys"])) & (q != KEY_MAX)
    flat = sid[hits] * f["cap"] + j[hits]
    np.testing.assert_array_equal(f["slots"][flat], q[hits])


@pytest.mark.parametrize("domain", ["small", "big", "mid"])
def test_fused_locate_interp64_matches_spline_path(domain):
    """Above the f32 position bound the JAX package leaves the TPU kernel
    for its float64 spline path; K1's float64 mode must give that path's
    (j, icap), here held to the JAX ``_locate`` and the port's own."""
    from repro.core.fops import _locate as jax_locate
    from repro.core.state import UpLIFStatic as JaxStatic
    from repro.core.types import RadixSplineModel as JaxModel
    from repro_torch.core.fops import _locate as torch_locate
    from repro_torch.core.state import UpLIFStatic

    f = _flat_index((domain,))
    q, _ = _queries(f["keys"], (domain,), seed=21)
    j, start = _torch_locate(fused_locate, f, q, None, interp64=True)
    icap = start + (min(3 * WINDOW, f["cap"]) - 1)

    _, slots, model, _ = _shard(3000, DOMAINS[domain], 11)
    kw = dict(window=WINDOW, movement_k=6, rs_iters=RS_ITERS,
              insert_rounds=3, fanout=16, bmat_kind="b+mat", locate="spline")
    jm = JaxModel(*[jnp.asarray(a.numpy()) for a in model])
    j_ref, icap_ref = jax_locate(JaxStatic(**kw), jnp.asarray(slots), jm,
                                 jnp.asarray(q))
    np.testing.assert_array_equal(j, np.asarray(j_ref))
    np.testing.assert_array_equal(icap, np.asarray(icap_ref))
    j_t, icap_t = torch_locate(UpLIFStatic(**kw), torch.as_tensor(slots),
                               model, torch.as_tensor(q))
    np.testing.assert_array_equal(j, j_t.numpy())
    np.testing.assert_array_equal(icap, icap_t.numpy())


def test_fused_locate_modes_at_a_rounding_edge():
    """A query whose exact position is 127.5 - 2^-28: float32 key deltas
    round it to 127.5 (rounded half to even: slot 128, span from row 1),
    float64 keeps it below (slot 127, span from row 0). The float32 mode
    must agree with the Pallas kernel and the float64 mode with the spline
    path, in JAX and in the port."""
    from repro.core.fops import _locate as jax_locate
    from repro.core.state import UpLIFStatic as JaxStatic
    from repro.core.types import RadixSplineModel as JaxModel
    from repro_torch.core.fops import _locate as torch_locate
    from repro_torch.core.state import UpLIFStatic

    cap, step = 4096, 1 << 28
    model, _ = build_radix_spline(np.asarray([0, cap * step]),
                                  np.asarray([0, cap]), device="cpu")
    slots = np.arange(cap, dtype=np.int64) * step
    q = np.asarray([255 * step // 2 - 1, 5 * step, KEY_MAX], np.int64)
    f = dict(table=model.table.numpy(), knots=model.spline_keys.numpy(),
             pos=model.spline_pos.numpy(), slots=slots,
             shift=model.shift.numpy().reshape(1), n_table=model.table.shape[0],
             n_knots=model.spline_keys.shape[0], cap=cap)
    sid = np.zeros(len(q), np.int64)
    j32, start32 = _torch_locate(fused_locate, f, q, sid)
    j64, start64 = _torch_locate(fused_locate, f, q, sid, interp64=True)
    assert (j32[0], start32[0], j64[0], start64[0]) == (127, 64, 127, 0)

    j_ref, start_ref = _pallas_locate(f, q, sid)
    np.testing.assert_array_equal(j32, j_ref)
    np.testing.assert_array_equal(start32, start_ref)
    kw = dict(window=WINDOW, movement_k=6, rs_iters=RS_ITERS,
              insert_rounds=3, fanout=16, bmat_kind="b+mat", locate="spline")
    jm = JaxModel(*[jnp.asarray(a.numpy()) for a in model])
    j_s, icap_s = jax_locate(JaxStatic(**kw), jnp.asarray(slots), jm,
                             jnp.asarray(q))
    np.testing.assert_array_equal(j64, np.asarray(j_s))
    np.testing.assert_array_equal(start64 + 3 * WINDOW - 1, np.asarray(icap_s))
    j_t, icap_t = torch_locate(UpLIFStatic(**kw), torch.as_tensor(slots),
                               model, torch.as_tensor(q))
    np.testing.assert_array_equal(j64, j_t.numpy())
    np.testing.assert_array_equal(start64 + 3 * WINDOW - 1, icap_t.numpy())


def _bmat_arrays(n_shards, cap, fanout, seed):
    r = np.random.default_rng(seed)
    keys = np.full((n_shards, cap), KEY_MAX, np.int64)
    for s in range(n_shards):
        m = cap // 2 + 37 * s
        keys[s, :m] = np.sort(r.choice(1 << 48, m, replace=False))
    fences = np.concatenate(
        [keys[:, ::fanout], np.full((n_shards, 1), KEY_MAX, np.int64)], axis=1
    )
    return keys, fences


@pytest.mark.parametrize("n_shards,cap,fanout", [
    (1, 16, 16),      # one node: the fence array is [KEY_MAX], nf = 1
    (1, 4096, 16),
    (3, 2048, 8),
    (2, 4096, 128),   # nodes wider than K2's one-ballot round of 64 keys
    (1, 8192, 256),
])
def test_bmat_rank_plain_matches_pallas(n_shards, cap, fanout):
    keys, fences = _bmat_arrays(n_shards, cap, fanout, seed=cap + n_shards)
    if cap == fanout:
        fences = np.full((n_shards, 1), KEY_MAX, np.int64)
    nf = fences.shape[1]
    r = np.random.default_rng(3)
    sid = r.integers(0, n_shards, 1500).astype(np.int64)
    q = np.concatenate([
        r.integers(0, 1 << 48, 1000),
        keys[sid[1000:1400], r.integers(0, cap // 2, 400)],
        [0, 1, KEY_MAX, KEY_MAX - 1] * 25,
    ]).astype(np.int64)

    pad = -len(q) % OFF_Q_BLK
    qp = np.concatenate([q, np.full(pad, KEY_MAX, np.int64)])
    sp = np.concatenate([sid, np.zeros(pad, np.int64)]).astype(np.int32)
    kh, kl = split_key(jnp.asarray(keys.reshape(-1)))
    fh, fl = split_key(jnp.asarray(fences.reshape(-1)))
    qh, ql = split_key(jnp.asarray(qp))
    ref = np.asarray(bmat_rank_offset_pallas(
        kh, kl, fh, fl, qh, ql, jnp.asarray(sp * cap), jnp.asarray(sp * nf),
        cap=cap, nf=nf, fanout=fanout, interpret=True,
    ))[: len(q)]
    t = torch.as_tensor
    got = bmat_rank_plain(t(keys.reshape(-1)), t(fences.reshape(-1)), t(q),
                          t(sid), cap=cap, nf=nf, fanout=fanout).numpy()
    np.testing.assert_array_equal(got, ref)
    gold = [np.searchsorted(keys[s], k, "left") for s, k in zip(sid, q)]
    np.testing.assert_array_equal(got, gold)
    via_wrapper = bmat_rank(t(keys.reshape(-1)), t(fences.reshape(-1)), t(q),
                            t(sid), cap=cap, nf=nf, fanout=fanout).numpy()
    np.testing.assert_array_equal(via_wrapper, ref)
    if n_shards == 1:  # a single BMAT needs no shard ids
        no_sid = bmat_rank(t(keys.reshape(-1)), t(fences.reshape(-1)), t(q),
                           cap=cap, nf=nf, fanout=fanout).numpy()
        np.testing.assert_array_equal(no_sid, ref)


@pytest.mark.parametrize("fanout", [0])
def test_bmat_rank_refuses_a_fanout_its_node_round_cannot_read(fanout):
    """A node of fewer than one key means nothing: the wrapper raises, on
    the CPU as on the card, rather than run the plain version. Any fanout
    of 1 or more is taken (``test_bmat_rank_plain_matches_pallas`` holds
    fanouts 128 and 256 to the Pallas kernel)."""
    keys, fences = _bmat_arrays(1, 256, 16, seed=1)
    t = torch.as_tensor
    with pytest.raises(ValueError):
        bmat_rank(t(keys.reshape(-1)), t(fences.reshape(-1)),
                  t(keys[0, :10]), cap=256, nf=fences.shape[1], fanout=fanout)


def test_bound_counts_each_read_once():
    """``chip_smoke.py`` bounds a kernel by the distinct elements its plain
    version reads: a batch of copies of one query reads what one query
    reads."""
    import chip_smoke

    keys, fences = _bmat_arrays(1, 4096, 16, seed=2)
    t = torch.as_tensor
    k, fe = t(keys.reshape(-1)), t(fences.reshape(-1))
    kw = dict(cap=4096, nf=fences.shape[1], fanout=16)
    arrays = dict(keys=k, fences=fe)
    one = chip_smoke.read_footprint(torch, bmat_rank_plain, (k, fe, t(keys[0, 5:6])),
                                    kw, arrays)
    many = chip_smoke.read_footprint(torch, bmat_rank_plain,
                                     (k, fe, t(np.repeat(keys[0, 5:6], 100))),
                                     kw, arrays)
    fence_iters = int(np.ceil(np.log2(fences.shape[1] + 1)))
    node_iters = int(np.ceil(np.log2(17)))
    assert 0 < one == many <= 8 * (fence_iters + node_iters)
    spread = chip_smoke.read_footprint(
        torch, bmat_rank_plain, (k, fe, t(keys[0, :2048:16])), kw, arrays)
    assert spread > one


# ---------------------------------------------------------------------------
# host builders and BMAT primitives: byte-identical to the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hi", [1 << 20, 1 << 44, 1 << 52])
def test_builders_byte_identical(hi):
    keys = make_keys(5000, 7, hi=hi)
    vals = keys * 3 + 1
    jg = jax_init_gmm(float(keys[0]), float(keys[-1]))
    tg = init_gmm_uniform(float(keys[0]), float(keys[-1]))
    for a, b in zip(jg, tg):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    kw = dict(alpha_target=1.0, d_max=32, tail_slack=64, align=64)
    jn = jax_nullify(keys, vals, jg, **kw)
    tn = nullify(keys, vals, tg, device="cpu", **kw)
    for a, b in zip(jn.slots, tn.slots):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(jn.positions, tn.positions)
    np.testing.assert_array_equal(jn.gaps, tn.gaps)
    assert jn.alpha == tn.alpha
    jm, js = jax_build_rs(keys, jn.positions, radix_bits=16, max_error=24)
    tm, ts = build_radix_spline(keys, tn.positions, radix_bits=16,
                                max_error=24, device="cpu")
    assert tuple(js) == tuple(ts)
    for a, b in zip(jm, tm):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fanout", [8, 16])
def test_bmat_primitives_byte_identical(fanout):
    r = np.random.default_rng(fanout)
    cap = 4096
    size = 1500
    keys = np.full(cap, KEY_MAX, np.int64)
    keys[:size] = np.sort(r.choice(1 << 48, size, replace=False))
    vals = np.zeros(cap, np.int64)
    vals[:size] = r.integers(0, 1 << 40, size)
    new = np.setdiff1d(r.choice(1 << 48, 700, replace=False), keys)[:600]
    n_new = 517
    nk = np.full(1024, KEY_MAX, np.int64)
    nk[:n_new] = np.sort(new[:n_new])
    nv = np.zeros(1024, np.int64)
    nv[:n_new] = r.integers(0, 1 << 40, n_new)

    jk, jv, js = jbmat._merge(jnp.asarray(keys), jnp.asarray(vals),
                              jnp.asarray(size, jnp.int32), jnp.asarray(nk),
                              jnp.asarray(nv), jnp.asarray(n_new, jnp.int32))
    t = torch.as_tensor
    tk, tv, ts = tbmat._merge(t(keys), t(vals), torch.tensor(size, dtype=torch.int32),
                              t(nk), t(nv), torch.tensor(n_new, dtype=torch.int32))
    np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    assert int(js) == int(ts) and ts.dtype == torch.int32

    jf = np.asarray(jbmat._make_fences(jk, fanout))
    tf = tbmat._make_fences(tk, fanout).numpy()
    np.testing.assert_array_equal(jf, tf)

    q = np.concatenate([r.integers(0, 1 << 48, 700), np.asarray(jk)[:300:3],
                        [0, KEY_MAX]]).astype(np.int64)
    levels = int(np.log2(cap))
    jr = np.asarray(jbmat._rank_rbmat(jk, jnp.asarray(q), levels))
    tr = tbmat._rank_rbmat(tk, t(q), levels).numpy()
    np.testing.assert_array_equal(jr, tr)
    nf = len(jf)
    it = (int(np.ceil(np.log2(nf + 1))), int(np.ceil(np.log2(fanout + 1))))
    jb = np.asarray(jbmat._rank_bpmat(jk, jnp.asarray(jf), jnp.asarray(q),
                                      fanout, *it))
    tb = tbmat._rank_bpmat(tk, t(tf), t(q), fanout, *it).numpy()
    np.testing.assert_array_equal(jb, tb)
    assert jr.dtype == tr.dtype == jb.dtype == tb.dtype
    np.testing.assert_array_equal(tr, np.searchsorted(tk.numpy(), q, "left"))


def test_guards():
    assert ops.locate_fusable(ops.MAX_F32_POSITIONS, 64)
    assert not ops.locate_fusable(ops.MAX_F32_POSITIONS + 1, 64)
    assert not ops.locate_fusable(1024, 1)
    assert ops.native_kernels("cuda") and not ops.native_kernels("cpu")
    assert set(ops.launch_counts()) == {"fused_locate", "bmat_rank",
                                        "gmm_estep", "tile_search",
                                        "spline_lookup", "ragged_dot",
                                        "ragged_dot_wgrad", "window_insert",
                                        "spline_corridor"}


# ---------------------------------------------------------------------------
# K3: the GMM E-step
# ---------------------------------------------------------------------------


def _gmm_inputs(n, k):
    """The sweep of ``tests/test_kernels.py``: samples around the means,
    some far out, in float32."""
    r = np.random.default_rng(n * k)
    x = r.normal(0, 5, n).astype(np.float32)
    w = np.full(k, 1.0 / k, np.float32)
    mu = np.linspace(-4, 4, k).astype(np.float32)
    sd = r.uniform(0.5, 2.0, k).astype(np.float32)
    return x, w, mu, sd


@pytest.mark.parametrize("n", [100, 2048, 5000])
@pytest.mark.parametrize("k", [2, 4, 8])
def test_gmm_estep_plain_matches_pallas(n, k):
    x, w, mu, sd = _gmm_inputs(n, k)
    pad = -n % GMM_N_BLK
    ref = np.asarray(gmm_estep_pallas(
        jnp.asarray(np.concatenate([x, np.zeros(pad, np.float32)])),
        jnp.asarray(w), jnp.asarray(mu), jnp.asarray(sd), interpret=True,
    ))[:n]
    t = torch.as_tensor
    got = gmm_estep_plain(t(x), t(w), t(mu), t(sd)).numpy()
    assert got.dtype == np.float32 and got.shape == (n, k)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-5)
    # the wrapper and the adapter (float64 in) take the plain version here
    np.testing.assert_array_equal(gmm_estep(t(x), t(w), t(mu), t(sd)).numpy(),
                                  got)
    via_ops = ops.gmm_estep(t(x.astype(np.float64)), t(w.astype(np.float64)),
                            t(mu), t(sd)).numpy()
    np.testing.assert_array_equal(via_ops, got)


@pytest.mark.parametrize("k", [1, 3, 5, 6, 7, 16, 33])
def test_gmm_estep_plain_matches_pallas_any_k(k):
    """Component counts that are not a power of two (and K = 1), where the
    CUDA kernel masks lanes of its per-sample group, a group of 16 lanes,
    and K = 33, where a warp takes a sample, at N = 1 and 31."""
    for n in (1, 31):
        x, w, mu, sd = _gmm_inputs(n, k)
        pad = -n % GMM_N_BLK
        ref = np.asarray(gmm_estep_pallas(
            jnp.asarray(np.concatenate([x, np.zeros(pad, np.float32)])),
            jnp.asarray(w), jnp.asarray(mu), jnp.asarray(sd), interpret=True,
        ))[:n]
        t = torch.as_tensor
        got = gmm_estep_plain(t(x), t(w), t(mu), t(sd)).numpy()
        assert got.shape == (n, k)
        np.testing.assert_allclose(got, ref, atol=1e-5)
        np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-5)


# ---------------------------------------------------------------------------
# on the card: the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("interp64", [False, True])
def test_fused_locate_cuda_matches_plain(cuda, interp64):
    domains = ("small", "big", "mid")
    f = _flat_index(domains)
    q, sid = _queries(f["keys"], domains, seed=9)
    j0, s0 = _torch_locate(fused_locate_plain, f, q, sid, device=cuda,
                           interp64=interp64)
    before = fused_locate.launches
    j1, s1 = _torch_locate(fused_locate, f, q, sid, device=cuda,
                           interp64=interp64)
    torch.cuda.synchronize()
    assert fused_locate.launches == before + 1
    np.testing.assert_array_equal(j1, j0)
    np.testing.assert_array_equal(s1, s0)


@pytest.mark.gpu
def test_bmat_rank_cuda_matches_plain(cuda):
    keys, fences = _bmat_arrays(3, 2048, 16, seed=5)
    r = np.random.default_rng(5)
    sid = torch.as_tensor(r.integers(0, 3, 3000), device=cuda)
    q = torch.as_tensor(r.integers(0, 1 << 48, 3000), device=cuda)
    k = torch.as_tensor(keys.reshape(-1), device=cuda)
    fe = torch.as_tensor(fences.reshape(-1), device=cuda)
    kw = dict(cap=2048, nf=fences.shape[1], fanout=16)
    got = bmat_rank(k, fe, q, sid, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, bmat_rank_plain(k, fe, q, sid, **kw))


def _k2_case(n_shards, nf, fanout, seed):
    """Stacked BMATs with ``nf`` fences each (nf = 1: one node and the
    fence array [KEY_MAX]; odd nf: a partial last node): sorted keys with
    duplicates and KEY_MAX padding, and a pool of queries (random, 0,
    below the smallest key, the fences, the keys, KEY_MAX - 1, KEY_MAX)
    in random order, with a shard id each."""
    r = np.random.default_rng(seed)
    cap = fanout if nf == 1 else (nf - 1) * fanout - (nf % 2) * (fanout // 2)
    keys = np.full((n_shards, cap), KEY_MAX, np.int64)
    for s in range(n_shards):
        m = max(1, cap - cap // 5 - s)
        keys[s, :m] = np.sort(r.integers(1000, 1000 + 3 * m, m))  # dups
    fences = np.concatenate(
        [keys[:, ::fanout], np.full((n_shards, 1), KEY_MAX, np.int64)], axis=1)
    if nf == 1:
        fences = fences[:, 1:]
    assert fences.shape[1] == nf
    live = keys[keys != KEY_MAX]
    pool = np.concatenate([
        r.integers(0, 1000 + 4 * cap, 4000), [0, 999, KEY_MAX, KEY_MAX - 1],
        fences.reshape(-1), r.choice(live, 200), live.min(keepdims=True) - 1,
    ]).astype(np.int64)
    pool = r.permutation(pool)
    sid = r.integers(0, n_shards, len(pool)).astype(np.int64)
    return keys, fences, pool, sid


@pytest.mark.gpu
@pytest.mark.parametrize("fanout", [2, 8, 16, 64, 128, 256, 1024])
@pytest.mark.parametrize("nf", [1, 17, 32, 33, 2500])
def test_bmat_rank_cuda_equals_plain_across_shapes(cuda, fanout, nf):
    """K2's 32-ary fence search and node search (one ballot up to fanout
    64, a 32-ary count above) against the plain bisect, exactly: fence
    counts of 1, below 32, 32, 33 and 2500 (not a power of 32), 1 and 4
    stacked shards with and without shard ids, batches of 1, 31 and 4097
    queries."""
    for n_shards in (1, 4):
        keys, fences, pool, sid = _k2_case(n_shards, nf, fanout,
                                           seed=nf * fanout + n_shards)
        cap = keys.shape[1]
        k = torch.as_tensor(keys.reshape(-1), device=cuda)
        fe = torch.as_tensor(fences.reshape(-1), device=cuda)
        kw = dict(cap=cap, nf=nf, fanout=fanout)
        for n in (1, 31, 4097):
            q = torch.as_tensor(np.resize(pool, n), device=cuda)
            for s in (None, torch.as_tensor(np.resize(sid, n), device=cuda)):
                before = bmat_rank.launches
                got = bmat_rank(k, fe, q, s, **kw)
                torch.cuda.synchronize()
                assert bmat_rank.launches == before + 1
                want = bmat_rank_plain(k, fe, q, s, **kw)
                assert torch.equal(got, want), (n_shards, n, s is None)
                ss = np.zeros(n, np.int64) if s is None else s.cpu().numpy()
                gold = [np.searchsorted(keys[a], b, "left")
                        for a, b in zip(ss, q.cpu().numpy())]
                np.testing.assert_array_equal(got.cpu().numpy(), gold)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [100, 2048, 5000, 8192])
@pytest.mark.parametrize("k", [2, 4, 8])
def test_gmm_estep_cuda_matches_plain(cuda, n, k):
    args = [torch.as_tensor(a, device=cuda) for a in _gmm_inputs(n, k)]
    want = gmm_estep_plain(*args)
    before = gmm_estep.launches
    got = gmm_estep(*args)
    torch.cuda.synchronize()
    assert gmm_estep.launches == before + 1
    assert float((got - want).abs().max()) <= 1e-5
    assert float((got.sum(1) - 1).abs().max()) <= 1e-5
    with pytest.raises(ValueError):  # no component at all
        gmm_estep(args[0], *(a[:0] for a in args[1:]))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [*range(1, 9), 9, 16, 17, 32, 33, 64, 100])
def test_gmm_estep_cuda_any_k_and_ragged_n(cuda, k):
    """K 1..32 on lane groups of next_pow2(K) (lanes c >= K masked), and
    K above 32 on a warp per sample, at N = 1, 31, 2048 and 8193 (a ragged
    last warp and CTA): within 1e-5 of the plain version, rows summing to
    1 within 1e-5."""
    for n in (1, 31, 2048, 8193):
        args = [torch.as_tensor(a, device=cuda) for a in _gmm_inputs(n, k)]
        before = gmm_estep.launches
        got = gmm_estep(*args)
        torch.cuda.synchronize()
        assert gmm_estep.launches == before + 1
        assert got.shape == (n, k)
        want = gmm_estep_plain(*args)
        assert float((got - want).abs().max()) <= 1e-5, n
        assert float((got.sum(1) - 1).abs().max()) <= 1e-5, n
