"""The port's recurrent blocks (``repro_torch.models.recurrent``), the
local-window ring and the caches that cannot be cut, against the JAX
package on the CPU.

Weights are the layer-0 blocks of the smoke ``recurrentgemma-2b`` and
``rwkv6-1-6b`` from ``numpy_params`` (``tests/test_torch_models.py``);
inputs come from numpy seeds. Tolerances are that file's: float32 within
``F32_TOL`` (1e-4); bfloat16 within ``BF16_TOL`` (0.15, the reference's
decode-against-forward bound), absolute and relative, with the absolute
part scaled by the reference output's RMS where that exceeds 1
(``_close``): a bfloat16 sum's rounding error grows with its terms, not
its result, and the RWKV time-mix's outputs have an RMS of about 12 here
(its float32 state accumulates unnormalized k·v products). In bfloat16
the two frameworks differ by one or two ulps already in the gates (their
sigmoid, exp and softplus round differently, and XLA keeps fused
bfloat16 chains in float32), so no closer bound holds there; the
associative scan's tree is held exactly on integers instead
(``test_associative_scan_is_the_reference_tree``).
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import repro.core  # noqa: F401 — x64, as in the full system
import jax
import jax.numpy as jnp
import repro.models.recurrent as jrec
from repro.configs import smoke_config as jsmoke
from repro.models import decode_step as jdecode
from repro.models import init_cache as jinit_cache
from repro_torch.configs import smoke_config
from repro_torch.models import decode_step, init_cache, params_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import recurrent as trec
from repro_torch.models.transformer import DecodeCache
from tests.test_torch_models import (
    BF16_TOL,
    DTYPES,
    F32_TOL,
    _np,
    _pair,
    numpy_params,
)

RG = "recurrentgemma-2b"
RWKV = "rwkv6-1-6b"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_BLOCKS = {}


def _block(arch, kind):
    """Layer 0's ``kind`` block of the smoke ``arch`` as float32 numpy."""
    if (arch, kind) not in _BLOCKS:
        npp = numpy_params(smoke_config(arch))
        _BLOCKS[arch, kind] = {k: v[0] for k, v in
                               npp["layers"][f"blk0_{kind}"].items()}
    return _BLOCKS[arch, kind]


def _weights(arch, kind):
    """The block's weights as JAX and torch float32 arrays (each function
    casts them to the compute dtype itself, as in the forward)."""
    npb = _block(arch, kind)
    return ({k: jnp.asarray(v) for k, v in npb.items()},
            {k: torch.from_numpy(v) for k, v in npb.items()})


def _close(a, b, dtype, what=""):
    a, b = _np(a), _np(b)
    if dtype == "float32":
        tol, atol = F32_TOL, F32_TOL
    else:
        tol = BF16_TOL
        atol = tol * max(1.0, float(np.sqrt(np.mean(np.square(a)))))
    np.testing.assert_allclose(b, a, rtol=tol, atol=atol, err_msg=what)


def _x(seed, shape, dtype):
    x = np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)
    return _pair(x, dtype)


# ------------------------------------------------------------------ RG-LRU


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fn", ["gates", "rglru_seq", "rglru_step",
                                "conv1d_seq", "conv1d_step",
                                "rglru_block_seq", "rglru_block_step"])
def test_rglru_matches_jax(fn, dtype):
    """Every RG-LRU function on the same inputs; the step functions with a
    float32 state ``h`` (as the cache holds it) and a conv tail in the
    compute dtype, returning the same dtypes as the reference."""
    jp, tp = _weights(RG, "rec")
    jdt, tdt = DTYPES[dtype]
    n = jp["wx"].shape[1]
    cw = jp["conv_w"].shape[0]
    jw, tw = jp["conv_w"].astype(jdt), tp["conv_w"].to(tdt)
    h0 = np.random.default_rng(31).normal(0, 1, (2, n)).astype(np.float32)
    jh, th = jnp.asarray(h0), torch.from_numpy(h0)
    (jtail, ttail) = _x(32, (2, cw - 1, n), dtype)
    if fn == "gates":
        jx, tx = _x(30, (2, 80, n), dtype)
        a, b = jrec._rglru_gates(jx, jp, jdt), trec._rglru_gates(tx, tp, tdt)
    elif fn == "rglru_seq":
        jx, tx = _x(30, (2, 80, n), dtype)
        a, b = [jrec.rglru_seq(jx, jp)], [trec.rglru_seq(tx, tp)]
    elif fn == "rglru_step":
        jx, tx = _x(30, (2, n), dtype)
        a, b = jrec.rglru_step(jx, jp, jh), trec.rglru_step(tx, tp, th)
    elif fn == "conv1d_seq":
        jx, tx = _x(30, (2, 80, n), dtype)
        a, b = [jrec.conv1d_seq(jx, jw)], [trec.conv1d_seq(tx, tw)]
    elif fn == "conv1d_step":
        jx, tx = _x(30, (2, n), dtype)
        a = jrec.conv1d_step(jx, jw, jtail)
        b = trec.conv1d_step(tx, tw, ttail)
    else:
        cfg = smoke_config(RG)
        if fn == "rglru_block_seq":
            jx, tx = _x(30, (2, 80, cfg.d_model), dtype)
            a = [jrec.rglru_block_seq(jx, jp, cfg)]
            b = [trec.rglru_block_seq(tx, tp, cfg)]
        else:
            jx, tx = _x(30, (2, cfg.d_model), dtype)
            ja, js = jrec.rglru_block_step(jx, jp, cfg,
                                           jrec.RGLRUState(jh, jtail))
            ta, ts = trec.rglru_block_step(tx, tp, cfg,
                                           trec.RGLRUState(th, ttail))
            a, b = (ja, *js), (ta, *ts)
    for i, (u, v) in enumerate(zip(a, b)):
        assert str(v.dtype).split(".")[-1] == str(u.dtype), (i, v.dtype,
                                                             u.dtype)
        assert tuple(v.shape) == u.shape
        _close(u, v, dtype, f"{fn} output {i}")


def test_rglru_step_projects_out_in_float32():
    """Hazard: with a bfloat16 input and the float32 state, ``h * g`` is
    float32 and the reference's out-projection promotes to a float32
    product. The port returns that float32 product exactly (``w_out`` cast
    up, which is exact), not a bfloat16 one; ``_rec_block`` casts."""
    jp, tp = _weights(RG, "rec")
    cfg = smoke_config(RG)
    n = jp["wx"].shape[1]
    (jx, tx) = _x(33, (2, cfg.d_model), "bfloat16")
    h0 = np.random.default_rng(34).normal(0, 1, (2, n)).astype(np.float32)
    (jtail, ttail) = _x(35, (2, 3, n), "bfloat16")
    ja, _ = jrec.rglru_block_step(jx, jp, cfg, jrec.RGLRUState(
        jnp.asarray(h0), jtail))
    st = trec.RGLRUState(torch.from_numpy(h0), ttail)
    ta, _ = trec.rglru_block_step(tx, tp, cfg, st)
    assert ja.dtype == jnp.float32 and ta.dtype == torch.float32
    # the product of the float32 y * g with w_out rounded to bfloat16
    cd = torch.bfloat16
    u = torch.matmul(tx, tp["wx"].to(cd))
    g = trec._gelu(torch.matmul(tx, tp["wg"].to(cd)))
    u, _ = trec.conv1d_step(u, tp["conv_w"].to(cd), ttail)
    y, _ = trec.rglru_step(u, tp, st.h)
    w16 = tp["w_out"].to(cd)
    assert torch.equal(ta, torch.matmul(y * g, w16.float()))
    assert not torch.equal(ta, torch.matmul((y * g).to(cd), w16).float())
    _close(ja, ta, "bfloat16")


def test_gelu_is_the_tanh_approximation():
    """Hazard: ``jax.nn.gelu`` defaults to the tanh approximation, which
    differs from torch's default (erf) gelu by up to about 5e-4."""
    x = np.linspace(-6, 6, 4001).astype(np.float32)
    a = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    b = trec._gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    erf = F.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - a).max() > 1e-4


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 12, 13, 64, 80])
def test_associative_scan_is_the_reference_tree(n):
    """The port's scan combines the same pairs in the same order as
    ``jax.lax.associative_scan``: with a combine that is NOT associative
    (on int64, exact), any other tree gives other values."""
    def fn(c1, c2):
        (a1, b1), (a2, b2) = c1, c2
        return (a1 * 3 + a2) % 1000003, (b1 * 7 + a2 * 5 + b2) % 999983

    rng = np.random.default_rng(36)
    a, b = (rng.integers(0, 1000, (2, n)).astype(np.int64) for _ in "ab")
    ja, jb = jax.lax.associative_scan(fn, (jnp.asarray(a), jnp.asarray(b)),
                                      axis=1)
    ta, tb = trec._associative_scan(
        fn, [torch.from_numpy(a), torch.from_numpy(b)])
    assert np.array_equal(np.asarray(ja), ta.numpy())
    assert np.array_equal(np.asarray(jb), tb.numpy())


def test_rglru_seq_float32_equals_a_sequential_loop():
    """In float32 the tree and a step-by-step recurrence agree to a few
    ulps (the tree only reassociates the products)."""
    _, tp = _weights(RG, "rec")
    _, tx = _x(37, (2, 80, tp["wx"].shape[1]), "float32")
    a, b = trec._rglru_gates(tx, tp, torch.float32)
    h = torch.zeros_like(b[:, 0])
    loop = []
    for t in range(80):
        h = a[:, t] * h + b[:, t]
        loop.append(h)
    np.testing.assert_allclose(trec.rglru_seq(tx, tp).numpy(),
                               torch.stack(loop, 1).numpy(), rtol=1e-5,
                               atol=1e-6)


# ------------------------------------------------------------------ RWKV-6


def _rwkv_state(dtype, b=2, seed=40):
    cfg = smoke_config(RWKV)
    dh = cfg.rwkv.head_dim
    h = cfg.d_model // dh
    rng = np.random.default_rng(seed)
    s = rng.normal(0, 1, (b, h, dh, dh)).astype(np.float32)
    att = rng.normal(0, 1, (b, cfg.d_model)).astype(np.float32)
    ffn = rng.normal(0, 1, (b, cfg.d_model)).astype(np.float32)
    (ja, ta), (jf, tf) = _pair(att, dtype), _pair(ffn, dtype)
    return (jrec.RWKVState(jnp.asarray(s), ja, jf),
            trec.RWKVState(torch.from_numpy(s), ta, tf))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_timemix_proj_matches_jax(dtype):
    jp, tp = _weights(RWKV, "rwkv")
    cfg = smoke_config(RWKV)
    jdt, tdt = DTYPES[dtype]
    jx, tx = _x(41, (2, 12, cfg.d_model), dtype)
    jprev, tprev = _x(42, (2, cfg.d_model), dtype)
    a = jrec._timemix_proj(jx, jprev, jp, jdt)
    b = trec._timemix_proj(tx, tprev, tp, tdt)
    for i, (u, v) in enumerate(zip(a, b)):
        assert str(v.dtype).split(".")[-1] == str(u.dtype), i
        _close(u, v, dtype, f"output {i}")


@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
@pytest.mark.parametrize("s", [12, 128])
def test_wkv_scan_matches_jax(s, carried):
    """The float32 wkv recurrence at S = 12 (one scan in the reference) and
    128 (its chunked path, two chunks of 64), from a zero or a carried
    state: the outputs and the final state."""
    _, tp = _weights(RWKV, "rwkv")
    cfg = smoke_config(RWKV)
    dh = cfg.rwkv.head_dim
    h = cfg.d_model // dh
    rng = np.random.default_rng(43)
    r, k, v = (rng.normal(0, 0.5, (2, s, h, dh)).astype(np.float32)
               for _ in "rkv")
    w = rng.uniform(0.8, 1.0, (2, s, h, dh)).astype(np.float32)
    s0 = (rng.normal(0, 1, (2, h, dh, dh)) if carried else
          np.zeros((2, h, dh, dh))).astype(np.float32)
    u = _block(RWKV, "rwkv")["u"]
    ja, js = jrec._wkv_scan(*map(jnp.asarray, (r, k, v, w, u, s0)))
    ta, ts = trec._wkv_scan(*map(torch.from_numpy, (r, k, v, w, u, s0)))
    assert ta.shape == (2, s, h, dh) and ts.dtype == torch.float32
    _close(ja, ta, "float32", "outputs")
    _close(js, ts, "float32", "final state")


@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv_timemix_matches_jax(dtype, carried):
    """``rwkv_timemix_seq`` without a state and with a carried one: the
    output, the final wkv state (float32) and the last token."""
    jp, tp = _weights(RWKV, "rwkv")
    cfg = smoke_config(RWKV)
    jx, tx = _x(44, (2, 12, cfg.d_model), dtype)
    jst, tst = _rwkv_state(dtype) if carried else (None, None)
    a = jrec.rwkv_timemix_seq(jx, jp, cfg, jst)
    b = trec.rwkv_timemix_seq(tx, tp, cfg, tst)
    assert b[0].dtype == DTYPES[dtype][1] and b[1].dtype == torch.float32
    for i, (u, v) in enumerate(zip(a, b)):
        _close(u, v, dtype, f"output {i}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv_channelmix_matches_jax(dtype):
    jp, tp = _weights(RWKV, "rwkv")
    cfg = smoke_config(RWKV)
    jdt, tdt = DTYPES[dtype]
    jx, tx = _x(45, (2, 12, cfg.d_model), dtype)
    jprev, tprev = _x(46, (2, cfg.d_model), dtype)
    a = jrec.rwkv_channelmix(jx, jprev, jp, jdt)
    b = trec.rwkv_channelmix(tx, tprev, tp, tdt)
    for i, (u, v) in enumerate(zip(a, b)):
        assert v.dtype == tdt
        _close(u, v, dtype, f"output {i}")


# ---------------------------------------------------- the ring and caches


@pytest.mark.parametrize("t,window", [(8, 64), (8, 5), (16, 16)])
def test_ring_mask_follows_absolute_positions(t, window):
    """Slot i holds the newest position p <= q with p % t == i; it is
    visible where 0 <= p, p > q - window. Across several wraps."""
    for q in range(3 * t + 2):
        mask = tattn._ring_mask(t, q, window)[0]
        for i in range(t):
            p = q - ((q - i) % t)
            ok = p >= 0 and p > q - window
            expect = torch.tensor(0.0 if ok else tattn.NEG_INF)
            assert mask[i] == expect, (q, i)


def test_ring_takes_one_token_a_step():
    """Hazard: the reference masks every row of a multi-token step at the
    first token's position and clamps a write past the ring (and its
    RG-LRU step reads the first token alone), so the second row of a
    two-token step is not a second one-token step's; the port raises, in
    the ring and in ``decode_step``, before writing anything."""
    cfg = smoke_config(RG)
    jc = dataclasses.replace(jsmoke(RG), compute_dtype="float32")
    jp = jax.tree_util.tree_map(jnp.asarray, numpy_params(cfg))
    jcache = jinit_cache(jc, 1, 16)
    both, _ = jdecode(jp, jc, jnp.asarray([[3, 5]], jnp.int32), jcache)
    _, jcache = jdecode(jp, jc, jnp.asarray([[3]], jnp.int32), jcache)
    second, _ = jdecode(jp, jc, jnp.asarray([[5]], jnp.int32), jcache)
    assert float(jnp.abs(both[:, 1] - second[:, 0]).max()) > 0.1
    q = torch.zeros(1, 2, 2, 8)
    k = torch.zeros(1, 2, 1, 8)
    cache = tattn.KVCache(torch.zeros(1, 4, 1, 8), torch.zeros(1, 4, 1, 8), 3)
    with pytest.raises(ValueError, match="one token a step"):
        tattn._attend_ring(q, k, k, cache, 64, 0.0)
    params = params_from_numpy(numpy_params(cfg), device="cpu")
    cache = init_cache(cfg, 1, 16, device="cpu")
    _, cache = decode_step(params, cfg, torch.tensor([[5]]), cache)
    before = cache.clone()
    with pytest.raises(ValueError, match="one token a step"):
        decode_step(params, cfg, torch.tensor([[1, 2]]), cache)
    for f, g in zip(cache, before):
        for key in (f or {}):
            if key != "len":
                assert torch.equal(f[key], g[key]), key


@pytest.mark.parametrize("arch", [RG, RWKV])
def test_recurrent_cache_clones_only_whole(arch):
    """Hazard: a recurrent state cannot be cut back to an earlier prefix,
    so ``clone(start)`` raises unless start is the cache's length; a whole
    clone shares no tensor. The RWKV cache counts its tokens in "len"
    (the reference's has no length; positions start at 0)."""
    cfg = smoke_config(arch)
    params = params_from_numpy(numpy_params(cfg), device="cpu")
    cache = init_cache(cfg, 1, 16, device="cpu")
    for t in range(3):
        _, cache = decode_step(params, cfg, torch.tensor([[t]]), cache)
    assert cache.length == 3 and not cache.cuttable
    with pytest.raises(ValueError, match="cannot be cut"):
        cache.clone(2)
    copy = cache.clone()
    assert copy.length == 3
    for f, g in zip(cache, copy):
        for key in (f or {}):
            if key != "len":
                assert torch.equal(f[key], g[key])
                assert f[key].data_ptr() != g[key].data_ptr()


def test_wrapped_ring_is_not_cuttable():
    """A ring that has wrapped holds no earlier prefix either; before it
    wraps (and any plain KV cache) it can be cut."""
    k = torch.zeros(1, 1, 1, 4, 1, 8)
    ring = DecodeCache(kv={"k": k, "v": k.clone(), "len": 6})
    assert not ring.cuttable
    with pytest.raises(ValueError, match="cannot be cut"):
        ring.clone(5)
    assert ring.clone().length == 6
    assert DecodeCache(kv={"k": k, "v": k, "len": 4}).clone(2).length == 2


def test_rglru_decode_state_dtypes():
    """The cache keeps ``h`` in float32 across steps at bfloat16 compute,
    and the conv tail and the RWKV shifts in the compute dtype."""
    for arch in (RG, RWKV):
        cfg = dataclasses.replace(smoke_config(arch),
                                  compute_dtype="bfloat16")
        params = params_from_numpy(numpy_params(cfg), device="cpu")
        cache = init_cache(cfg, 1, 16, device="cpu")
        for t in range(2):
            _, cache = decode_step(params, cfg, torch.tensor([[t]]), cache)
        if arch == RG:
            assert cache.rec["h"].dtype == torch.float32
            assert cache.rec["conv"].dtype == torch.bfloat16
            assert cache.rec["h"].abs().sum() > 0
        else:
            assert cache.rwkv["s"].dtype == torch.float32
            assert cache.rwkv["att"].dtype == torch.bfloat16
            assert _np(cache.rwkv["s"]).any()
