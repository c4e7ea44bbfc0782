"""The port's MLA attention (``repro_torch.models.attention.mla``) and the
MLA decode path against the JAX package, on the CPU (and on the card where
marked).

The weights are the JAX package's own ``init_params`` of the smoke
``deepseek-v2-236b``, whose leaves are bfloat16 as the config stores them,
carried to the port through ``params_from_numpy`` bit for bit; inputs come
from numpy seeds. At float32 compute the port matches within ``F32_TOL``
(1e-4, as ``tests/test_torch_models.py``: float32 sums in other orders);
at bfloat16 within 0.15 with greedy picks equal up to bf16 ties.

Two things of the reference are pinned: MLA divides the float32 scores by
``sqrt(qd)`` taken in float32, not GQA's scale rounded to the compute
dtype; and its mask, a weakly typed float64 array under x64, leaves the
softmax in float32 (``ROADMAP.md`` queue 3).
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401 — x64, as in the full system
import jax
import jax.numpy as jnp
import repro.models.attention as jattn
from repro.configs import smoke_config as jsmoke
from repro.models import decode_step as jdecode
from repro.models import forward_lm as jforward
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro_torch.configs import smoke_config
from repro_torch.models import (
    DecodeCache,
    MLACache,
    compute_params,
    decode_step,
    forward_lm,
    init_cache,
    mla,
    params_from_numpy,
)
from repro_torch.models import attention as tattn
from tests.test_torch_models import (
    BF16_AGREE,
    DTYPES,
    _close,
    _np,
    _same_greedy,
)

ARCH = "deepseek-v2-236b"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def weights():
    """(JAX params, port params) from the JAX package's init (bfloat16)."""
    jp = jinit_params(jsmoke(ARCH), 0)
    npp = jax.tree_util.tree_map(np.asarray, jp)
    return jp, params_from_numpy(npp, device="cpu")


def _cfgs(dtype, **kw):
    return (dataclasses.replace(jsmoke(ARCH), compute_dtype=dtype, **kw),
            dataclasses.replace(smoke_config(ARCH), compute_dtype=dtype,
                                **kw))


def _layer0(weights):
    jp, tp = weights
    return ({k: v[0] for k, v in jp["layers"]["blk0_attn"].items()},
            {k: v[0] for k, v in tp["layers"]["blk0_attn"].items()})


def _x(cfg, dtype, s, seed=40):
    x = np.random.default_rng(seed).normal(0, 1, (1, s, cfg.d_model))
    jdt, tdt = DTYPES[dtype]
    x = x.astype(np.float32)
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _pos(a, b):
    return jnp.arange(a, b, dtype=jnp.int32)[None], torch.arange(a, b)[None]


def test_params_arrive_bit_for_bit(weights):
    jp, tp = weights
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    tl = dict(jax.tree_util.tree_flatten_with_path(tp)[0])
    assert len(jl) == len(tl)
    for path, a in jl:
        t = tl[path]
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape
        assert np.array_equal(t.view(torch.int16).numpy(),
                              np.asarray(a).view(np.int16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_matches_jax(weights, dtype):
    """Layer 0's ``mla`` on 6 tokens without a cache (causal prefill)."""
    jc, tc = _cfgs(dtype)
    jp, tp = _layer0(weights)
    jx, tx = _x(tc, dtype, 6)
    jpos, tpos = _pos(0, 6)
    a, _ = jattn.mla(jx, jp, jc, jpos)
    b, none = mla(tx, tp, tc, tpos)
    assert none is None and b.dtype == tx.dtype
    _close(a, b, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_with_cache_matches_jax(weights, dtype):
    """5 tokens into an empty cache, then 1, then 2 more: the outputs and
    the written latent and rotary key equal the reference's; the port's
    cache keeps its tensors and counts a host length."""
    jc, tc = _cfgs(dtype)
    jp, tp = _layer0(weights)
    jx, tx = _x(tc, dtype, 8)
    m = tc.mla
    jdt, tdt = DTYPES[dtype]
    jcache = jattn.MLACache(jnp.zeros((1, 16, m.kv_lora_rank), jdt),
                            jnp.zeros((1, 16, m.rope_head_dim), jdt),
                            jnp.int32(0))
    tcache = MLACache(torch.zeros(1, 16, m.kv_lora_rank, dtype=tdt),
                      torch.zeros(1, 16, m.rope_head_dim, dtype=tdt), 0)
    ckv = tcache.ckv
    for lo, hi in ((0, 5), (5, 6), (6, 8)):
        jpos, tpos = _pos(lo, hi)
        a, jcache = jattn.mla(jx[:, lo:hi], jp, jc, jpos, jcache)
        b, tcache = mla(tx[:, lo:hi], tp, tc, tpos, tcache)
        _close(a, b, dtype, f"tokens {lo}:{hi}")
        assert tcache.length == int(jcache.length) == hi
        assert tcache.ckv is ckv
        _close(jcache.ckv[:, :hi], tcache.ckv[:, :hi], dtype)
        _close(jcache.krope[:, :hi], tcache.krope[:, :hi], dtype)
    assert not tcache.ckv[:, 8:].any()
    with pytest.raises(ValueError, match="do not fit"):
        mla(tx[:, :1].expand(1, 9, -1), tp, tc, _pos(8, 17)[1], tcache)


def test_chunked_mla_matches_jax(monkeypatch, weights):
    """Above CHUNK_THRESHOLD (lowered on both sides) MLA runs chunked; it
    equals the reference and the unchunked path."""
    monkeypatch.setattr(jattn, "CHUNK_THRESHOLD", 64)
    monkeypatch.setattr(tattn, "CHUNK_THRESHOLD", 64)
    jc, tc = _cfgs("float32")
    jp, tp = _layer0(weights)
    jx, tx = _x(tc, "float32", 128)
    jpos, tpos = _pos(0, 128)
    a, _ = jattn.mla(jx, jp, jc, jpos)
    b, _ = mla(tx, tp, tc, tpos)
    _close(a, b, "float32")
    monkeypatch.setattr(tattn, "CHUNK_THRESHOLD", 1 << 30)
    c, _ = mla(tx, tp, tc, tpos)
    _close(b, c, "float32")


def test_mla_scale_is_float32_not_rounded_to_the_compute_dtype():
    """1/sqrt(qd) in float32 (qd = 192 at full width, 48 in the smoke
    config), where GQA divides by sqrt(dh) rounded to the compute dtype."""
    for qd in (48, 192):
        want = np.float32(1.0) / np.float32(np.sqrt(np.float64(qd)))
        assert tattn._mla_scale(qd) == float(want)
    assert tattn._mla_scale(192) != 1.0 / tattn._scale(192, torch.bfloat16)


def test_reference_mla_softmax_stays_float32(weights):
    """Under x64 the reference's MLA mask is a weakly typed float64 array;
    adding it to the float32 scores keeps them float32, so no exp runs in
    float64. (A strongly typed float64 mask, such as a numpy array handed
    to ``attention_core``, would promote the softmax to float64.)"""
    jc, _ = _cfgs("bfloat16")
    jp, _ = _layer0(weights)
    jx, _ = _x(jc, "bfloat16", 4)
    jpos, _ = _pos(0, 4)
    text = str(jax.make_jaxpr(lambda x: jattn.mla(x, jp, jc, jpos)[0])(jx))
    exps = [ln for ln in text.splitlines() if " exp " in ln]
    assert exps and not any("f64" in ln for ln in exps)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_decode_match_jax(weights, dtype):
    """``forward_lm`` of a (2, 12) batch, then 12 decode steps against the
    JAX ones and against the port's forward (capacity factor 16, as the
    reference's decode-consistency check: no capacity drops)."""
    jc, tc = _cfgs(dtype)
    jp, tp = weights
    toks = np.random.default_rng(41).integers(0, tc.vocab, (2, 12))
    toks = toks.astype(np.int32)
    a = np.asarray(jforward(jp, jc, {"tokens": jnp.asarray(toks)}),
                   np.float32)
    b = forward_lm(tp, tc, {"tokens": torch.from_numpy(
        toks.astype(np.int64))})
    assert b.dtype == DTYPES[dtype][1]
    _close(a, b, dtype)
    if dtype == "bfloat16":
        _same_greedy(a, b)

    cf = dict(moe=dataclasses.replace(tc.moe, capacity_factor=16.0))
    jc, tc = _cfgs(dtype, **cf)
    jstep = jax.jit(lambda p, t, c: jdecode(p, jc, t, c))
    jcache = jinit_cache(jc, 1, 32)
    tcache = init_cache(tc, 1, 32, device="cpu")
    assert tcache.kv == () and jcache.kv == ()
    for key in ("ckv", "krope"):
        assert tcache.mla[key].shape == jcache.mla[key].shape
    js, ts = [], []
    for i in range(12):
        la, jcache = jstep(jp, jnp.asarray(toks[:1, i:i + 1]), jcache)
        lb, tcache = decode_step(tp, tc, torch.from_numpy(
            toks[:1, i:i + 1].astype(np.int64)), tcache)
        js.append(np.asarray(la[:, 0], np.float32))
        ts.append(_np(lb[:, 0]))
    assert tcache.length == int(jcache.mla["len"]) == 12
    js, ts = np.stack(js, 1), np.stack(ts, 1)
    _close(js, ts, dtype, "decode against JAX decode")
    full = _np(forward_lm(tp, tc, {"tokens": torch.from_numpy(
        toks[:1].astype(np.int64))}))
    _close(full, ts, dtype, "decode against forward")
    if dtype == "bfloat16":
        _same_greedy(js, ts)
        assert (full.argmax(-1) == ts.argmax(-1)).mean() >= BF16_AGREE


def test_mla_cache_clone_shares_no_tensor(weights):
    """``DecodeCache.clone`` of an MLA cache copies the latent and the
    rotary key (no stored cache shares a tensor with a live one) and cuts the
    length; decode writes the live cache in place."""
    _, tc = _cfgs("float32")
    _, tp = weights
    cache = init_cache(tc, 1, 8, device="cpu")
    for t in range(3):
        _, cache = decode_step(tp, tc, torch.tensor([[t]]), cache)
    copy = cache.clone(2)
    assert isinstance(copy, DecodeCache) and copy.kv == ()
    assert copy.length == 2 and cache.length == 3
    for key in ("ckv", "krope"):
        assert copy.mla[key].data_ptr() != cache.mla[key].data_ptr()
        assert torch.equal(copy.mla[key], cache.mla[key])
    before = copy.mla["ckv"].clone()
    _, live = decode_step(tp, tc, torch.tensor([[5]]), cache)
    assert live.mla["ckv"] is cache.mla["ckv"]
    assert torch.equal(copy.mla["ckv"], before)
    with pytest.raises(ValueError, match="outside"):
        cache.clone(5)


def test_compute_params_shares_bf16_leaves(weights):
    """deepseek-v2 stores bfloat16 and computes in bfloat16: every leaf
    is shared, the router and norm scales included."""
    _, tp = weights
    cfg = smoke_config(ARCH)
    cp = compute_params(tp, cfg, "cpu")
    for k, v in cp["layers"]["blk0_attn"].items():
        assert v is tp["layers"]["blk0_attn"][k], k


# ------------------------------------------------------------------ the card


@pytest.mark.gpu
def test_mla_decode_on_cuda_matches_cpu(cuda, weights):
    """float32 on the card (TF32 off) against the CPU: forward and 12
    decode steps."""
    assert not torch.backends.cuda.matmul.allow_tf32
    _, tc = _cfgs("float32")
    _, tp = weights
    gp = jax.tree_util.tree_map(lambda t: t.to(cuda), tp)
    toks = np.random.default_rng(42).integers(0, tc.vocab, (1, 12))
    tb = torch.from_numpy(toks)
    _close(forward_lm(tp, tc, {"tokens": tb}),
           forward_lm(gp, tc, {"tokens": tb.to(cuda)}), "float32")
    cc = init_cache(tc, 1, 16, device="cpu")
    gc = init_cache(tc, 1, 16, device=cuda)
    for i in range(12):
        la, cc = decode_step(tp, tc, tb[:, i:i + 1], cc)
        lb, gc = decode_step(gp, tc, tb[:, i:i + 1].to(cuda), gc)
        _close(la, lb, "float32", f"step {i}")
