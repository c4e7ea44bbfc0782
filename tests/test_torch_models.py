"""The port's LM substrate (``repro_torch.models``, ``repro_torch.configs``)
against the JAX package, on the CPU.

Both packages compute with the same weights: a numpy tree from a seed
(``numpy_params``, with nonzero norm scales and biases), as JAX arrays and
through ``params_from_numpy``. Inputs come from numpy seeds too.
At float32 compute the port matches within ``F32_TOL`` (absolute and
relative): the two frameworks sum the same products in other orders, which
moves float32 results by a few ulps, about 1e-6 at these sizes. At
bfloat16 compute the bound is the reference's own for decode against
forward (``tests/test_models_smoke.py``): 0.15, with greedy (argmax)
agreement on at least 90% of positions between the port's decode and its
forward; across the frameworks, greedy picks agree up to bf16 ties
(``_same_greedy``). ``recurrentgemma-2b`` runs 80 tokens (past its smoke
window of 64, so the local mask binds and the decode ring wraps); there
the bfloat16 bound is ``BF16_LONG_TOL``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401 — x64, as in the full system
import jax
import jax.numpy as jnp
import repro.models.attention as jattn
import repro.models.layers as jlayers
from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jget, smoke_config as jsmoke
from repro.models import decode_step as jdecode
from repro.models import forward_lm as jforward
from repro.models import init_cache as jinit_cache
from repro.models.init import param_descriptors as jdescriptors
from repro.models.transformer import DecodeCache as JDecodeCache
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.models import (
    compute_params,
    decode_step,
    forward_lm,
    init_cache,
    init_params,
    param_descriptors,
    params_from_numpy,
)
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models.attention import KVCache
from repro_torch.models.transformer import ENC_FRAMES, _encoder_kv

F32_TOL = 1e-4
BF16_TOL = 0.15
BF16_AGREE = 0.9
DENSE = ["deepseek-7b", "phi4-mini-3-8b", "granite-20b", "qwen1-5-110b"]
MOE = ["qwen3-moe-30b-a3b", "deepseek-v2-236b"]
RECURRENT = ["recurrentgemma-2b", "rwkv6-1-6b"]
ENCDEC = ["whisper-small"]
ALL = DENSE + ["llava-next-34b"] + MOE + RECURRENT + ENCDEC
# bfloat16 over recurrentgemma's 80 tokens: the reference's own decode and
# forward differ by up to 0.198 on these inputs (allclose at 0.15 fails by
# 0.037; its own test decodes 12 tokens), so the port is held to 0.25
# against both, and to the reference's 0.15 everywhere else
BF16_LONG_TOL = 0.25
# tokens of the forward and decode checks: past recurrentgemma's window
SEQ = {"recurrentgemma-2b": 80}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread keeps the parallel test workers
    from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(a, b, dtype, what="", bf16_tol=BF16_TOL):
    tol = F32_TOL if dtype == "float32" else bf16_tol
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol,
                               err_msg=what)


def _bf16_tol(arch):
    return BF16_LONG_TOL if arch in SEQ else BF16_TOL


def _same_greedy(a, b, tol=BF16_TOL):
    """bfloat16 logits of the two frameworks pick the same greedy tokens up
    to ties: where the picks differ, each side's pick scores within
    ``BF16_TOL`` of the other side's top logit. (Counting agreement would
    not do here: bf16 logits tie exactly or within one step at a few
    positions, and XLA, which fuses the bf16 ops and, under x64, takes
    the softmax in float64, breaks those ties otherwise than torch.)"""
    a, b = _np(a).reshape(-1, a.shape[-1]), _np(b).reshape(-1, b.shape[-1])
    rows = np.arange(len(a))
    for x, y in ((a, b), (b, a)):
        pick = x.argmax(-1)
        assert (y[rows, pick] >= y.max(-1) - tol).all()


def _close_routed(a, b, what=""):
    """bfloat16 logits of an MoE model across the frameworks. A router
    pick that is a near tie flips under a one-ulp difference of its input
    (the frameworks round bf16 chains at other places), and the token then
    takes another expert's output: its logits move by about 1 (1.5 in the
    smoke deepseek-v2's step 8). So at least ``BF16_AGREE`` of the
    positions are held within ``BF16_TOL``, and their greedy picks are
    held equal up to ties (``_same_greedy``)."""
    a, b = _np(a), _np(b)
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    ok = (np.abs(a - b) <= BF16_TOL * (1 + np.abs(b))).all(-1)
    assert ok.mean() >= BF16_AGREE, (what, ok.mean())
    _same_greedy(a[ok], b[ok])


def _pair(x, dtype):
    """The same numpy array as a JAX and a torch array of ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _cfgs(arch, dtype):
    return (dataclasses.replace(jsmoke(arch), compute_dtype=dtype),
            dataclasses.replace(smoke_config(arch), compute_dtype=dtype))


def numpy_params(cfg, seed=0):
    """A parameter tree of ``cfg`` as nested dicts of float32 numpy arrays:
    fan-in scaled normals, and small normals for the 1-D leaves (norm
    scales and biases, which ``init_params`` leaves at zero)."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(tree[k]) for k in sorted(tree)}
        if len(tree.shape) == 1:
            return rng.normal(0, 0.1, tree.shape).astype(np.float32)
        w = rng.normal(0, 1, tree.shape) / np.sqrt(tree.shape[-2])
        return w.astype(np.float32)

    return walk(param_descriptors(cfg))


_PARAMS = {}


def _params(arch):
    """The same weights for the smoke config in both packages."""
    if arch not in _PARAMS:
        npp = numpy_params(smoke_config(arch))
        _PARAMS[arch] = (jax.tree_util.tree_map(jnp.asarray, npp),
                         params_from_numpy(npp, device="cpu"))
    return _PARAMS[arch]


def _layer0(jp, tp):
    pick = lambda tree: {k: v[0] for k, v in  # noqa: E731
                         tree["layers"]["blk0_attn"].items()}
    return pick(jp), pick(tp)


def _batch(cfg, seed, b=2, s=12, frames=24):
    """Tokens and the batch in both packages; for the encoder-decoder the
    tokens are "dec_tokens" beside ``frames`` frame embeddings."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks)}
    tb = {"tokens": torch.from_numpy(toks.astype(np.int64))}
    if cfg.vlm is not None:
        img = rng.normal(0, 1, (b, cfg.vlm.n_image_tokens, cfg.d_model))
        jb["image_embeds"] = jnp.asarray(img, jnp.float32)
        tb["image_embeds"] = torch.from_numpy(img.astype(np.float32))
    if cfg.encdec is not None:
        enc = rng.normal(0, 1, (b, frames, cfg.d_model)).astype(np.float32)
        jb = {"enc_frames": jnp.asarray(enc), "dec_tokens": jb["tokens"]}
        tb = {"enc_frames": torch.from_numpy(enc),
              "dec_tokens": tb["tokens"]}
    return toks, jb, tb


def _jax_encoder_kv(jp, jc, frames):
    """The reference's encoder and per-layer cross K/V
    (``_forward_encdec``'s lines), as ``DecodeCache.enc_kv``: the JAX
    package has no function that fills it."""
    cd = jnp.dtype(jc.compute_dtype)
    t = frames.shape[1]
    x = frames.astype(cd) + jp["enc_pos"][:t].astype(cd)[None]
    pos = jnp.arange(t, dtype=jnp.int32)[None, :]

    def enc_fn(x, p):
        h = jlayers.rms_norm(x, p["ln1"], jc.norm_eps)
        a, _ = jattn.gqa(h, p, jc, pos, None, 0, causal=False)
        x = x + a
        h = jlayers.rms_norm(x, p["ln2"], jc.norm_eps)
        return x + jlayers.swiglu(h, p["w1"], p["w3"], p["w2"], cd), None

    x, _ = jax.lax.scan(enc_fn, x, jp["enc_layers"])
    enc = jlayers.rms_norm(x, jp["enc_norm"], jc.norm_eps)
    b, heads = frames.shape[0], (jc.n_kv_heads, jc.head_dim)
    dec = jp["dec_layers"]
    k = jnp.einsum("btd,ldn->lbtn", enc, dec["wk_x"].astype(cd))
    v = jnp.einsum("btd,ldn->lbtn", enc, dec["wv_x"].astype(cd))
    return {"k": k.reshape(k.shape[:3] + heads),
            "v": v.reshape(v.shape[:3] + heads)}


# ------------------------------------------------------------------ layers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fn", ["rms_norm", "layer_norm", "swiglu",
                                "gelu_mlp", "gelu_mlp_nobias"])
def test_layer_matches_jax(fn, dtype):
    rng = np.random.default_rng(10)
    x = rng.normal(0, 1, (2, 5, 48)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    scale = rng.normal(0, 0.5, 48).astype(np.float32)
    bias = rng.normal(0, 0.5, 48).astype(np.float32)
    w1 = rng.normal(0, 0.2, (48, 64)).astype(np.float32)
    w3 = rng.normal(0, 0.2, (48, 64)).astype(np.float32)
    w2 = rng.normal(0, 0.2, (64, 48)).astype(np.float32)
    b1 = rng.normal(0, 0.2, 64).astype(np.float32)
    f32 = lambda a: (jnp.asarray(a), torch.from_numpy(a))  # noqa: E731
    (js, ts), (jb, tb) = f32(scale), f32(bias)
    (j1, t1), (j3, t3), (j2, t2), (jb1, tb1) = map(f32, (w1, w3, w2, b1))
    jdt, tdt = DTYPES[dtype]
    if fn == "rms_norm":
        a, b = jlayers.rms_norm(jx, js, 1e-6), tlayers.rms_norm(tx, ts, 1e-6)
    elif fn == "layer_norm":
        a = jlayers.layer_norm(jx, js, jb)
        b = tlayers.layer_norm(tx, ts, tb)
    elif fn == "swiglu":
        a = jlayers.swiglu(jx, j1, j3, j2, jdt)
        b = tlayers.swiglu(tx, t1, t3, t2, tdt)
    elif fn == "gelu_mlp":
        a = jlayers.gelu_mlp(jx, j1, jb1, j2, jb, jdt)
        b = tlayers.gelu_mlp(tx, t1, tb1, t2, tb, tdt)
    else:
        a = jlayers.gelu_mlp(jx, j1, None, j2, None, jdt)
        b = tlayers.gelu_mlp(tx, t1, None, t2, None, tdt)
    assert b.dtype == tdt
    _close(a, b, dtype, fn)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rope_frac", [1.0, 0.75])
def test_rope_matches_jax(rope_frac, dtype):
    rng = np.random.default_rng(11)
    x = rng.normal(0, 1, (2, 7, 3, 32)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    pos = np.arange(5, 12, dtype=np.int32)[None, :]
    a = jlayers.rope(jx, jnp.asarray(pos), 10000.0, rope_frac)
    b = tlayers.rope(tx, torch.from_numpy(pos.astype(np.int64)), 10000.0,
                     rope_frac)
    _close(a, b, dtype)
    # only the leading rot = int(dh * frac) dims (rounded to even) rotate
    rot = int(32 * rope_frac)
    assert torch.equal(b[..., rot:], tx[..., rot:])


@pytest.mark.parametrize("cap", [0.0, 5.0])
def test_softcap_matches_jax(cap):
    x = np.random.default_rng(12).normal(0, 10, (4, 33)).astype(np.float32)
    a = jlayers.softcap(jnp.asarray(x), cap)
    b = tlayers.softcap(torch.from_numpy(x), cap)
    _close(a, b, "float32")


# --------------------------------------------------------------- attention


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cap", [0.0, 30.0])
@pytest.mark.parametrize("hkv", [4, 2, 1])
def test_attention_core_matches_jax(hkv, cap, dtype):
    rng = np.random.default_rng(13)
    q = rng.normal(0, 1, (2, 6, 4, 32)).astype(np.float32)
    k = rng.normal(0, 1, (2, 9, hkv, 32)).astype(np.float32)
    v = rng.normal(0, 1, (2, 9, hkv, 32)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    jm = jattn._causal_mask(6, 9, 3)
    tm = tattn._causal_mask(6, 9, 3)
    # under x64 the reference's mask is float64; the port's is float32
    np.testing.assert_array_equal(np.asarray(jm, np.float32), tm.numpy())
    a = jattn.attention_core(jq, jk, jv, jm, cap)
    b = tattn.attention_core(tq, tk, tv, tm, cap)
    _close(a, b, dtype)
    np.testing.assert_array_equal(
        np.asarray(jattn._local_mask(6, 9, 3, 4), np.float32),
        tattn._local_mask(6, 9, 3, 4).numpy())


def test_attention_scale_rounds_to_the_compute_dtype():
    """The reference divides bf16 scores by sqrt(dh) rounded to bf16."""
    assert tattn._scale(128, torch.bfloat16) == 11.3125
    assert tattn._scale(128, torch.float32) == float(np.float32(128 ** 0.5))


@pytest.mark.parametrize("cached", [False, True], ids=["prefill", "cache"])
@pytest.mark.parametrize("arch", DENSE)
def test_gqa_matches_jax(arch, cached):
    """gqa of layer 0 on the same input, without a cache (causal prefill)
    and with one (5 tokens into an empty cache, then 1 more)."""
    jc, tc = _cfgs(arch, "float32")
    jp, tp = _layer0(*_params(arch))
    rng = np.random.default_rng(14)
    x = rng.normal(0, 1, (1, 6, jc.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    pos = lambda a, b: (  # noqa: E731
        jnp.arange(a, b, dtype=jnp.int32)[None], torch.arange(a, b)[None])
    if not cached:
        jpos, tpos = pos(0, 6)
        a, _ = jattn.gqa(jx, jp, jc, jpos)
        b, none = tattn.gqa(tx, tp, tc, tpos)
        assert none is None
        _close(a, b, "float32")
        return
    shape = (1, 16, jc.n_kv_heads, jc.head_dim)
    jcache = jattn.KVCache(jnp.zeros(shape, jnp.float32),
                           jnp.zeros(shape, jnp.float32), jnp.int32(0))
    tcache = KVCache(torch.zeros(shape), torch.zeros(shape), 0)
    for lo, hi in ((0, 5), (5, 6)):
        jpos, tpos = pos(lo, hi)
        a, jcache = jattn.gqa(jx[:, lo:hi], jp, jc, jpos, jcache)
        b, tcache = tattn.gqa(tx[:, lo:hi], tp, tc, tpos, tcache)
        _close(a, b, "float32", f"tokens {lo}:{hi}")
        assert tcache.length == int(jcache.length) == hi
        _close(jcache.k[:, :hi], tcache.k[:, :hi], "float32")
        _close(jcache.v[:, :hi], tcache.v[:, :hi], "float32")


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24),
                                           (False, 0)])
def test_chunked_self_attention_matches_jax(monkeypatch, causal, window):
    """Above CHUNK_THRESHOLD (lowered on both sides) gqa runs chunked."""
    monkeypatch.setattr(jattn, "CHUNK_THRESHOLD", 64)
    monkeypatch.setattr(tattn, "CHUNK_THRESHOLD", 64)
    jc, tc = _cfgs("deepseek-7b", "float32")
    jp, tp = _layer0(*_params("deepseek-7b"))
    x = np.random.default_rng(15).normal(0, 1, (1, 128, jc.d_model))
    x = x.astype(np.float32)
    jpos = jnp.arange(128, dtype=jnp.int32)[None]
    a, _ = jattn.gqa(jnp.asarray(x), jp, jc, jpos, None, window,
                     causal=causal)
    b, _ = tattn.gqa(torch.from_numpy(x), tp, tc, torch.arange(128)[None],
                     None, window, causal=causal)
    _close(a, b, "float32")
    # and the chunked path equals the unchunked one
    monkeypatch.setattr(tattn, "CHUNK_THRESHOLD", 1 << 30)
    c, _ = tattn.gqa(torch.from_numpy(x), tp, tc, torch.arange(128)[None],
                     None, window, causal=causal)
    _close(b, c, "float32")


# ------------------------------------------------------- forward and decode


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ALL)
def test_forward_lm_matches_jax(arch, dtype):
    jc, tc = _cfgs(arch, dtype)
    jp, tp = _params(arch)
    s = SEQ.get(arch, 12)
    toks, jb, tb = _batch(jc, 16, s=s)
    a = np.asarray(jforward(jp, jc, jb), np.float32)
    b = forward_lm(tp, tc, tb)
    extra = jc.vlm.n_image_tokens if jc.vlm is not None else 0
    assert b.shape == (2, s + extra, jc.vocab)
    assert b.dtype == DTYPES[dtype][1]
    if dtype == "bfloat16" and jc.moe is not None:
        _close_routed(a, b)
        return
    _close(a, b, dtype, bf16_tol=_bf16_tol(arch))
    if dtype == "bfloat16":
        _same_greedy(a, b, _bf16_tol(arch))


def _no_drops(cfg):
    """An MoE config at capacity factor 16, as the reference's
    decode-consistency check sets it: capacity drops differ between a
    teacher-forced forward and per-token decode, so none may happen."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=16.0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ALL)
def test_decode_matches_jax_and_forward(arch, dtype):
    """12 decode steps (80 for recurrentgemma, into max_len 128: its ring
    of t = 64 slots wraps) against the JAX ones, and against the port's
    own teacher-forced forward (the reference's decode-consistency check).
    Whisper decodes over ``ENC_FRAMES`` frames with ``enc_kv`` built by
    each package's encoder, so its forward over the same frames is the
    decode's (cross-attention masks no slot)."""
    jc, tc = map(_no_drops, _cfgs(arch, dtype))
    jp, tp = _params(arch)
    s = SEQ.get(arch, 12)
    max_len = 128 if arch in SEQ else 32
    toks, jb, tb = _batch(jc, 17, b=1, s=s, frames=ENC_FRAMES)
    jstep = jax.jit(lambda p, t, c: jdecode(p, jc, t, c))
    jcache = jinit_cache(jc, 1, max_len)
    tcache = init_cache(tc, 1, max_len, device="cpu")
    if jc.encdec is not None:
        jcache = jcache._replace(enc_kv=_jax_encoder_kv(
            jp, jc, jb["enc_frames"]))
        tcache = tcache._replace(enc_kv=_encoder_kv(tp, tc,
                                                    tb["enc_frames"]))
        _close(jcache.enc_kv["k"], tcache.enc_kv["k"], dtype, "enc_kv")
    js, ts = [], []
    for i in range(s):
        la, jcache = jstep(jp, jnp.asarray(toks[:, i:i + 1]), jcache)
        lb, tcache = decode_step(
            tp, tc, torch.from_numpy(toks[:, i:i + 1].astype(np.int64)),
            tcache)
        js.append(np.asarray(la[:, 0], np.float32))
        ts.append(_np(lb[:, 0]))
    assert tcache.length == s
    if jcache.kv != ():
        assert int(jcache.kv["len"]) == s
    js, ts = np.stack(js, 1), np.stack(ts, 1)
    tol = _bf16_tol(arch)
    if dtype == "bfloat16" and jc.moe is not None:
        _close_routed(js, ts, "decode against JAX decode")
    else:
        _close(js, ts, dtype, "decode against JAX decode", tol)
    if jc.vlm is not None:  # decode takes no image prefix
        tb = {"tokens": tb["tokens"]}
    full = _np(forward_lm(tp, tc, tb))
    _close(full, ts, dtype, "decode against forward", tol)
    if dtype == "bfloat16":
        if jc.moe is None:
            _same_greedy(js, ts, tol)
        agree = (full.argmax(-1) == ts.argmax(-1)).mean()
        assert agree >= BF16_AGREE, agree  # the reference's own bound


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_cache_matches_jax(arch):
    """Every field of ``init_cache`` has the reference's leaves, shapes and
    dtypes (the port adds a host "len" to ``rwkv``), all zeros."""
    jc, tc = _cfgs(arch, "bfloat16")
    jcache = jinit_cache(jc, 2, 24)
    tcache = init_cache(tc, 2, 24, device="cpu")
    assert tcache._fields == JDecodeCache._fields
    for name, jf, tf in zip(jcache._fields, jcache, tcache):
        assert (jf == ()) == (tf == ()), name
        if jf == ():
            continue
        assert set(tf) - {"len"} == set(jf) - {"len"}, name
        assert ("len" in tf) == ("len" in jf or name == "rwkv"), name
        for k, v in jf.items():
            if k == "len":
                continue
            assert tuple(tf[k].shape) == v.shape, (name, k)
            assert str(tf[k].dtype).split(".")[-1] == str(v.dtype), (name, k)
            assert not tf[k].any(), (name, k)
        if "len" in tf:
            assert tf["len"] == 0


def test_decode_writes_the_cache_in_place():
    """The step returns the same K/V tensors, one position further; the
    positions before it are unchanged (what ``ServeEngine`` relies on)."""
    _, tc = _cfgs("deepseek-7b", "float32")
    _, tp = _params("deepseek-7b")
    cache = init_cache(tc, 1, 16, device="cpu")
    tok = torch.tensor([[3]])
    _, c1 = decode_step(tp, tc, tok, cache)
    before = c1.kv["k"].clone()
    _, c2 = decode_step(tp, tc, tok + 1, c1)
    assert c2.kv["k"] is cache.kv["k"] and c2.kv["len"] == 2
    assert torch.equal(c2.kv["k"][:, :, :, :1], before[:, :, :, :1])
    assert not torch.equal(c2.kv["k"][:, :, :, 1], before[:, :, :, 1])
    copy = c2.clone(1)
    assert copy.kv["len"] == 1 and copy.kv["k"] is not c2.kv["k"]
    with pytest.raises(ValueError, match="outside"):
        c2.clone(3)


def test_decode_raises_when_the_cache_is_full():
    _, tc = _cfgs("deepseek-7b", "float32")
    _, tp = _params("deepseek-7b")
    cache = init_cache(tc, 1, 2, device="cpu")
    for t in range(2):
        _, cache = decode_step(tp, tc, torch.tensor([[t]]), cache)
    with pytest.raises(ValueError, match="do not fit"):
        decode_step(tp, tc, torch.tensor([[2]]), cache)


# ----------------------------------------------------- configs and params


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_match_jax(arch):
    assert ARCH_IDS == JAX_ARCH_IDS
    for jget_, tget in ((jget, get_config), (jsmoke, smoke_config)):
        j, t = jget_(arch), tget(arch)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert j.n_params() == t.n_params()
        assert j.n_active_params() == t.n_active_params()
        assert (j.n_heads_eff, j.attn_free, j.subquadratic) == (
            t.n_heads_eff, t.attn_free, t.subquadratic)


def test_uplif_paper_config_matches_jax():
    import repro.configs.uplif_paper as jpaper
    import repro_torch.configs.uplif_paper as tpaper

    assert dataclasses.asdict(jpaper.INDEX) == dataclasses.asdict(
        tpaper.INDEX)
    assert dataclasses.asdict(jpaper.AGENT) == dataclasses.asdict(
        tpaper.AGENT)
    assert (jpaper.DATASETS, jpaper.INIT_KEYS) == (tpaper.DATASETS,
                                                  tpaper.INIT_KEYS)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_params_follows_the_descriptors(arch):
    """Every family's tree has the JAX tree's paths, shapes and dtypes;
    1-D leaves and leaves whose last dim is 1 are zeros, the rest fan-in
    scaled normals; the same seed gives the same tree."""
    cfg = smoke_config(arch)
    flat = lambda tree: dict(  # noqa: E731
        (jax.tree_util.keystr(p), x) for p, x in
        jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: hasattr(x, "axes"))[0])
    jdesc, tdesc = flat(jdescriptors(jsmoke(arch))), flat(
        param_descriptors(cfg))
    assert {k: (d.shape, d.axes) for k, d in jdesc.items()} == {
        k: (d.shape, d.axes) for k, d in tdesc.items()}
    p = flat(init_params(cfg, 0, device="cpu"))
    again = flat(init_params(cfg, 0, device="cpu"))
    assert p.keys() == tdesc.keys()
    dt = getattr(torch, cfg.param_dtype)
    for k, w in p.items():
        shape = tdesc[k].shape
        assert w.shape == shape and w.dtype == dt, k
        assert torch.equal(w, again[k]), k
        if len(shape) == 1 or shape[-1] == 1:
            assert not w.any(), k
        elif w.numel() >= 4096:
            std = w.float().std().item() * np.sqrt(shape[-2])
            assert 0.9 < std < 1.1, (k, std)
    other = flat(init_params(cfg, 1, device="cpu"))
    assert not torch.equal(other["['embed']"], p["['embed']"])


def test_params_from_numpy_keeps_tree_and_dtypes():
    """A bfloat16 tree (deepseek-v2's param_dtype) converts bit for bit."""
    npp = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16),
        numpy_params(smoke_config("deepseek-v2-236b")))
    tp = params_from_numpy(npp, device="cpu")
    jl = jax.tree_util.tree_flatten_with_path(npp)[0]
    tl = dict(jax.tree_util.tree_flatten_with_path(tp)[0])
    assert len(jl) == len(tl)
    for path, a in jl:
        t = tl[path]
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape
        assert np.array_equal(t.view(torch.int16).numpy(),
                              a.view(np.int16))


def test_compute_params_casts_all_but_the_norm_scales():
    cfg = smoke_config("deepseek-7b")
    _, tp = _params("deepseek-7b")
    cp = compute_params(tp, cfg, "cpu")
    layer = cp["layers"]["blk0_attn"]
    assert cp["final_norm"].dtype == layer["ln1"].dtype == torch.float32
    for k in ("embed", "lm_head"):
        assert torch.equal(cp[k], tp[k].to(torch.bfloat16))
    for k in ("wq", "wk", "wv", "wo", "w1", "w2", "w3"):
        assert layer[k].dtype == torch.bfloat16
    again = compute_params(cp, cfg, "cpu")  # already cast: shared
    assert again["embed"] is cp["embed"]


@pytest.mark.parametrize("arch,stored", [
    ("rwkv6-1-6b", ("ln1", "ln2", "u")),
    ("whisper-small", ("ln1", "ln2", "ln_x")),
    ("recurrentgemma-2b", ("ln1", "ln2")),
])
def test_compute_params_keeps_the_float32_reads(arch, stored):
    """The leaves the reference reads in float32 stay as stored: RWKV's
    bonus ``u`` (cast to float32 at use), the decoder's ``ln_x`` and the
    encoder's ``enc_norm`` (read by ``rms_norm``); every other block leaf
    is cast, the RG-LRU's ``a_param`` and ``w_out`` included."""
    cfg = smoke_config(arch)
    _, tp = _params(arch)
    cp = compute_params(tp, cfg, "cpu")
    blocks = ([cp["dec_layers"], cp["enc_layers"]] if cfg.encdec else
              list(cp["layers"].values()))
    for block in blocks:
        for k, v in block.items():
            want = torch.float32 if k in stored else torch.bfloat16
            assert v.dtype == want, (arch, k, v.dtype)
    if cfg.encdec is not None:
        assert cp["enc_norm"].dtype == torch.float32
        assert torch.equal(cp["enc_norm"], tp["enc_norm"])
        assert cp["enc_pos"].dtype == torch.bfloat16


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = smoke_config("deepseek-7b")
    for call in (lambda: init_params(cfg, 0),
                 lambda: init_cache(cfg, 1, 8),
                 lambda: params_from_numpy({"a": np.zeros(2)})):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


# ------------------------------------------------------------------ the card


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ALL)
def test_forward_and_decode_on_cuda_match_cpu(cuda, arch):
    """float32 on the card (TF32 off, torch's default) against the CPU;
    recurrentgemma over 80 tokens into max_len 16 (its ring wraps), and
    whisper with ``enc_kv`` from each side's encoder."""
    assert not torch.backends.cuda.matmul.allow_tf32
    _, tc = map(_no_drops, _cfgs(arch, "float32"))
    _, tp = _params(arch)
    gp = params_from_numpy(jax.tree_util.tree_map(
        lambda t: t.numpy(), tp), device=cuda)
    s = SEQ.get(arch, 12)
    toks, _, tb = _batch(tc, 18, s=s)
    gb = {k: v.to(cuda) for k, v in tb.items()}
    _close(forward_lm(tp, tc, tb), forward_lm(gp, tc, gb), "float32")
    cc = init_cache(tc, 1, 16, device="cpu")
    gc = init_cache(tc, 1, 16, device=cuda)
    if tc.encdec is not None:
        cc = cc._replace(enc_kv=_encoder_kv(tp, tc, tb["enc_frames"][:1]))
        gc = gc._replace(enc_kv=_encoder_kv(gp, tc, gb["enc_frames"][:1]))
    for i in range(s if arch in SEQ else 12):
        t = torch.from_numpy(toks[:1, i:i + 1].astype(np.int64))
        la, cc = decode_step(tp, tc, t, cc)
        lb, gc = decode_step(gp, tc, t.to(cuda), gc)
        _close(la, lb, "float32", f"step {i}")
