"""Attention (port of ``repro/models/attention.py``): GQA/MQA/MHA with an
optional bias, local window and softcap, MLA (DeepSeek-V2 latent
attention), with and without a cache, and cross-attention (the whisper
decoder's).

All functions take *flat* projection weights (d_model, n*head_dim), as the
reference does. The arithmetic is the reference's own, op for op, in plain
torch (see ``attention_core``); no library attention kernel replaces it,
because none rounds the scale, the scores and the probabilities where the
reference does. The reference's sharding ``constrain`` hook has no
counterpart on one card.

The caches (``KVCache``, ``MLACache``) differ from the reference in one
way: their ``length`` is a host integer and new entries are written into
the cache's tensors in place (the reference's ``dynamic_update_slice``
returns new arrays). Copying the cache on every token would cost more than
the step at full width. A caller that keeps a cache while another decodes
from the same tensors must clone it (``ServeEngine`` does). A windowed
cache may be a ring (``ring=True`` in ``_gqa``, the reference's
``_attn_block_decode_abs``): its ``length`` counts every token written,
and the token at absolute position p sits in slot p % T.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.models.layers import apply_rope, rope_tables, softcap

NEG_INF = -2.0e38


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, T, Hkv, dh)
    v: torch.Tensor       # (B, T, Hkv, dh)
    length: int           # tokens already in cache (a host integer)


def _causal_mask(s: int, t: int, offset, device=None):
    """(s, t) additive mask; offset = #cached tokens before this chunk."""
    q_pos = torch.arange(s, device=device)[:, None] + offset
    k_pos = torch.arange(t, device=device)[None, :]
    return torch.where(k_pos <= q_pos, 0.0, NEG_INF)


def _local_mask(s: int, t: int, offset, window: int, device=None):
    q_pos = torch.arange(s, device=device)[:, None] + offset
    k_pos = torch.arange(t, device=device)[None, :]
    ok = (k_pos <= q_pos) & (k_pos > q_pos - window)
    return torch.where(ok, 0.0, NEG_INF)


def _scale(dh: int, dtype) -> float:
    """sqrt(dh) rounded to the compute dtype, as the reference divides by
    ``jnp.sqrt(dh).astype(q.dtype)`` (11.3125 in bfloat16 for dh 128)."""
    return torch.tensor(math.sqrt(dh), dtype=torch.float64).to(dtype).item()


def attention_core(q, k, v, mask, logit_cap: float = 0.0):
    """q: (B,S,H,dh), k/v: (B,T,Hkv,dh) with H % Hkv == 0. f32 softmax.
    ``mask`` is an additive float32 (S, T) mask, or None where every key is
    visible to every query (a single decode query over its written cache,
    whose causal mask is all zeros)."""
    b, s, h, dh = q.shape
    hkv = k.shape[2]
    g = h // hkv
    q = q.reshape(b, s, hkv, g, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", q, k) / _scale(dh, q.dtype)
    scores = softcap(scores.float(), logit_cap)
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, dh)


# q-length above which self-attention switches to chunked execution: caps the
# materialized score block at (B, H, CHUNK, T) instead of (B, H, S, T).
CHUNK_THRESHOLD = 8192


def _pick_chunk(n_heads: int, t: int) -> int:
    # smaller chunks for head-replicated archs (H not divisible by the TP
    # degree) whose score tensors cannot shard over heads
    return 64 if (n_heads % 16 or t > 131072) else 512


def chunked_self_attention(q, k, v, *, causal: bool, window: int, cap: float,
                           chunk: int):
    """Exact attention with q processed CHUNK rows at a time: bounds the
    score working set to (B, H, chunk, T); the inner softmax stays full-T
    (exact)."""
    b, s, h, dh = q.shape
    t = k.shape[1]
    nc = s // chunk
    if nc * chunk != s:
        raise ValueError(f"q length {s} is not a multiple of chunk {chunk}")
    k_pos = torch.arange(t, device=q.device)[None, :]
    outs = []
    for ci in range(nc):
        q_pos = ci * chunk + torch.arange(chunk, device=q.device)[:, None]
        if causal:
            ok = k_pos <= q_pos
            if window:
                ok &= k_pos > q_pos - window
        else:
            ok = torch.ones((chunk, t), dtype=torch.bool, device=q.device)
        mask = torch.where(ok, 0.0, NEG_INF)
        outs.append(attention_core(q[:, ci * chunk:(ci + 1) * chunk], k, v,
                                   mask, cap))
    return torch.cat(outs, dim=1)


def _attend_cached(q, k, v, cache: KVCache, window: int, cap: float):
    """Write k/v at ``cache.length`` in place and attend over the written
    prefix. The reference attends over the whole cache and masks the keys
    past ``length + s`` with ``NEG_INF``, whose probabilities are exactly 0;
    the port leaves those keys out."""
    s = q.shape[1]
    start, t = cache.length, cache.k.shape[1]
    n = start + s
    if n > t:
        raise ValueError(f"the cache holds {t} positions; {start} are "
                         f"written and {s} more do not fit")
    cache.k[:, start:n] = k
    cache.v[:, start:n] = v
    if window:
        mask = _local_mask(s, n, start, window, q.device)
    else:
        mask = None if s == 1 else _causal_mask(s, n, start, q.device)
    out = attention_core(q, cache.k[:, :n].to(q.dtype),
                         cache.v[:, :n].to(q.dtype), mask, cap)
    return out, KVCache(cache.k, cache.v, n)


def _ring_mask(t: int, abs_len: int, window: int, device=None):
    """(1, t) additive mask of a ring of t slots for the query at absolute
    position ``abs_len``, already written at slot ``abs_len % t``: slot i
    holds the position p with p % t == i, p <= abs_len, and is visible
    when 0 <= p and p > abs_len - window (``NEG_INF``, the reference's
    literal -2.0e38, elsewhere)."""
    slot = torch.arange(t, device=device)
    cycle = (abs_len // t) * t
    abs_pos = torch.where(slot <= abs_len % t, cycle + slot, cycle - t + slot)
    ok = (abs_pos >= 0) & (abs_pos <= abs_len) & (abs_pos > abs_len - window)
    return torch.where(ok, 0.0, NEG_INF)[None, :]


def _attend_ring(q, k, v, cache: KVCache, window: int, cap: float):
    """One token into a ring of T = ``cache.k.shape[1]`` slots, written in
    place at ``cache.length % T``, attending over every slot masked by
    absolute position (``_ring_mask``); past T tokens the ring wraps. The
    reference masks every row of a multi-token step at the first token's
    position and clamps a write that runs past the ring's end, so more
    than one token a step raises here."""
    s = q.shape[1]
    if s != 1:
        raise ValueError(f"a windowed ring cache takes one token a step, "
                         f"got {s}")
    n = cache.length
    t = cache.k.shape[1]
    cache.k[:, n % t] = k[:, 0]
    cache.v[:, n % t] = v[:, 0]
    out = attention_core(q, cache.k.to(q.dtype), cache.v.to(q.dtype),
                         _ring_mask(t, n, window, q.device), cap)
    return out, KVCache(cache.k, cache.v, n + 1)


def _gqa(x, p, cfg, tables, cache: Optional[KVCache] = None,
         window: int = 0, causal: bool = True, ring: bool = False):
    """``gqa`` with the RoPE tables already computed (one per forward);
    ``ring`` makes a windowed cache a ring (``_attend_ring``)."""
    b, s, d = x.shape
    dh = cfg.head_dim
    cd = x.dtype
    q = torch.matmul(x, p["wq"].to(cd))
    k = torch.matmul(x, p["wk"].to(cd))
    v = torch.matmul(x, p["wv"].to(cd))
    if cfg.qkv_bias:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    q = apply_rope(q.reshape(b, s, cfg.n_heads_eff, dh), tables)
    k = apply_rope(k.reshape(b, s, cfg.n_kv_heads, dh), tables)
    v = v.reshape(b, s, cfg.n_kv_heads, dh)

    if cache is None:
        if s >= CHUNK_THRESHOLD:
            out = chunked_self_attention(
                q, k, v, causal=causal, window=window,
                cap=cfg.attn_logit_softcap,
                chunk=_pick_chunk(cfg.n_heads_eff, s),
            )
        else:
            if causal:
                mask = (
                    _local_mask(s, s, 0, window, x.device)
                    if window
                    else _causal_mask(s, s, 0, x.device)
                )
            else:
                mask = torch.zeros((s, s), device=x.device)
            out = attention_core(q, k, v, mask, cfg.attn_logit_softcap)
        new_cache = None
    elif ring:
        out, new_cache = _attend_ring(q, k, v, cache, window,
                                      cfg.attn_logit_softcap)
    else:
        out, new_cache = _attend_cached(q, k, v, cache, window,
                                        cfg.attn_logit_softcap)

    out = out.reshape(b, s, cfg.n_heads_eff * dh)
    return torch.matmul(out, p["wo"].to(cd)), new_cache


def gqa(x, p, cfg, positions, cache: Optional[KVCache] = None,
        window: int = 0, causal: bool = True):
    """Standard attention path. ``p`` holds wq/wk/wv/wo (+ optional biases).
    With a cache, x is the new chunk (decode: S=1) written at cache.length
    (in place). Returns (out, new_cache)."""
    tables = rope_tables(positions, cfg.head_dim, cfg.rope_theta,
                         cfg.rope_frac, x.dtype)
    return _gqa(x, p, cfg, tables, cache, window, causal)


class MLACache(NamedTuple):
    ckv: torch.Tensor     # (B, T, kv_lora) compressed latent
    krope: torch.Tensor   # (B, T, rope_dim) shared rotary key
    length: int           # tokens already in cache (a host integer)


def mla_tables(cfg, positions, dtype):
    """MLA's RoPE tables: over ``rope_head_dim``, all of it rotated (the
    reference's ``rope`` at its default ``rope_frac`` of 1)."""
    return rope_tables(positions, cfg.mla.rope_head_dim, cfg.rope_theta,
                       1.0, dtype)


def _mla_scale(qd: int) -> float:
    """1 / sqrt(qd) as the reference takes it: the square root in float32,
    its reciprocal in float32 (a float32 value, exact as a Python float)."""
    return (1.0 / torch.tensor(float(qd)).sqrt()).item()


def _mla(x, p, cfg, tables, cache: Optional[MLACache] = None):
    """``mla`` with the RoPE tables already computed (one per forward)."""
    m = cfg.mla
    b, s, d = x.shape
    cd = x.dtype
    h = cfg.n_heads
    qd = m.nope_head_dim + m.rope_head_dim

    if m.q_lora_rank:
        q = torch.matmul(torch.matmul(x, p["wq_a"].to(cd)), p["wq_b"].to(cd))
    else:
        q = torch.matmul(x, p["wq"].to(cd))
    q = q.reshape(b, s, h, qd)
    q_nope, q_rope = q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]
    q_rope = apply_rope(q_rope, tables)

    kv_a = torch.matmul(x, p["wkv_a"].to(cd))
    ckv, k_rope_in = kv_a[..., :m.kv_lora_rank], kv_a[..., m.kv_lora_rank:]
    k_rope = apply_rope(k_rope_in[:, :, None, :], tables)[:, :, 0, :]

    if cache is not None:
        # write at cache.length in place; attend over the written prefix
        # (the reference masks the rest with NEG_INF: probability exactly 0)
        start = cache.length
        n = start + s
        if n > cache.ckv.shape[1]:
            raise ValueError(f"the cache holds {cache.ckv.shape[1]} "
                             f"positions; {start} are written and {s} more "
                             f"do not fit")
        cache.ckv[:, start:n] = ckv
        cache.krope[:, start:n] = k_rope
        ckv, k_rope = cache.ckv[:, :n], cache.krope[:, :n]
        new_cache = MLACache(cache.ckv, cache.krope, n)
        offset = start
    else:
        new_cache = None
        offset = 0

    t = ckv.shape[1]
    # reconstruct per-head K_nope and V from the latent
    kv = torch.matmul(ckv.to(cd), p["wkv_b"].to(cd))
    kv = kv.reshape(b, t, h, m.nope_head_dim + m.v_head_dim)
    k_nope, v = kv[..., :m.nope_head_dim], kv[..., m.nope_head_dim:]
    k_rope = k_rope.to(cd)
    scale = _mla_scale(qd)

    def mla_core(qn, qr, offset_rows: int):
        """qn/qr: (b, sc, h, d) chunk; offset_rows: absolute first q row.
        The scores are summed in the compute dtype, then scaled in
        float32 (not GQA's scale rounded to the compute dtype)."""
        sc = qn.shape[1]
        s_nope = torch.einsum("bshd,bthd->bhst", qn, k_nope)
        s_rope = torch.einsum("bshd,btd->bhst", qr, k_rope)
        scores = (s_nope + s_rope).float() * scale
        if sc > 1 or offset_rows + sc < t:  # else every key is visible
            scores = scores + _causal_mask(sc, t, offset_rows, x.device)
        probs = torch.softmax(scores, dim=-1).to(cd)
        return torch.einsum("bhst,bthd->bshd", probs, v)

    if cache is None and s >= CHUNK_THRESHOLD:
        chunk = _pick_chunk(h, t)
        if s % chunk:
            raise ValueError(f"q length {s} is not a multiple of chunk "
                             f"{chunk}")
        out = torch.cat([mla_core(q_nope[:, c:c + chunk],
                                  q_rope[:, c:c + chunk], c)
                         for c in range(0, s, chunk)], dim=1)
    else:
        out = mla_core(q_nope, q_rope, offset)
    out = out.reshape(b, s, h * m.v_head_dim)
    return torch.matmul(out, p["wo"].to(cd)), new_cache


def mla(x, p, cfg, positions, cache: Optional[MLACache] = None):
    """Multi-head Latent Attention (DeepSeek-V2): KV compressed to a shared
    latent c_kv (kv_lora_rank) + a single shared RoPE key; per-head K/V are
    reconstructed from the latent. The cache stores only (c_kv, k_rope).
    With a cache, x is the new chunk written at cache.length (in place).
    Returns (out, new_cache)."""
    return _mla(x, p, cfg, mla_tables(cfg, positions, x.dtype), cache)


def cross_attention(x, enc_kv, p, cfg):
    """Whisper decoder cross-attn; enc_kv = (k, v) precomputed from the
    encoder, (B, T, Hkv, dh) each. Nothing is masked: every one of the T
    slots is attended, written or not."""
    b, s, d = x.shape
    dh = cfg.head_dim
    cd = x.dtype
    q = torch.matmul(x, p["wq_x"].to(cd)).reshape(b, s, cfg.n_heads, dh)
    k, v = enc_kv
    out = attention_core(q, k.to(cd), v.to(cd), None)
    out = out.reshape(b, s, cfg.n_heads * dh)
    return torch.matmul(out, p["wo_x"].to(cd))
