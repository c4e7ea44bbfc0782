"""Model forward passes (port of ``repro/models/transformer.py``): the
causal LM over every block pattern (attention blocks with GQA or MLA and
a SwiGLU MLP or an MoE layer; RG-LRU ``rec`` blocks beside local-window
attention; RWKV-6 blocks) and the encoder-decoder (whisper), with their
decode paths over KV, MLA latent, ring, recurrent and cross-attention
caches.

Entry points:
  forward_lm(params, cfg, batch)            -> logits (train/prefill)
  loss_fn(params, cfg, batch)               -> scalar CE loss
  init_cache(cfg, batch_size, max_len)      -> stacked decode cache
  abstract_cache(cfg, batch_size, max_len)  -> the same on the meta device
  decode_step(params, cfg, tokens, cache)   -> logits, cache
  compute_params(params, cfg)               -> the weights as the forward
                                               reads them (cast once)

The reference's layer scan becomes a Python loop over the stacked leaves.
Its ``jax.checkpoint`` of a layer group (``cfg.remat == "block"``)
becomes ``torch.utils.checkpoint`` of the same group, taken only where
autograd records (so serving under ``inference_mode`` runs as before);
recomputing a group changes no arithmetic.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.ops import resolve_device
from repro_torch.models.attention import (
    KVCache,
    MLACache,
    _gqa,
    _mla,
    cross_attention,
    mla_tables,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.init import block_pattern
from repro_torch.models.layers import rms_norm, rope_tables, swiglu
from repro_torch.models.moe import moe_layer
from repro_torch.models.recurrent import (
    RGLRUState,
    RWKVState,
    rglru_block_seq,
    rglru_block_step,
    rwkv_channelmix,
    rwkv_timemix_seq,
)

# the leaves the reference does not cast to the compute dtype at use:
# rms_norm reads its scale in float32, the MoE router casts its weight to
# float32 (a bfloat16 copy of a float32 router would route otherwise), and
# RWKV's bonus ``u`` is read in float32
_KEEP_STORED = ("ln1", "ln2", "ln_x", "final_norm", "enc_norm", "router",
                "u")

# the frames of a whisper cache's cross-attention K/V (its 30 s window)
ENC_FRAMES = 1500


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _attn_block(x, p, cfg, tables, cache=None, window=0):
    """With a cache and a window, the cache is a ring (the reference's
    ``_attn_block_decode_abs``)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.mla is not None:
        a, new_cache = _mla(h, p, cfg, tables, cache)
    else:
        a, new_cache = _gqa(h, p, cfg, tables, cache, window,
                            ring=cache is not None and window > 0)
    x = x + a
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.moe is not None:
        f = moe_layer(h, p, cfg)
    else:
        f = swiglu(h, p["w1"], p["w3"], p["w2"], x.dtype)
    return x + f, new_cache


def _rec_block(x, p, cfg, state=None):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if state is None:
        r = rglru_block_seq(h, p, cfg)
        new_state = None
    else:
        r, new_state = rglru_block_step(h[:, 0, :], p, cfg, state)
        r = r[:, None, :]
    x = x + r.to(x.dtype)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    f = swiglu(h, p["w1"], p["w3"], p["w2"], x.dtype)
    return x + f, new_state


def _rwkv_block(x, p, cfg, state=None):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    att, s_fin, x_last_att = rwkv_timemix_seq(h, p, cfg, state)
    x = x + att
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    prev_c = (state.x_prev_ffn if state is not None else
              torch.zeros((x.shape[0], x.shape[2]), dtype=x.dtype,
                          device=x.device))
    ffn, x_last_ffn = rwkv_channelmix(h2, prev_c, p, x.dtype)
    x = x + ffn
    return x, RWKVState(s=s_fin, x_prev_att=x_last_att,
                        x_prev_ffn=x_last_ffn)


def _tables(cfg, positions, dtype):
    """The step's RoPE tables: MLA's over its rope dims, else GQA's; None
    for an attention-free model."""
    if "attn" not in block_pattern(cfg):
        return None
    if cfg.mla is not None:
        return mla_tables(cfg, positions, dtype)
    return rope_tables(positions, cfg.head_dim, cfg.rope_theta,
                       cfg.rope_frac, dtype)


def _window(cfg) -> int:
    """The attention blocks' local window (0: none)."""
    return cfg.rglru.attn_window if cfg.rglru is not None else 0


def _unstack(stacked):
    """Per-layer parameter dicts: views of a dict of stacked leaves."""
    names = list(stacked)
    return [dict(zip(names, leaves))
            for leaves in zip(*(stacked[k].unbind(0) for k in names))]


def _groups(params, cfg):
    """Per layer group, its blocks as (kind, parameter dict) in pattern
    order: group g's ``blk{i}_{kind}`` leaves."""
    pattern = block_pattern(cfg)
    blocks = [_unstack(params["layers"][f"blk{i}_{kind}"])
              for i, kind in enumerate(pattern)]
    return [list(zip(pattern, group)) for group in zip(*blocks)]


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------


def _embed_inputs(params, cfg, batch):
    cd = getattr(torch, cfg.compute_dtype)
    x = params["embed"][batch["tokens"]].to(cd)
    if cfg.vlm is not None and "image_embeds" in batch:
        img = torch.matmul(batch["image_embeds"].to(cd),
                           params["img_proj"].to(cd))
        x = torch.cat([img, x], dim=1)
    return x


def _logits(params, cfg, x):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.matmul(x, head.to(x.dtype))


# ---------------------------------------------------------------------------
# decoder-only LM
# ---------------------------------------------------------------------------


def compute_params(params, cfg: ModelConfig, device=None):
    """The parameter tree as the forward reads it, on ``device`` (``cuda``
    unless the caller passes another): every leaf in ``cfg.compute_dtype``
    except those in ``_KEEP_STORED``, which stay as stored. The reference
    casts the same leaves at each use; casting them once gives the same
    values and spares a decode step from reading the stored (float32)
    weights. A leaf already in its dtype on ``device`` is kept, not
    copied."""
    device = resolve_device(device)
    cd = getattr(torch, cfg.compute_dtype)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else
                v.to(device=device,
                     dtype=v.dtype if k in _KEEP_STORED else cd)
                for k, v in tree.items()}

    return walk(params)


def _remat(fn, remat: bool, cfg: ModelConfig):
    """``fn`` as the reference's ``jax.checkpoint`` would wrap it: where
    ``remat`` and ``cfg.remat == "block"`` ask for it and autograd is
    recording, its activations are recomputed in backward instead of
    kept (only its inputs are saved)."""
    if not (remat and cfg.remat == "block" and torch.is_grad_enabled()):
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def _group_fn(cfg, tables):
    """One layer group's blocks over x, the reference's ``group_fn``."""

    def group_fn(x, group):
        for kind, p in group:
            if kind == "attn":
                x, _ = _attn_block(x, p, cfg, tables, window=_window(cfg))
            elif kind == "rec":
                x, _ = _rec_block(x, p, cfg)
            else:
                x, _ = _rwkv_block(x, p, cfg)
        return x

    return group_fn


def forward_lm(params, cfg: ModelConfig, batch, remat=True):
    """Logits (B, S, V) of a batch {"tokens": (B, S)} (plus "image_embeds"
    (B, P, d) for a VLM, prepended to the sequence; for the
    encoder-decoder {"enc_frames": (B, T, d), "dec_tokens": (B, S)}).
    With ``remat`` and ``cfg.remat == "block"``, each layer group (each
    encoder and decoder layer of the encoder-decoder) is checkpointed
    where a gradient is being recorded."""
    if cfg.encdec is not None:
        return _forward_encdec(params, cfg, batch, remat)
    x = _embed_inputs(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    group_fn = _remat(_group_fn(cfg, _tables(cfg, positions, x.dtype)),
                      remat, cfg)
    for group in _groups(params, cfg):
        x = group_fn(x, group)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, x)


def loss_fn(params, cfg: ModelConfig, batch, remat=True):
    """Mean next-token cross-entropy (the reference's ``loss_fn``): the
    log-softmax in float32; a VLM's image prefix is unsupervised (only the
    last ``tokens`` positions predict), and the encoder-decoder's targets
    are ``dec_tokens[:, 1:]``."""
    logits = forward_lm(params, cfg, batch, remat)
    if cfg.encdec is not None:
        targets = batch["dec_tokens"][:, 1:]
    else:
        s_txt = batch["tokens"].shape[1]
        logits = logits[:, -s_txt:]
        targets = batch["tokens"][:, 1:]
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    return nll.mean()


# ---------------------------------------------------------------------------
# encoder-decoder (whisper)
# ---------------------------------------------------------------------------


def _encode(params, cfg, frames, remat=False):
    """The encoder's output (B, T, d) over frame embeddings (B, T, d) from
    the stub front end: bidirectional attention over frames + enc_pos."""
    cd = getattr(torch, cfg.compute_dtype)
    t = frames.shape[1]
    x = frames.to(cd) + params["enc_pos"][:t].to(cd)
    tables = _tables(cfg, torch.arange(t, device=x.device)[None, :], cd)

    def enc_fn(x, p):
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        a, _ = _gqa(h, p, cfg, tables, causal=False)
        x = x + a
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + swiglu(h, p["w1"], p["w3"], p["w2"], cd)

    enc_fn = _remat(enc_fn, remat, cfg)
    for p in _unstack(params["enc_layers"]):
        x = enc_fn(x, p)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _cross_kv(p, cfg, enc_out):
    """One decoder layer's cross-attention K and V, (B, T, Hkv, dh)."""
    b, t = enc_out.shape[:2]
    cd = enc_out.dtype
    k = torch.matmul(enc_out, p["wk_x"].to(cd))
    v = torch.matmul(enc_out, p["wv_x"].to(cd))
    return (k.reshape(b, t, cfg.n_kv_heads, cfg.head_dim),
            v.reshape(b, t, cfg.n_kv_heads, cfg.head_dim))


def _encoder_kv(params, cfg, frames):
    """A cache's ``enc_kv`` for these frames: every decoder layer's cross
    K/V over the encoder's output, {"k", "v"} of (L_dec, B, T, Hkv, dh).
    (The reference fills ``enc_kv`` nowhere; decode equals the forward
    where T is ``ENC_FRAMES``, since cross-attention masks no slot.)"""
    enc_out = _encode(params, cfg, frames)
    kv = [_cross_kv(p, cfg, enc_out) for p in _unstack(params["dec_layers"])]
    return {"k": torch.stack([k for k, _ in kv]),
            "v": torch.stack([v for _, v in kv])}


def _dec_block(y, p, cfg, tables, enc_kv, cache=None):
    h = rms_norm(y, p["ln1"], cfg.norm_eps)
    a, new_cache = _gqa(h, p, cfg, tables, cache)
    y = y + a
    h = rms_norm(y, p["ln_x"], cfg.norm_eps)
    y = y + cross_attention(h, enc_kv, p, cfg)
    h = rms_norm(y, p["ln2"], cfg.norm_eps)
    return y + swiglu(h, p["w1"], p["w3"], p["w2"], y.dtype), new_cache


def _forward_encdec(params, cfg, batch, remat=False):
    cd = getattr(torch, cfg.compute_dtype)
    enc_out = _encode(params, cfg, batch["enc_frames"], remat)
    y = params["embed"][batch["dec_tokens"]].to(cd)
    positions = torch.arange(y.shape[1], device=y.device)[None, :]
    tables = _tables(cfg, positions, cd)

    def dec_fn(y, p, enc_out):
        return _dec_block(y, p, cfg, tables, _cross_kv(p, cfg, enc_out))[0]

    dec_fn = _remat(dec_fn, remat, cfg)
    for p in _unstack(params["dec_layers"]):
        y = dec_fn(y, p, enc_out)
    y = rms_norm(y, params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, y)


# ---------------------------------------------------------------------------
# decode (serve) path
# ---------------------------------------------------------------------------


class DecodeCache(NamedTuple):
    """The decode cache, with the reference's fields, each stacked over
    layer groups and the blocks of its kind in a group; a kind the model
    lacks is ():
    - ``kv``: GQA's "k" and "v", (groups, n_attn, B, T, Hkv, dh), T =
      min(max_len, window) for a windowed (ring) cache; for the
      encoder-decoder (L_dec, B, T, Hkv, dh);
    - ``mla``: "ckv" (groups, n_attn, B, T, kv_lora) and "krope"
      (groups, n_attn, B, T, rope_dim);
    - ``rec``: the RG-LRU's "h" (groups, n_rec, B, d_rnn), float32, and
      "conv" (groups, n_rec, B, conv_width - 1, d_rnn);
    - ``rwkv``: "s" (groups, n_rwkv, B, H, dh, dh), float32, and "att",
      "ffn" (groups, n_rwkv, B, d);
    - ``enc_kv``: the whisper decoder's cross K/V, "k" and "v"
      (L_dec, B, 1500, Hkv, dh).
    "len", the tokens written, is a host integer in ``kv``, ``mla`` and
    ``rwkv`` (where the reference has none, and starts positions at 0).
    ``decode_step`` writes into the tensors in place."""

    kv: Any = ()
    mla: Any = ()
    rec: Any = ()
    rwkv: Any = ()
    enc_kv: Any = ()

    @property
    def length(self) -> int:
        """Tokens written."""
        return next(f["len"] for f in (self.kv, self.mla, self.rwkv) if f)

    @property
    def cuttable(self) -> bool:
        """Whether the cache can be cut back to an earlier prefix: not
        with a recurrent state, nor with a ring that has wrapped."""
        if self.rec or self.rwkv:
            return False
        return not self.kv or self.kv["len"] <= self.kv["k"].shape[-3]

    def clone(self, length=None) -> "DecodeCache":
        """A cache whose tensors no other cache shares, holding this one's
        first ``length`` positions (all written ones by default). A cache
        that is not ``cuttable`` can only be cloned whole."""
        n = self.length if length is None else int(length)
        if not 0 <= n <= self.length:
            raise ValueError(f"length {n} outside [0, {self.length}]")
        if n != self.length and not self.cuttable:
            raise ValueError(
                f"a recurrent state or a wrapped ring cannot be cut back "
                f"to {n} of its {self.length} tokens")

        def copy(field):
            if not field:
                return ()
            out = {k: v.clone() for k, v in field.items() if k != "len"}
            return {**out, "len": n} if "len" in field else out

        return DecodeCache(*(copy(f) for f in self))


def init_cache(cfg: ModelConfig, batch: int, max_len: int, cache_dtype=None,
               *, device=None):
    """Zeros cache on ``device`` (``cuda`` unless the caller passes
    another), with the reference's shapes and dtypes."""
    device = resolve_device(device)
    cd = getattr(torch, cache_dtype or cfg.compute_dtype)

    def zeros(shape, dtype=cd):
        return torch.zeros(shape, dtype=dtype, device=device)

    heads = (cfg.n_kv_heads, cfg.head_dim)
    if cfg.encdec is not None:
        ld = cfg.encdec.n_dec_layers
        return DecodeCache(
            kv={"k": zeros((ld, batch, max_len) + heads),
                "v": zeros((ld, batch, max_len) + heads), "len": 0},
            enc_kv={"k": zeros((ld, batch, ENC_FRAMES) + heads),
                    "v": zeros((ld, batch, ENC_FRAMES) + heads)})

    pattern = block_pattern(cfg)
    groups = cfg.n_layers // len(pattern)
    n_attn, n_rec, n_rwkv = (pattern.count(k) for k in ("attn", "rec",
                                                       "rwkv"))
    out = {}
    if cfg.mla is not None and n_attn:
        m = cfg.mla
        lead = (groups, n_attn, batch, max_len)
        out["mla"] = {"ckv": zeros(lead + (m.kv_lora_rank,)),
                      "krope": zeros(lead + (m.rope_head_dim,)), "len": 0}
    elif n_attn:
        window = _window(cfg)
        t = min(max_len, window) if window else max_len
        shape = (groups, n_attn, batch, t) + heads
        out["kv"] = {"k": zeros(shape), "v": zeros(shape), "len": 0}
    if n_rec:
        r = cfg.rglru
        n = r.d_rnn or cfg.d_model
        out["rec"] = {
            "h": zeros((groups, n_rec, batch, n), torch.float32),
            "conv": zeros((groups, n_rec, batch, r.conv_width - 1, n)),
        }
    if n_rwkv:
        dh = cfg.rwkv.head_dim
        h = cfg.d_model // dh
        lead = (groups, n_rwkv, batch)
        out["rwkv"] = {"s": zeros(lead + (h, dh, dh), torch.float32),
                       "att": zeros(lead + (cfg.d_model,)),
                       "ffn": zeros(lead + (cfg.d_model,)), "len": 0}
    return DecodeCache(**out)


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int,
                   cache_dtype=None):
    """``init_cache``'s tree on the meta device: every tensor with its
    shape and dtype and no memory (the reference's ShapeDtypeStruct cache).
    "len" stays the host integer 0."""
    return init_cache(cfg, batch, max_len, cache_dtype, device="meta")


def _write(state, new):
    """Copy a block's new recurrent state into its cache slices."""
    for old, value in zip(state, new):
        old.copy_(value)


def decode_step(params, cfg: ModelConfig, tokens, cache: DecodeCache):
    """One decode step: tokens (B, S) -> logits (B, S, V) and the cache
    with S more tokens. S = 1 when decoding; a model with RG-LRU blocks
    and a ring takes only S = 1 (ValueError otherwise: the reference's
    step reads the first token alone). The new entries are written into
    the cache's tensors in place (see ``DecodeCache``); a windowed ring
    wraps past its T slots. For whisper, ``tokens`` are decoder tokens
    and ``cache.enc_kv`` holds the cross K/V (zeros unless the caller
    filled it)."""
    cd = getattr(torch, cfg.compute_dtype)
    x = params["embed"][tokens].to(cd)
    if cfg.encdec is not None:
        return _decode_encdec(params, cfg, x, cache)
    length = cache.length
    s = tokens.shape[1]
    if s != 1 and cfg.rglru is not None:
        raise ValueError(f"{cfg.name} decodes one token a step (RG-LRU "
                         f"state and windowed ring), got {s}")
    positions = torch.arange(length, length + s, device=x.device)[None, :]
    tables = _tables(cfg, positions, cd)
    for g, group in enumerate(_groups(params, cfg)):
        seen = {"attn": 0, "rec": 0, "rwkv": 0}
        for kind, p in group:
            i = seen[kind]
            seen[kind] += 1
            if kind == "attn":
                if cfg.mla is not None:
                    c = MLACache(cache.mla["ckv"][g, i],
                                 cache.mla["krope"][g, i], length)
                else:
                    c = KVCache(cache.kv["k"][g, i], cache.kv["v"][g, i],
                                length)
                x, _ = _attn_block(x, p, cfg, tables, c, _window(cfg))
            elif kind == "rec":
                st = RGLRUState(cache.rec["h"][g, i], cache.rec["conv"][g, i])
                x, new = _rec_block(x, p, cfg, st)
                _write(st, new)
            else:
                st = RWKVState(cache.rwkv["s"][g, i], cache.rwkv["att"][g, i],
                               cache.rwkv["ffn"][g, i])
                x, new = _rwkv_block(x, p, cfg, st)
                _write(st, new)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    counted = {f: {**getattr(cache, f), "len": length + s}
               for f in ("kv", "mla", "rwkv") if getattr(cache, f)}
    return _logits(params, cfg, x), cache._replace(**counted)


def _decode_encdec(params, cfg, x, cache: DecodeCache):
    length = cache.length
    s = x.shape[1]
    positions = torch.arange(length, length + s, device=x.device)[None, :]
    tables = _tables(cfg, positions, x.dtype)
    ks, vs = cache.kv["k"], cache.kv["v"]
    for i, p in enumerate(_unstack(params["dec_layers"])):
        x, _ = _dec_block(x, p, cfg, tables,
                          (cache.enc_kv["k"][i], cache.enc_kv["v"][i]),
                          KVCache(ks[i], vs[i], length))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (_logits(params, cfg, x),
            cache._replace(kv={**cache.kv, "len": length + s}))
