"""Model forward passes (port of ``repro/models/transformer.py``) for the
dense, VLM and MoE families: the causal LM over ``block_pattern ==
("attn",)`` with GQA or MLA attention and a SwiGLU MLP or an MoE layer, and
its decode path with a KV or MLA latent cache.

Entry points:
  forward_lm(params, cfg, batch)            -> logits (prefill)
  init_cache(cfg, batch_size, max_len)      -> stacked decode cache
  decode_step(params, cfg, tokens, cache)   -> logits, cache
  compute_params(params, cfg)               -> the weights as the forward
                                               reads them (cast once)

The reference's layer scan becomes a Python loop over the stacked leaves.
The recurrent (RG-LRU, RWKV-6) blocks with the local-window ring buffer,
and the encoder-decoder raise ``NotImplementedError``: they come with
later slices (``ROADMAP.md`` queue 1), and nothing here falls back to
another computation for them. ``loss_fn`` comes with the training slice.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.kernels.ops import resolve_device
from repro_torch.models.attention import (
    KVCache,
    MLACache,
    _gqa,
    _mla,
    mla_tables,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.init import block_pattern
from repro_torch.models.layers import rms_norm, rope_tables, swiglu
from repro_torch.models.moe import moe_layer

# the leaves the reference does not cast to the compute dtype at use:
# rms_norm reads its scale in float32, and the MoE router casts its weight
# to float32 (a bfloat16 copy of a float32 router would route otherwise)
_KEEP_STORED = ("ln1", "ln2", "final_norm", "router")


def _require_ported(cfg: ModelConfig) -> None:
    """Raise for every family whose blocks this slice does not port."""
    missing = []
    if cfg.rglru is not None:
        missing.append("the RG-LRU 'rec' blocks and the local attention "
                       "window (cfg.rglru)")
    if cfg.rwkv is not None:
        missing.append("the RWKV-6 'rwkv' blocks (cfg.rwkv)")
    if cfg.encdec is not None:
        missing.append("the encoder-decoder (cfg.encdec)")
    if missing:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}): {', '.join(missing)} not ported "
            f"yet; ROADMAP.md queue 1 lists them in order")


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _attn_block(x, p, cfg, tables, cache=None):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.mla is not None:
        a, new_cache = _mla(h, p, cfg, tables, cache)
    else:
        a, new_cache = _gqa(h, p, cfg, tables, cache)
    x = x + a
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.moe is not None:
        f = moe_layer(h, p, cfg)
    else:
        f = swiglu(h, p["w1"], p["w3"], p["w2"], x.dtype)
    return x + f, new_cache


def _tables(cfg, positions, dtype):
    """The step's RoPE tables: MLA's over its rope dims, else GQA's."""
    if cfg.mla is not None:
        return mla_tables(cfg, positions, dtype)
    return rope_tables(positions, cfg.head_dim, cfg.rope_theta,
                       cfg.rope_frac, dtype)


def _layers(params, cfg):
    """Per-layer parameter dicts: views of the stacked leaves."""
    (kind,) = block_pattern(cfg)
    stacked = params["layers"][f"blk0_{kind}"]
    names = list(stacked)
    return [dict(zip(names, leaves))
            for leaves in zip(*(stacked[k].unbind(0) for k in names))]


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
    except the norm scales and the MoE router, which stay as stored. The
    reference casts the same leaves at each use; casting them once gives
    the same values and spares a decode step from reading the stored
    (float32) weights. A leaf already in its dtype on ``device`` is kept,
    not copied."""
    _require_ported(cfg)
    device = resolve_device(device)
    cd = getattr(torch, cfg.compute_dtype)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else
                v.to(device=device,
                     dtype=v.dtype if k in _KEEP_STORED else cd)
                for k, v in tree.items()}

    return walk(params)


def forward_lm(params, cfg: ModelConfig, batch, remat=True):
    """Logits (B, S, V) of a batch {"tokens": (B, S)} (plus "image_embeds"
    (B, P, d) for a VLM, prepended to the sequence). ``remat`` is accepted
    for the reference's signature and ignored: nothing here takes a
    gradient."""
    _require_ported(cfg)
    x = _embed_inputs(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    tables = _tables(cfg, positions, x.dtype)
    for p in _layers(params, cfg):
        x, _ = _attn_block(x, p, cfg, tables)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, x)


# ---------------------------------------------------------------------------
# decode (serve) path
# ---------------------------------------------------------------------------


class DecodeCache(NamedTuple):
    """The decode cache, stacked over layers as the reference's fields:
    ``kv`` for GQA, "k" and "v" of shape (layers, 1, B, T, Hkv, dh), or
    ``mla`` for MLA, "ckv" (layers, 1, B, T, kv_lora) and "krope"
    (layers, 1, B, T, rope_dim); the other is (). "len", the tokens
    written, is a host integer. ``decode_step`` writes into the tensors in
    place. (The reference's recurrent states and encoder K/V come with
    their families' slices.)"""

    kv: Any = ()
    mla: Any = ()

    @property
    def length(self) -> int:
        """Tokens written."""
        return (self.kv or self.mla)["len"]

    def clone(self, length=None) -> "DecodeCache":
        """A cache whose tensors no other cache shares, holding this one's
        first ``length`` positions (all written ones by default)."""
        n = self.length if length is None else int(length)
        if not 0 <= n <= self.length:
            raise ValueError(f"length {n} outside [0, {self.length}]")

        def copy(field):
            if not field:
                return ()
            return {**{k: v.clone() for k, v in field.items() if k != "len"},
                    "len": n}

        return DecodeCache(kv=copy(self.kv), mla=copy(self.mla))


def init_cache(cfg: ModelConfig, batch: int, max_len: int, cache_dtype=None,
               *, device=None):
    """Zeros cache on ``device`` (``cuda`` unless the caller passes
    another)."""
    _require_ported(cfg)
    device = resolve_device(device)
    cd = getattr(torch, cache_dtype or cfg.compute_dtype)
    zeros = lambda *shape: torch.zeros(  # noqa: E731
        (cfg.n_layers, 1, batch, max_len) + shape, dtype=cd, device=device)
    if cfg.mla is not None:
        m = cfg.mla
        return DecodeCache(mla={"ckv": zeros(m.kv_lora_rank),
                                "krope": zeros(m.rope_head_dim), "len": 0})
    return DecodeCache(kv={"k": zeros(cfg.n_kv_heads, cfg.head_dim),
                           "v": zeros(cfg.n_kv_heads, cfg.head_dim),
                           "len": 0})


def decode_step(params, cfg: ModelConfig, tokens, cache: DecodeCache):
    """One decode step: tokens (B, S) (S = 1 when decoding) -> logits
    (B, S, V) and the cache with S more tokens. The new entries are written
    into the cache's tensors in place (see ``DecodeCache``)."""
    _require_ported(cfg)
    cd = getattr(torch, cfg.compute_dtype)
    x = params["embed"][tokens].to(cd)
    length = cache.length
    s = tokens.shape[1]
    positions = torch.arange(length, length + s, device=x.device)[None, :]
    tables = _tables(cfg, positions, cd)
    if cfg.mla is not None:
        cs, rs = cache.mla["ckv"], cache.mla["krope"]
        for i, p in enumerate(_layers(params, cfg)):
            x, _ = _attn_block(x, p, cfg, tables,
                               MLACache(cs[i, 0], rs[i, 0], length))
        new = cache._replace(mla={"ckv": cs, "krope": rs, "len": length + s})
    else:
        ks, vs = cache.kv["k"], cache.kv["v"]
        # the reference's _attn_block_decode_abs at window 0 (its
        # sliding-window ring buffer comes with the RG-LRU slice)
        for i, p in enumerate(_layers(params, cfg)):
            x, _ = _attn_block(x, p, cfg, tables,
                               KVCache(ks[i, 0], vs[i, 0], length))
        new = cache._replace(kv={"k": ks, "v": vs, "len": length + s})
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, x), new
