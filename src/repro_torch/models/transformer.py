"""Model forward passes (port of ``repro/models/transformer.py``) for the
dense and VLM families: the causal LM over ``block_pattern == ("attn",)``
with GQA attention and a SwiGLU MLP, and its decode path with a KV cache.

Entry points:
  forward_lm(params, cfg, batch)            -> logits (prefill)
  init_cache(cfg, batch_size, max_len)      -> stacked decode cache
  decode_step(params, cfg, tokens, cache)   -> logits, cache
  compute_params(params, cfg)               -> the weights as the forward
                                               reads them (cast once)

The reference's layer scan becomes a Python loop over the stacked leaves.
MoE, MLA, the recurrent (RG-LRU, RWKV-6) blocks with the local-window ring
buffer, and the encoder-decoder raise ``NotImplementedError``: they come
with later slices (``ROADMAP.md`` queue 1), and nothing here falls back to
another computation for them. ``loss_fn`` comes with the training slice.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.kernels.ops import resolve_device
from repro_torch.models.attention import KVCache, _gqa
from repro_torch.models.config import ModelConfig
from repro_torch.models.init import block_pattern
from repro_torch.models.layers import rms_norm, rope_tables, swiglu

# the leaves the reference does not cast to the compute dtype at use:
# rms_norm reads its scale in float32
_NORM_SCALES = ("ln1", "ln2", "final_norm")


def _require_ported(cfg: ModelConfig) -> None:
    """Raise for every family whose blocks this slice does not port."""
    missing = []
    if cfg.moe is not None:
        missing.append("MoE (cfg.moe)")
    if cfg.mla is not None:
        missing.append("MLA (cfg.mla)")
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
    a, new_cache = _gqa(h, p, cfg, tables, cache)
    x = x + a
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    f = swiglu(h, p["w1"], p["w3"], p["w2"], x.dtype)
    return x + f, new_cache


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
    except the norm scales, which stay as stored. The reference casts the
    same leaves at each use; casting them once gives the same values and
    spares a decode step from reading the stored (float32) weights. A leaf
    already in its dtype on ``device`` is kept, not copied."""
    _require_ported(cfg)
    device = resolve_device(device)
    cd = getattr(torch, cfg.compute_dtype)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else
                v.to(device=device,
                     dtype=v.dtype if k in _NORM_SCALES else cd)
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
    tables = rope_tables(positions, cfg.head_dim, cfg.rope_theta,
                         cfg.rope_frac, x.dtype)
    for p in _layers(params, cfg):
        x, _ = _attn_block(x, p, cfg, tables)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, x)


# ---------------------------------------------------------------------------
# decode (serve) path
# ---------------------------------------------------------------------------


class DecodeCache(NamedTuple):
    """The decode cache, stacked over layers as the reference's ``kv``
    field: "k" and "v" of shape (layers, 1, B, T, Hkv, dh) and "len", the
    tokens written, as a host integer. ``decode_step`` writes K/V into "k"
    and "v" in place. (The reference's other fields, for MLA, the recurrent
    states and the encoder's K/V, come with their families' slices.)"""

    kv: Any

    def clone(self, length=None) -> "DecodeCache":
        """A cache whose tensors no other cache shares, holding this one's
        first ``length`` positions (all written ones by default)."""
        n = self.kv["len"] if length is None else int(length)
        if not 0 <= n <= self.kv["len"]:
            raise ValueError(f"length {n} outside [0, {self.kv['len']}]")
        return self._replace(kv={"k": self.kv["k"].clone(),
                                 "v": self.kv["v"].clone(), "len": n})


def init_cache(cfg: ModelConfig, batch: int, max_len: int, cache_dtype=None,
               *, device=None):
    """Zeros cache on ``device`` (``cuda`` unless the caller passes
    another)."""
    _require_ported(cfg)
    device = resolve_device(device)
    cd = getattr(torch, cache_dtype or cfg.compute_dtype)
    shape = (cfg.n_layers, 1, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return DecodeCache(
        kv={"k": torch.zeros(shape, dtype=cd, device=device),
            "v": torch.zeros(shape, dtype=cd, device=device), "len": 0})


def decode_step(params, cfg: ModelConfig, tokens, cache: DecodeCache):
    """One decode step: tokens (B, S) (S = 1 when decoding) -> logits
    (B, S, V) and the cache with S more tokens. K/V are written into the
    cache's tensors in place (see ``DecodeCache``)."""
    _require_ported(cfg)
    cd = getattr(torch, cfg.compute_dtype)
    x = params["embed"][tokens].to(cd)
    length = cache.kv["len"]
    s = tokens.shape[1]
    positions = torch.arange(length, length + s, device=x.device)[None, :]
    tables = rope_tables(positions, cfg.head_dim, cfg.rope_theta,
                         cfg.rope_frac, cd)
    ks, vs = cache.kv["k"], cache.kv["v"]
    # the reference's _attn_block_decode_abs at window 0 (its sliding-window
    # ring buffer comes with the RG-LRU slice)
    for i, p in enumerate(_layers(params, cfg)):
        x, _ = _attn_block(x, p, cfg, tables,
                           KVCache(ks[i, 0], vs[i, 0], length))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(params, cfg, x)
    return logits, cache._replace(kv={"k": ks, "v": vs, "len": length + s})
