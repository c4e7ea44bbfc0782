"""Parameter descriptors: one tree of (shape, dtype, logical_axes) per model
(port of ``repro/models/init.py``).

The descriptors are shapes only and cover all ten architectures:
``n_params`` and ``params_from_numpy`` work for every config. The same
tree drives random init and ``abstract_params`` (the reference's shape
structs, as meta tensors).

Per-layer leaves are STACKED over a leading "layers" axis, as in the
reference, so a parameter tree converted from the JAX package keeps its
structure; the forward loops over that axis.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels.ops import resolve_device
from repro_torch.models.config import ModelConfig


class ParamDesc(NamedTuple):
    shape: Tuple[int, ...]
    dtype: Any
    axes: Tuple[str, ...]  # logical axis names, len == len(shape)


def _d(shape, axes, dtype=None):
    assert len(shape) == len(axes), (shape, axes)
    return ParamDesc(tuple(int(s) for s in shape), dtype or torch.float32, tuple(axes))


def _attn_desc(cfg: ModelConfig, prefix: str = "") -> Dict[str, ParamDesc]:
    d = cfg.d_model
    nq = cfg.n_heads_eff * cfg.head_dim
    nkv = cfg.n_kv_heads * cfg.head_dim
    out = {
        f"w{'q' if not prefix else 'q_x'}": _d((d, nq), ("embed", "heads")),
    }
    if not prefix:
        out.update(
            {
                "wk": _d((d, nkv), ("embed", "kv")),
                "wv": _d((d, nkv), ("embed", "kv")),
                "wo": _d((nq, d), ("heads", "embed_out")),
            }
        )
        if cfg.qkv_bias:
            out["bq"] = _d((nq,), ("heads",))
            out["bk"] = _d((nkv,), ("kv",))
            out["bv"] = _d((nkv,), ("kv",))
    else:  # cross-attention (whisper decoder)
        out.update(
            {
                "wk_x": _d((d, nkv), ("embed", "kv")),
                "wv_x": _d((d, nkv), ("embed", "kv")),
                "wo_x": _d((nq, d), ("heads", "embed_out")),
            }
        )
    return out


def _mla_desc(cfg: ModelConfig) -> Dict[str, ParamDesc]:
    m = cfg.mla
    d = cfg.d_model
    h = cfg.n_heads
    qd = m.nope_head_dim + m.rope_head_dim
    out: Dict[str, ParamDesc] = {}
    if m.q_lora_rank:
        out["wq_a"] = _d((d, m.q_lora_rank), ("embed", "lora"))
        out["wq_b"] = _d((m.q_lora_rank, h * qd), ("lora", "heads"))
    else:
        out["wq"] = _d((d, h * qd), ("embed", "heads"))
    out["wkv_a"] = _d((d, m.kv_lora_rank + m.rope_head_dim), ("embed", "lora"))
    out["wkv_b"] = _d(
        (m.kv_lora_rank, h * (m.nope_head_dim + m.v_head_dim)), ("lora", "heads")
    )
    out["wo"] = _d((h * m.v_head_dim, d), ("heads", "embed_out"))
    return out


def _mlp_desc(cfg: ModelConfig) -> Dict[str, ParamDesc]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w1": _d((d, f), ("embed", "ffn")),
        "w3": _d((d, f), ("embed", "ffn")),
        "w2": _d((f, d), ("ffn", "embed_out")),
    }


def _moe_desc(cfg: ModelConfig) -> Dict[str, ParamDesc]:
    m = cfg.moe
    d = cfg.d_model
    out = {
        "router": _d((d, m.n_experts), ("embed", None)),
        "we1": _d((m.n_experts, d, m.d_ff_expert), ("experts", "embed", "ffn_e")),
        "we3": _d((m.n_experts, d, m.d_ff_expert), ("experts", "embed", "ffn_e")),
        "we2": _d((m.n_experts, m.d_ff_expert, d), ("experts", "ffn_e", "embed_out")),
    }
    if m.n_shared:
        fs = m.n_shared * (m.d_ff_shared or m.d_ff_expert)
        out.update(
            {
                "ws1": _d((d, fs), ("embed", "ffn")),
                "ws3": _d((d, fs), ("embed", "ffn")),
                "ws2": _d((fs, d), ("ffn", "embed_out")),
            }
        )
    return out


def _rglru_desc(cfg: ModelConfig) -> Dict[str, ParamDesc]:
    r = cfg.rglru
    d = cfg.d_model
    n = r.d_rnn or d
    return {
        "wx": _d((d, n), ("embed", "rnn")),
        "wg": _d((d, n), ("embed", "rnn")),
        "conv_w": _d((r.conv_width, n), (None, "rnn")),
        "w_rgate": _d((n, n), ("rnn", "rnn2")),
        "w_igate": _d((n, n), ("rnn", "rnn2")),
        "a_param": _d((n,), ("rnn",)),
        "w_out": _d((n, d), ("rnn", "embed_out")),
    }


def _rwkv_desc(cfg: ModelConfig) -> Dict[str, ParamDesc]:
    d = cfg.d_model
    w = cfg.rwkv
    h = d // w.head_dim
    return {
        "mu": _d((5, d), (None, "embed")),
        "wr": _d((d, d), ("embed", "heads")),
        "wk": _d((d, d), ("embed", "heads")),
        "wv": _d((d, d), ("embed", "heads")),
        "wg": _d((d, d), ("embed", "heads")),
        "ww_a": _d((d, w.decay_lora), ("embed", "lora")),
        "ww_b": _d((w.decay_lora, d), ("lora", "heads")),
        "u": _d((h, w.head_dim), ("rwkv_heads", None)),
        "w_out": _d((d, d), ("heads", "embed_out")),
        "mu_c": _d((2, d), (None, "embed")),
        "wk_c": _d((d, cfg.d_ff), ("embed", "ffn")),
        "wv_c": _d((cfg.d_ff, d), ("ffn", "embed_out")),
        "wr_c": _d((d, d), ("embed", "heads")),
    }


def _block_desc(cfg: ModelConfig, kind: str) -> Dict[str, ParamDesc]:
    """One block's parameters; ``kind`` in {attn, rec, rwkv, enc, dec}."""
    d = cfg.d_model
    ln = lambda: _d((d,), ("embed",))
    if kind == "rwkv":
        return {"ln1": ln(), "ln2": ln(), **_rwkv_desc(cfg)}
    if kind == "rec":
        return {"ln1": ln(), "ln2": ln(), **_rglru_desc(cfg), **_mlp_desc(cfg)}
    out: Dict[str, ParamDesc] = {"ln1": ln(), "ln2": ln()}
    if cfg.mla is not None:
        out.update(_mla_desc(cfg))
    else:
        out.update(_attn_desc(cfg))
    if kind == "dec":
        out["ln_x"] = ln()
        out.update(_attn_desc(cfg, prefix="x"))
    if cfg.moe is not None and kind == "attn":
        out.update(_moe_desc(cfg))
    else:
        out.update(_mlp_desc(cfg))
    return out


def block_pattern(cfg: ModelConfig) -> Tuple[str, ...]:
    """Repeating block-kind pattern the layer scan iterates over."""
    if cfg.rwkv is not None:
        return ("rwkv",)
    if cfg.rglru is not None:
        return tuple(cfg.rglru.block_pattern)
    return ("attn",)


def _stack(desc: Dict[str, ParamDesc], n: int) -> Dict[str, ParamDesc]:
    return {
        k: ParamDesc((n,) + v.shape, v.dtype, ("layers",) + v.axes)
        for k, v in desc.items()
    }


def param_descriptors(cfg: ModelConfig) -> Dict[str, Any]:
    d, v = cfg.d_model, cfg.vocab
    out: Dict[str, Any] = {
        "embed": _d((v, d), ("vocab", "embed")),
        "final_norm": _d((d,), ("embed",)),
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = _d((d, v), ("embed", "vocab"))
    if cfg.vlm is not None:
        out["img_proj"] = _d((d, d), ("embed", "embed_out"))

    if cfg.encdec is not None:
        e = cfg.encdec
        out["enc_pos"] = _d((16384, d), (None, "embed"))  # covers prefill_32k enc len
        out["enc_layers"] = _stack(_block_desc(cfg, "enc"), e.n_enc_layers)
        out["enc_norm"] = _d((d,), ("embed",))
        out["dec_layers"] = _stack(_block_desc(cfg, "dec"), e.n_dec_layers)
        return out

    pattern = block_pattern(cfg)
    n_groups = cfg.n_layers // len(pattern)
    if n_groups * len(pattern) != cfg.n_layers:
        raise ValueError(f"{cfg.name}: the block pattern {pattern} must "
                         f"divide the depth {cfg.n_layers}")
    group: Dict[str, Any] = {}
    for gi, kind in enumerate(pattern):
        group[f"blk{gi}_{kind}"] = _block_desc(cfg, kind)
    out["layers"] = {k: _stack(v, n_groups) for k, v in group.items()}
    return out


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_tree(tree, prefix=(), is_leaf=None):
    """(path, leaf) pairs in the order in which JAX flattens a tree: dict
    keys sorted, a NamedTuple's fields by name, a tuple's or list's
    positions as ints. ``is_leaf(node)`` true stops the walk at ``node``."""
    if is_leaf is not None and is_leaf(tree):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in flatten_tree(tree[k], prefix + (k,), is_leaf)]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in flatten_tree(getattr(tree, f), prefix + (f,),
                                       is_leaf)]
    if isinstance(tree, (tuple, list)):
        return [kv for i, x in enumerate(tree)
                for kv in flatten_tree(x, prefix + (i,), is_leaf)]
    return [(prefix, tree)]


def unflatten_tree(pairs):
    """The nested dict tree of (path, leaf) pairs (``flatten_tree``'s
    inverse for a dict tree)."""
    out: Dict[str, Any] = {}
    for path, leaf in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def rebuild_tree(like, leaves):
    """``like``'s structure (dicts, NamedTuples, tuples, lists) with its
    leaves taken in ``flatten_tree``'s order from the iterable ``leaves``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if _is_namedtuple(node):
            return type(node)(*(build(getattr(node, f))
                                for f in node._fields))
        if isinstance(node, (tuple, list)):
            return type(node)(build(x) for x in node)
        return next(it)

    return build(like)


def tree_device(tree) -> torch.device:
    """The device of a tree's first leaf."""
    return flatten_tree(tree)[0][1].device


def _descriptors(cfg: ModelConfig):
    """(path, ParamDesc) pairs of ``cfg``'s parameters."""
    return flatten_tree(param_descriptors(cfg),
                        is_leaf=lambda x: isinstance(x, ParamDesc))


def abstract_params(cfg: ModelConfig):
    """The parameter tree on the meta device: every leaf with its shape in
    ``cfg.param_dtype`` (as the reference's ``abstract_params``, which
    ignores a descriptor's own dtype), and no memory allocated."""
    dt = getattr(torch, cfg.param_dtype)
    return unflatten_tree([
        (path, torch.empty(pd.shape, dtype=dt, device="meta"))
        for path, pd in _descriptors(cfg)])


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None):
    """Random init (fan-in scaled), on ``device`` (``cuda`` unless the caller
    passes another). The reference's rule: zeros for 1-D leaves and for
    leaves whose last dim is 1, else a standard normal over the square root
    of the second-to-last dim. The normals come from one ``torch.Generator``
    on ``device`` seeded with ``seed``, drawn leaf by leaf in the order JAX
    flattens the tree; they are not JAX's random bits (the tests give both
    packages the same weights through ``params_from_numpy``)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    dt = getattr(torch, cfg.param_dtype)

    def one(pd: ParamDesc):
        if len(pd.shape) == 1 or pd.shape[-1] == 1:
            return torch.zeros(pd.shape, dtype=dt, device=device)
        w = torch.randn(pd.shape, generator=gen, dtype=torch.float32,
                        device=device)
        return w.div_(math.sqrt(pd.shape[-2])).to(dt)

    return unflatten_tree([
        (path, one(pd)) for path, pd in _descriptors(cfg)])
