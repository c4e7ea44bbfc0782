"""Mixture-of-Experts layer (port of ``repro/models/moe.py``): qwen3-moe,
deepseek-v2.

Three dispatch modes, as in the reference:
  * "dense"  — capacity-based one-hot dispatch (Switch-style): exact top-k
    semantics up to capacity drops; every expert's weights take part in
    the batched expert products.
  * "dense_chunked" — the same over token chunks of ``MOE_CHUNK``, each
    with its own capacity buckets (a Python loop over the chunks; the
    reference's ``jax.checkpoint`` matters only for a gradient).
  * "ragged" — sort by expert and the grouped matrix product K6
    (``kernels.ragged_dot``, the port of ``jax.lax.ragged_dot``): only the
    routed rows are multiplied.

Where the port departs from the reference's arithmetic, it keeps the
reference's values:
  * top-k ties go to the lower expert index, as ``jax.lax.top_k`` breaks
    them (``torch.topk`` promises no order), by a stable descending sort;
  * the dispatch and combine tensors (t, E, C) are scattered at each kept
    (token, expert, slot), not summed from (t, k, E, C) one-hot products
    (1.3 G elements at t = 4096, k = 8, E = 128, C = 320): a token picks
    distinct experts, so each place is written once, with the value the
    reference's sum gives;
  * the ragged combine adds a token's k expert outputs in the compute
    dtype one at a time, in the order of the expert sort, as the
    reference's scatter-add ``.at[tok[order]].add`` does on the CPU
    (``index_add_`` would use atomics in no fixed order on CUDA).
The router weight is read as stored and cast to float32 at use; the
forward's ``compute_params`` keeps it as stored for that reason.

Every dispatch is differentiable, as the reference's is under
``jax.value_and_grad``: in the ragged one the gradient flows through the
gather ``xt[order // k]``, the k-way combine and K6's autograd Function
(the experts' weight gradients from K6w on the card), so an expert that
took no token gets exact zeros and every other one its gradient.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ragged_dot import ragged_dot


def _top_k(probs, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest in descending
    order, the lower index first among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router(x, p, cfg, compute_dtype):
    logits = torch.matmul(x.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = _top_k(probs, cfg.moe.top_k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return top_p.to(compute_dtype), top_i


def _capacity_slots(top_i, n_experts: int, cap: int):
    """Each (token, k)'s position in its expert's bucket: the running count
    over the token-major flattened (t * k, E) one-hot, less one, as the
    reference counts it; and whether it is below the capacity."""
    t, k = top_i.shape
    onehot = (top_i[..., None] == torch.arange(
        n_experts, device=top_i.device)).to(torch.int64)  # (t, k, E)
    pos = torch.cumsum(onehot.reshape(t * k, n_experts), dim=0) - 1
    pos = (pos.reshape(t, k, n_experts) * onehot).sum(-1)
    return pos, pos < cap


def moe_dense(x, p, cfg):
    """Capacity-factor dense dispatch."""
    m = cfg.moe
    b, s, d = x.shape
    cd = x.dtype
    t = b * s
    cap = max(int(m.capacity_factor * t * m.top_k / m.n_experts), 1)
    # the shared experts first: under block remat the recompute then stops
    # before the combine product, whose output its backward never reads
    # (XLA drops it from the reference's recompute as dead code)
    shared = _shared(x, p, cfg)
    top_p, top_i = _router(x, p, cfg, cd)
    xt = x.reshape(t, d)
    top_p = top_p.reshape(t, m.top_k)
    top_i = top_i.reshape(t, m.top_k)
    pos, keep = _capacity_slots(top_i, m.n_experts, cap)

    # dispatch and combine (t, e, c): the place of each kept (token, k),
    # written once; a dropped one goes to a spare slot c = cap, cut off
    tok = torch.arange(t, device=x.device)[:, None]
    place = ((tok * m.n_experts + top_i) * (cap + 1)
             + torch.where(keep, pos, cap)).reshape(-1)
    disp = torch.zeros(t * m.n_experts * (cap + 1), dtype=cd, device=x.device)
    combine = torch.zeros_like(disp)
    disp[place] = 1
    combine[place] = (top_p * keep.to(cd)).reshape(-1)
    disp = disp.view(t, m.n_experts, cap + 1)[..., :cap]
    combine = combine.view(t, m.n_experts, cap + 1)[..., :cap]

    xe = torch.einsum("td,tec->ecd", xt, disp)
    h = torch.bmm(xe, p["we1"].to(cd))
    g = torch.bmm(xe, p["we3"].to(cd))
    ye = torch.bmm(F.silu(h) * g, p["we2"].to(cd))
    out = torch.einsum("ecd,tec->td", ye, combine).reshape(b, s, d)
    return out + shared


def moe_ragged(x, p, cfg):
    """Sort-based ragged dispatch over K6 (FLOP-honest); differentiable
    (K6 for the data gradient, K6w for the experts')."""
    m = cfg.moe
    b, s, d = x.shape
    cd = x.dtype
    t = b * s
    k = m.top_k
    top_p, top_i = _router(x, p, cfg, cd)
    xt = x.reshape(t, d)
    flat_e = top_i.reshape(t * k)
    flat_p = top_p.reshape(t * k)
    order = torch.argsort(flat_e, stable=True)
    xe = xt[order // k]  # the reference's tok[order], tok = repeat(t, k)
    group_sizes = torch.zeros(m.n_experts, dtype=torch.int32,
                              device=x.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e, dtype=torch.int32))
    h = ragged_dot(xe, p["we1"].to(cd), group_sizes)
    g = ragged_dot(xe, p["we3"].to(cd), group_sizes)
    ye = ragged_dot(F.silu(h) * g, p["we2"].to(cd), group_sizes)
    ye = ye * flat_p[order][:, None]
    # each token's k rows of ye, in the order the sort put them
    rank = torch.empty_like(order)
    rank[order] = torch.arange(t * k, device=x.device)
    rows = torch.sort(rank.view(t, k), dim=1).values
    ys = ye[rows]  # (t, k, d)
    out = torch.zeros((t, d), dtype=cd, device=x.device)
    for j in range(k):
        out = out + ys[:, j]
    return out.reshape(b, s, d) + _shared(x, p, cfg)


def _shared(x, p, cfg):
    if cfg.moe.n_shared == 0:
        return 0.0
    cd = x.dtype
    h = torch.matmul(x, p["ws1"].to(cd))
    g = torch.matmul(x, p["ws3"].to(cd))
    return torch.matmul(F.silu(h) * g, p["ws2"].to(cd))


MOE_CHUNK = 4096  # tokens per dispatch chunk (dense_chunked mode)


def moe_dense_chunked(x, p, cfg):
    """Dense dispatch over token chunks: capacity C scales with the chunk,
    and capacity drops become per-chunk (each chunk gets its own expert
    buckets)."""
    b, s, d = x.shape
    t = b * s
    if t <= MOE_CHUNK or t % MOE_CHUNK != 0:
        return moe_dense(x, p, cfg)
    xt = x.reshape(t // MOE_CHUNK, 1, MOE_CHUNK, d)
    return torch.cat([moe_dense(xc, p, cfg) for xc in xt]).reshape(b, s, d)


def moe_layer(x, p, cfg):
    if cfg.moe.dispatch == "ragged":
        return moe_ragged(x, p, cfg)
    if cfg.moe.dispatch == "dense_chunked":
        return moe_dense_chunked(x, p, cfg)
    return moe_dense(x, p, cfg)
