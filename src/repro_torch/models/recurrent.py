"""Recurrent blocks (port of ``repro/models/recurrent.py``): RG-LRU
(RecurrentGemma/Griffin) and RWKV-6 (Finch).

Both run in two modes, as in the reference:
  * sequence mode (prefill): RG-LRU through the reference's associative
    scan, its odd/even tree reproduced combine for combine
    (``_associative_scan``), so each element is the same chain of
    combines and a prefill of S tokens takes about 2 log2(S) combine
    rounds, not S steps; RWKV-6 through a sequential loop over time with
    a float32 state (the reference's chunking by 64 only bounds its
    backward pass's memory and changes no arithmetic, so one loop
    serves);
  * step mode (decode): an O(1) state update per token.

Where JAX promotes dtypes, the dtype is explicit here. In particular
``rglru_block_step`` returns float32 for a bfloat16 input, because the
float32 recurrent state makes ``h``, ``h * g`` and then the output
projection float32 in the reference; ``torch.matmul`` refuses a float32
by bfloat16 product, so ``w_out`` is cast up (exact) instead. And
``jax.nn.gelu`` is the tanh approximation (``_gelu``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# RG-LRU (Griffin)
# ---------------------------------------------------------------------------


class RGLRUState(NamedTuple):
    h: torch.Tensor       # (B, d_rnn) recurrent state (float32 in a cache)
    conv: torch.Tensor    # (B, conv_width - 1, d_rnn) conv tail


_C = 8.0  # Griffin's fixed recurrence sharpness constant


def _gelu(x):
    """``jax.nn.gelu`` at its default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _rglru_gates(x, p, cd):
    r = torch.sigmoid(torch.matmul(x, p["w_rgate"].to(cd)))
    i = torch.sigmoid(torch.matmul(x, p["w_igate"].to(cd)))
    log_a = -_C * r * F.softplus(p["a_param"].to(cd))
    a = torch.exp(log_a)
    gated = i * x
    scale = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6))
    return a, scale * gated


def _combine(c1, c2):
    a1, b1 = c1
    a2, b2 = c2
    return a1 * a2, a2 * b1 + b2


def _associative_scan(fn, elems):
    """``jax.lax.associative_scan(fn, elems, axis=1)``: the same recursion
    (combine adjacent pairs, scan the half, fix up the even elements,
    interleave), so every element is the reference's chain of ``fn``."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = fn([e[:, 0:n - 1:2] for e in elems],
                 [e[:, 1::2] for e in elems])
    odd = _associative_scan(fn, reduced)
    if n % 2 == 0:
        even = fn([e[:, :-1] for e in odd], [e[:, 2::2] for e in elems])
    else:
        even = fn(odd, [e[:, 2::2] for e in elems])
    out = []
    for e, ev, od in zip(elems, even, odd):
        full = torch.empty_like(e)
        full[:, 0:1] = e[:, 0:1]
        full[:, 2::2] = ev
        full[:, 1::2] = od
        out.append(full)
    return out


def rglru_seq(x, p):
    """x: (B, S, d_rnn) -> same, h0 = 0. Associative scan over time."""
    a, b = _rglru_gates(x, p, x.dtype)
    _, h = _associative_scan(_combine, [a, b])
    return h


def rglru_step(x, p, h_prev):
    """x: (B, d_rnn), h_prev: (B, d_rnn) -> (y, h). With a float32
    ``h_prev`` the result is float32, as JAX promotes it."""
    a, b = _rglru_gates(x, p, x.dtype)
    h = a * h_prev + b
    return h, h


def conv1d_seq(x, w):
    """Causal depthwise conv, x: (B,S,D), w: (cw, D)."""
    cw, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, cw - 1, 0))
    out = pad[:, 0:s] * w[0]
    for i in range(1, cw):
        out = out + pad[:, i:i + s] * w[i]
    return out


def conv1d_step(x, w, tail):
    """x: (B,D); tail: (B,cw-1,D) -> (y, new_tail)."""
    window = torch.cat([tail, x[:, None, :]], dim=1)  # (B,cw,D)
    y = torch.einsum("bcd,cd->bd", window, w)
    return y, window[:, 1:, :]


def rglru_block_seq(x, p, cfg):
    """Full Griffin recurrent block, sequence mode. x: (B,S,D)."""
    cd = x.dtype
    u = torch.matmul(x, p["wx"].to(cd))
    g = _gelu(torch.matmul(x, p["wg"].to(cd)))
    u = conv1d_seq(u, p["conv_w"].to(cd))
    h = rglru_seq(u, p)
    return torch.matmul(h * g, p["w_out"].to(cd))


def rglru_block_step(x, p, cfg, state: RGLRUState):
    """One token, x: (B,D) -> (out, new state). ``out`` is float32 when
    the state's ``h`` is (the reference's promotion); the caller casts."""
    cd = x.dtype
    u = torch.matmul(x, p["wx"].to(cd))
    g = _gelu(torch.matmul(x, p["wg"].to(cd)))
    u, conv_tail = conv1d_step(u, p["conv_w"].to(cd), state.conv)
    y, h = rglru_step(u, p, state.h)
    yg = y * g
    out = torch.matmul(yg, p["w_out"].to(cd).to(yg.dtype))
    return out, RGLRUState(h=h, conv=conv_tail)


# ---------------------------------------------------------------------------
# RWKV-6 (Finch) — data-dependent decay linear attention
# ---------------------------------------------------------------------------


class RWKVState(NamedTuple):
    s: torch.Tensor           # (B, H, dh, dh) wkv state, float32
    x_prev_att: torch.Tensor  # (B, D) previous token (time-mix shift)
    x_prev_ffn: torch.Tensor  # (B, D) previous token (channel-mix shift)


def _timemix_proj(x, x_prev, p, cd):
    """Token-shift interpolation + r/k/v/w/g projections.
    x: (B,S,D); x_prev: (B,D) carry from the previous chunk."""
    xs = torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)
    mu = p["mu"].to(cd)  # (5, D): r,k,v,w,g

    def mix(i):
        return x * mu[i] + xs * (1.0 - mu[i])

    r = torch.matmul(mix(0), p["wr"].to(cd))
    k = torch.matmul(mix(1), p["wk"].to(cd))
    v = torch.matmul(mix(2), p["wv"].to(cd))
    w_lo = torch.matmul(mix(3), p["ww_a"].to(cd))
    w = torch.matmul(torch.tanh(w_lo), p["ww_b"].to(cd))
    w = torch.exp(-torch.exp(w.float()))  # data-dependent decay in (0,1)
    g = F.silu(torch.matmul(mix(4), p["wg"].to(cd)))
    return r, k, v, w, g, x[:, -1, :]


def _wkv_scan(r, k, v, w, u, s0):
    """Sequential wkv over time (float32 state). Shapes: (B,S,H,dh) ->
    (B,S,H,dh), and the final (B,H,dh,dh) state."""
    state = s0
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        att = state + kv * u[None, :, :, None]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t], att))
        state = state * w[:, t, :, :, None] + kv
    return torch.stack(ys, dim=1), state


def rwkv_timemix_seq(x, p, cfg, state: Optional[RWKVState]):
    cd = x.dtype
    b, s, d = x.shape
    dh = cfg.rwkv.head_dim
    h = d // dh
    x_prev = (state.x_prev_att if state is not None
              else torch.zeros((b, d), dtype=cd, device=x.device))
    r, k, v, w, g, x_last = _timemix_proj(x, x_prev, p, cd)
    rs = r.reshape(b, s, h, dh).float()
    ks = k.reshape(b, s, h, dh).float()
    vs = v.reshape(b, s, h, dh).float()
    ws = w.reshape(b, s, h, dh)
    u = p["u"].float()  # (H, dh)
    s0 = (state.s if state is not None else
          torch.zeros((b, h, dh, dh), dtype=torch.float32, device=x.device))
    y, s_fin = _wkv_scan(rs, ks, vs, ws, u, s0)
    y = y.reshape(b, s, d).to(cd) * g
    out = torch.matmul(y, p["w_out"].to(cd))
    return out, s_fin, x_last


def rwkv_channelmix(x, x_prev, p, cd):
    xs = torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)
    mu = p["mu_c"].to(cd)  # (2, D)
    xk = x * mu[0] + xs * (1 - mu[0])
    xr = x * mu[1] + xs * (1 - mu[1])
    k = torch.matmul(xk, p["wk_c"].to(cd))
    k = torch.square(torch.relu(k))
    v = torch.matmul(k, p["wv_c"].to(cd))
    r = torch.sigmoid(torch.matmul(xr, p["wr_c"].to(cd)))
    return r * v, x[:, -1, :]
