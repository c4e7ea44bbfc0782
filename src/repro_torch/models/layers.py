"""Shared layer primitives (port of ``repro/models/layers.py``).

Dtype-explicit as in the reference: norms compute in float32, RoPE angles
are float32 and their cos/sin are cast to the activation dtype before the
rotation, and every weight is cast to the compute dtype at its use (a
no-op where the caller already holds it in that dtype).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x, scale, eps: float = 1e-6):
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(dt)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(dt)


def rope_tables(positions, dh: int, theta: float = 10000.0,
                rope_frac: float = 1.0, dtype=torch.float32):
    """(cos, sin) of shape (..., S, 1, half) in ``dtype`` for the rotated
    leading ``int(dh * rope_frac)`` dims (rounded down to even), or None
    when nothing rotates. One table serves every layer and both q and k."""
    rot = int(dh * rope_frac)
    rot -= rot % 2
    if rot == 0:
        return None
    half = rot // 2
    freqs = 1.0 / (theta ** (
        torch.arange(0, half, dtype=torch.float32, device=positions.device)
        / half))
    ang = positions.float()[..., None] * freqs  # (..., S, half)
    return (torch.cos(ang)[..., None, :].to(dtype),
            torch.sin(ang)[..., None, :].to(dtype))


def apply_rope(x, tables):
    """Rotate the leading dims of (..., S, H, dh) by ``rope_tables``."""
    if tables is None:
        return x
    cos, sin = tables
    half = cos.shape[-1]
    x1, x2 = x[..., :half], x[..., half:2 * half]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    if x.shape[-1] > 2 * half:
        out = torch.cat([out, x[..., 2 * half:]], dim=-1)
    return out


def rope(x, positions, theta: float = 10000.0, rope_frac: float = 1.0):
    """Rotary embedding on the last dim of (..., S, H, dh); ``rope_frac`` < 1
    rotates only the leading fraction (phi-4 partial rotary)."""
    return apply_rope(x, rope_tables(positions, x.shape[-1], theta,
                                     rope_frac, x.dtype))


def swiglu(x, w1, w3, w2, compute_dtype):
    h = torch.matmul(x, w1.to(compute_dtype))
    g = torch.matmul(x, w3.to(compute_dtype))
    return torch.matmul(F.silu(h) * g, w2.to(compute_dtype))


def gelu_mlp(x, w1, b1, w2, b2, compute_dtype):
    h = torch.matmul(x, w1.to(compute_dtype))
    if b1 is not None:
        h = h + b1.to(compute_dtype)
    h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    out = torch.matmul(h, w2.to(compute_dtype))
    if b2 is not None:
        out = out + b2.to(compute_dtype)
    return out


def softcap(logits, cap: float):
    if cap and cap > 0:
        return torch.tanh(logits / cap) * cap
    return logits
