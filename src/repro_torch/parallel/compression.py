"""Gradient compression (port of ``repro/parallel/compression.py``).

int8 block quantization with error feedback:
  * each gradient tensor is quantized per 256-element block to int8 with a
    float16 scale (about 3.9x fewer bytes than float32 on the wire),
  * the quantization residual is carried in an error-feedback accumulator
    (added back before the next round), so the compressed gradients sum to
    the true ones over rounds (Karimireddy et al. 2019).

The arithmetic is the reference's, bit for bit: float32 block maxima over
127, ``round`` half to even (as ``jnp.round``), the clip to [-127, 127],
the scale rounded to float16 after the payload is computed with the
float32 scale. ``compressed_psum`` is the all-reduce: a
``torch.distributed`` process group stands where the reference names a
mesh axis (gloo on the CPU, NCCL on the card).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.models.init import flatten_tree, unflatten_tree

BLOCK = 256


def _pad_len(n: int) -> int:
    return (n + BLOCK - 1) // BLOCK * BLOCK


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float[any shape] -> (int8 [padded / BLOCK, BLOCK], float16 scales
    [padded / BLOCK, 1])."""
    flat = x.reshape(-1).float()
    n = flat.shape[0]
    flat = F.pad(flat, (0, _pad_len(n) - n))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float16)


def dequantize(q: torch.Tensor, scale: torch.Tensor, shape,
               n: int) -> torch.Tensor:
    flat = (q.float() * scale.float()).reshape(-1)
    return flat[:n].reshape(shape)


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """all-reduce(x) over the process group ``group`` (the default group
    when None) with an int8 payload, as the reference's over an axis name:
    each rank quantizes its tensor and contributes the float32 product of
    its int8 blocks and float16 scales, and the sum is taken in float32.
    (The collective carries that dequantized product, as the reference's
    ``psum`` does; on a wire that could ship the int8 and float16 pair,
    ``wire_bytes_int8`` counts what it would carry.) Float32 result of x's
    shape."""
    q, scale = quantize(x)
    contrib = (q.float() * scale.float()).reshape(-1)
    dist.all_reduce(contrib, op=dist.ReduceOp.SUM, group=group)
    return contrib[:x.numel()].reshape(x.shape)


def compress_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """quantize -> dequantize (the error-feedback bookkeeping)."""
    q, s = quantize(x)
    return dequantize(q, s, x.shape, x.numel())


def ef_compress_grads(grads, ef_state):
    """Error-feedback step: returns (compressed grads, new ef_state),
    compressed = Q(g + e) and e' = (g + e) - compressed."""
    comp, new_ef = [], []
    for (path, g), (_, e) in zip(flatten_tree(grads), flatten_tree(ef_state)):
        corrected = g.float() + e
        c = compress_roundtrip(corrected)
        comp.append((path, c))
        new_ef.append((path, corrected - c))
    return unflatten_tree(comp), unflatten_tree(new_ef)


def init_ef_state(params):
    return unflatten_tree([
        (path, torch.zeros(p.shape, dtype=torch.float32, device=p.device))
        for path, p in flatten_tree(params)])


def wire_bytes_f32(params) -> int:
    return sum(math.prod(p.shape) * 4 for _, p in flatten_tree(params))


def wire_bytes_int8(params) -> int:
    total = 0
    for _, p in flatten_tree(params):
        m = _pad_len(math.prod(p.shape))
        total += m + (m // BLOCK) * 2  # int8 payload + f16 scales
    return total
