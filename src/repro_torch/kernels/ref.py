"""Plain torch versions shared by the kernels (port of parts of
``repro/kernels/ref.py``).

The JAX package compares keys as (hi:int32, lo:uint32) pairs because the
TPU vector unit has no int64. Native int64 order is the same order for the
non-negative key domain and for the KEY_MAX padding, so the port compares
int64 keys directly, on the CPU and in the CUDA kernels alike.

``gmm_estep_plain`` is the twin of ``ref.gmm_estep_ref``: K3's plain
version, which the CPU path and the tests run. ``fma_f32`` is the
single-rounding multiply-add of K1's and K5's plain versions.
``ragged_dot_plain`` is K6's plain version, the grouped matrix product of
``jax.lax.ragged_dot`` (the reference has no Pallas kernel for it), and
``ragged_dot_wgrad_plain`` K6w's, the gradient of that product with
respect to its grouped right operand.
"""
from __future__ import annotations

import torch


def key_leq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a <= b on int64 keys."""
    return a <= b


def key_lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b on int64 keys."""
    return a < b


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` on float32 tensors with one rounding, as a fused
    multiply-add rounds it. The product is exact in float64; the float64
    sum's own rounding is undone where it lands on a float32 tie, from the
    sum's exact error (TwoSum), so no double rounding remains."""
    p = a.to(torch.float64) * b.to(torch.float64)
    cd = c.to(torch.float64)
    r = p + cd
    bv = r - p
    err = (p - (r - bv)) + (cd - bv)
    f = r.to(torch.float32)
    fd = f.to(torch.float64)
    inf = torch.full_like(f, float("inf"))
    g = torch.nextafter(f, torch.where(r > fd, inf, -inf))
    tie = (r != fd) & (r == (fd + g.to(torch.float64)) * 0.5) & (err != 0)
    return torch.where(tie & ((err > 0) == (g > f)), g, f)


def gmm_estep_plain(
    x: torch.Tensor,        # float32[N]
    weights: torch.Tensor,  # float32[K]
    means: torch.Tensor,    # float32[K]
    stds: torch.Tensor,     # float32[K]
) -> torch.Tensor:
    """Responsibilities (N, K), numerically-stable softmax over components
    (float32, the operations in the order the K3 kernel rounds them)."""
    z = (x[:, None] - means[None, :]) / stds[None, :]
    logp = torch.log(weights)[None, :] - 0.5 * z * z - torch.log(stds)[None, :]
    m = logp.max(dim=1, keepdim=True).values
    e = torch.exp(logp - m)
    return e / e.sum(dim=1, keepdim=True)


def _group_bounds(group_sizes: torch.Tensor, m: int):
    """(group, start, end) of each group's rows, as ``ragged_dot_plain``
    cuts them: consecutive in group order, a negative size counted as 0,
    every bound clamped to ``m``. Reads the sizes on the host."""
    start = 0
    for g, size in enumerate(group_sizes.tolist()):
        end = min(start + max(int(size), 0), m)
        yield g, start, end
        start = end


def ragged_dot_plain(
    lhs: torch.Tensor,          # [M, K], float32 or bfloat16
    rhs: torch.Tensor,          # [G, K, N], lhs's dtype
    group_sizes: torch.Tensor,  # int32[G]
) -> torch.Tensor:
    """``jax.lax.ragged_dot``: the rows of group ``g`` (consecutive, in
    group order) multiply ``rhs[g]``; rows past ``sum(group_sizes)`` are
    zero, and a group that runs past row M is cut there (a negative size
    counts as 0). float32 accumulation, output in lhs's dtype. K6's plain
    version: it reads the group sizes on the host, so it syncs a device
    tensor on every call; the CPU path and the tests run it."""
    m = lhs.shape[0]
    out = torch.zeros((m, rhs.shape[2]), dtype=lhs.dtype, device=lhs.device)
    for g, start, end in _group_bounds(group_sizes, m):
        if end > start:
            out[start:end] = torch.matmul(lhs[start:end].float(),
                                          rhs[g].float()).to(lhs.dtype)
    return out


def ragged_dot_wgrad_plain(
    lhs: torch.Tensor,          # [M, K], float32 or bfloat16
    dout: torch.Tensor,         # [M, N], lhs's dtype
    group_sizes: torch.Tensor,  # int32[G]
    n_groups: int,
) -> torch.Tensor:
    """The gradient of ``ragged_dot_plain(lhs, rhs, group_sizes)`` with
    respect to ``rhs`` [G, K, N], given the output's gradient ``dout``:
    ``drhs[g] = lhs[rows of g].T @ dout[rows of g]``. An empty group gives
    exact zeros, rows past ``sum(group_sizes)`` add nothing, and a group
    that runs past row M is cut there. float32 accumulation, output in
    lhs's dtype. K6w's plain version (it syncs on the sizes, as
    ``ragged_dot_plain`` does)."""
    m, k = lhs.shape
    out = torch.zeros((n_groups, k, dout.shape[1]), dtype=lhs.dtype,
                      device=lhs.device)
    for g, start, end in _group_bounds(group_sizes, m):
        if end > start:
            out[g] = torch.matmul(lhs[start:end].float().T,
                                  dout[start:end].float()).to(lhs.dtype)
    return out
