"""K6 — the grouped matrix product of the MoE layer's ragged dispatch,
and its backward.

Replaces XLA's ``jax.lax.ragged_dot`` in ``moe_ragged``
(``src/repro/models/moe.py:81-83``), the one op of the reference that is
neither a Pallas kernel nor a plain matrix product: the rows of ``lhs``
come sorted by expert, ``group_sizes[g]`` of them for expert ``g``, and
each group multiplies its own ``rhs[g]``. The sizes live on the device, so
a per-group loop (``ref.ragged_dot_plain``) would sync the host on every
expert product.

The CUDA source is ``csrc/ragged_dot.cu``; its header says what bounds it
on the H100 (the bytes of each group's ``rhs``) and how it works. The
kernel reads the group sizes itself: it walks an upper bound of row tiles,
``ceil(M / 64) + G + 1``, and stops at the first past the real count, so
the wrapper never reads ``group_sizes`` on the host. Two paths, chosen by
shape and alignment only (``path``): ``"tma"``, a persistent grid fed by
TMA through a shared-memory ring (``wgmma`` for bfloat16), where TMA can
describe the tensors; ``"simple"``, one CTA per output tile with plain
loads, for the rest. ``ragged_dot`` launches one of them for CUDA tensors
and runs the plain version for CPU tensors; ``ragged_dot.launches`` counts
the CUDA launches and ``ragged_dot.launches_by_path`` splits them by path.

``ragged_dot`` is differentiable (``_RaggedDot``, the rule XLA gives
``jax.lax.ragged_dot`` under ``jax.value_and_grad``). The gradient of lhs
is K6 itself over the output's gradient and ``rhs`` read transposed: on
the TMA path the kernel's ``trans`` mode loads rhs as it is stored (the
same tensor map, its coordinates swapped) with the reduction along rhs's
contiguous axis, so no transposed copy of G K N elements is made; its
launches count under ``"tma_dgrad"``. The simple path, and the CPU, read
``rhs.transpose(1, 2)`` (the simple kernel from a contiguous copy). The
gradient of rhs is K6w (``ragged_dot_wgrad``,
``csrc/ragged_dot_wgrad.cu``): on its TMA path a persistent grid walks
(group, 128 x 128 output tile) items group by group, TMA brings the
group's rows of lhs and dout through a shared-memory ring, ``wgmma``
(bfloat16) or fmaf warps (float32) reduce over them, and TMA stores each
tile; the output's 2 G K N bytes bound it in bfloat16, the fmaf rate in
float32. Rows of the next group in a group's last stage are zeroed before
the tensor cores read them; every output is owned by one item and summed
in one order, so two calls give the same bits. Its simple path (one CTA
per 64 x 64 tile) takes the shapes TMA cannot describe and, on the card,
holds the TMA path to the same float32 bits. Backward's K6 launches count
in ``ragged_dot.launches`` as the forward's do, K6w's in
``ragged_dot_wgrad.launches`` and ``ragged_dot_wgrad.launches_by_path``.
On CPU tensors both directions run the plain versions; on CUDA tensors a
kernel that fails to build or launch raises, and nothing gives way to the
plain version. On meta tensors (the dry run) each product is a shape-only
op, ``repro_torch::ragged_dot_shape`` and ``::ragged_dot_wgrad_shape``,
with a FLOP formula for ``torch.utils.flop_counter``: 2 M K N for every
product (the MoE layer's groups hold all M rows), so a counted program
sees K6 and its two backward products as it sees a matrix product.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.ref import (
    ragged_dot_plain,
    ragged_dot_wgrad_plain,
)

_INT32_MAX = (1 << 31) - 1


def path(lhs, rhs) -> str:
    """Which K6 kernel takes ``lhs`` [M, K] and ``rhs`` [G, K, N] (or, for
    the data gradient, [G, N, K] read transposed: the test is symmetric in
    K and N): ``"tma"`` where a TMA tensor map can describe both (K and N
    multiples of the 16-byte vector, 8 bfloat16 or 4 float32; K and G
    positive; both bases 16-byte aligned), else ``"simple"``. Shape and
    alignment only, never a failure."""
    k = lhs.shape[1]
    g, k2, n = rhs.shape
    per_vec = 16 // lhs.element_size()  # elements in a 16-byte vector
    fits = (k % per_vec == 0 and k2 % per_vec == 0 and n % per_vec == 0
            and k > 0 and g > 0
            and lhs.data_ptr() % 16 == 0 and rhs.data_ptr() % 16 == 0)
    return "tma" if fits else "simple"


def wgrad_path(lhs, dout) -> str:
    """Which K6w kernel takes ``lhs`` [M, K] and ``dout`` [M, N]: ``"tma"``
    where TMA tensor maps can describe them and the [G, K, N] output (K
    and N multiples of the 16-byte vector, M positive, both bases 16-byte
    aligned; the output is allocated aligned), else ``"simple"``. Shape
    and alignment only, never a failure."""
    m, k = lhs.shape
    n = dout.shape[1]
    per_vec = 16 // lhs.element_size()
    fits = (k % per_vec == 0 and n % per_vec == 0 and m > 0
            and lhs.data_ptr() % 16 == 0 and dout.data_ptr() % 16 == 0)
    return "tma" if fits else "simple"


def ragged_dot(lhs, rhs, group_sizes):
    """K6: ``lhs`` [M, K] and ``rhs`` [G, K, N], both float32 or both
    bfloat16, ``group_sizes`` int32 [G]. Returns [M, N] in lhs's dtype
    (float32 accumulation): the rows of group ``g`` times ``rhs[g]``, zeros
    past ``sum(group_sizes)``. The CUDA kernel for CUDA tensors, the plain
    version for CPU tensors; differentiable in lhs and rhs."""
    return _RaggedDot.apply(lhs, rhs, group_sizes)


def _on_cuda(t, name: str) -> bool:
    """False for a CPU tensor (the plain version's), True for a CUDA one;
    raises for any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no {name} kernel for {t.device}")
    return True


def _check_operands(kernel: str, lhs, name: str, other, group_sizes):
    """Raise unless lhs is float32 or bfloat16, ``other`` has its dtype,
    group_sizes is int32, all three lie on lhs's device and all are
    contiguous."""
    if lhs.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{kernel} takes float32 or bfloat16, got "
                         f"{lhs.dtype}")
    if other.dtype != lhs.dtype or group_sizes.dtype != torch.int32:
        raise ValueError(f"{kernel}: {name} must have lhs's dtype and "
                         f"group_sizes must be int32")
    for what, t in ((name, other), ("group_sizes", group_sizes)):
        if t.device != lhs.device:
            raise ValueError(f"{kernel}: {what} is on {t.device}, lhs on "
                             f"{lhs.device}")
    for what, t in (("lhs", lhs), (name, other),
                    ("group_sizes", group_sizes)):
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {what} must be contiguous")


@torch.library.custom_op("repro_torch::ragged_dot_shape", mutates_args=())
def _k6_shape(lhs: torch.Tensor, rhs: torch.Tensor,
              trans: bool) -> torch.Tensor:
    """K6's output on meta tensors (shape and dtype only)."""
    raise ValueError("ragged_dot_shape takes meta tensors only")


@_k6_shape.register_fake
def _(lhs, rhs, trans):
    return lhs.new_empty((lhs.shape[0], rhs.shape[1] if trans
                          else rhs.shape[2]))


@register_flop_formula(torch.ops.repro_torch.ragged_dot_shape)
def _k6_flops(lhs_shape, rhs_shape, trans, *args, out_shape=None, **kw):
    return 2 * lhs_shape[0] * lhs_shape[1] * out_shape[1]


@torch.library.custom_op("repro_torch::ragged_dot_wgrad_shape",
                         mutates_args=())
def _k6w_shape(lhs: torch.Tensor, dout: torch.Tensor,
               n_groups: int) -> torch.Tensor:
    """K6w's output on meta tensors (shape and dtype only)."""
    raise ValueError("ragged_dot_wgrad_shape takes meta tensors only")


@_k6w_shape.register_fake
def _(lhs, dout, n_groups):
    return lhs.new_empty((n_groups, lhs.shape[1], dout.shape[1]))


@register_flop_formula(torch.ops.repro_torch.ragged_dot_wgrad_shape)
def _k6w_flops(lhs_shape, dout_shape, n_groups, *args, out_shape=None,
               **kw):
    return 2 * lhs_shape[0] * lhs_shape[1] * dout_shape[1]


def _k6(lhs, rhs, group_sizes, trans: bool = False):
    """K6: the launch on CUDA tensors, the plain version on CPU ones, the
    shape-only op on meta ones. ``trans``: ``rhs`` is [G, N, K] and is
    read transposed (``lhs @ rhs[g].T``), on the TMA path only."""
    if lhs.device.type == "meta":
        return _k6_shape(lhs, rhs, trans)
    if not _on_cuda(lhs, "ragged_dot"):
        return ragged_dot_plain(lhs, rhs.transpose(1, 2) if trans else rhs,
                                group_sizes)
    if lhs.dim() != 2 or rhs.dim() != 3 or group_sizes.dim() != 1:
        raise ValueError("K6 takes lhs [M, K], rhs [G, K, N] and "
                         "group_sizes [G]")
    m, k = lhs.shape
    g, k2, n = rhs.shape
    if trans:
        k2, n = n, k2
    if k2 != k or group_sizes.shape[0] != g:
        raise ValueError(f"K6: lhs {tuple(lhs.shape)}, rhs "
                         f"{tuple(rhs.shape)} and group_sizes "
                         f"{tuple(group_sizes.shape)} do not fit")
    _check_operands("K6", lhs, "rhs", rhs, group_sizes)
    if max(m, k, n) > _INT32_MAX:
        raise ValueError("K6: M, K and N must fit in int32")
    out = torch.empty((m, n), dtype=lhs.dtype, device=lhs.device)
    if m == 0 or n == 0:
        return out
    which = path(lhs, rhs)
    if trans and which != "tma":
        raise ValueError("K6 reads rhs transposed on the TMA path only")
    stream = torch.cuda.current_stream(lhs.device).cuda_stream
    err = build.library().ragged_dot_launch(
        lhs.data_ptr(), rhs.data_ptr(), group_sizes.data_ptr(),
        out.data_ptr(), m, k, n, g, int(lhs.dtype == torch.bfloat16),
        int(which == "tma"), int(trans), stream,
    )
    build.check(err, "ragged_dot")
    build.count_launch(ragged_dot, "tma_dgrad" if trans else which)
    return out


ragged_dot.launches = 0
ragged_dot.launches_by_path = {"tma": 0, "tma_dgrad": 0, "simple": 0}


def ragged_dot_wgrad(lhs, dout, group_sizes, n_groups: int):
    """K6w: the gradient of ``ragged_dot(lhs, rhs, group_sizes)`` with
    respect to rhs, from the output's gradient ``dout`` [M, N]:
    [G, K, N] in lhs's dtype (float32 accumulation), ``drhs[g] =
    lhs[rows of g].T @ dout[rows of g]``, zeros for an empty group, rows
    past the sum ignored. The CUDA kernel that ``wgrad_path`` picks for
    CUDA tensors (it reads the sizes on the device), the plain version for
    CPU tensors."""
    return _k6w(lhs, dout, group_sizes, n_groups)


def _k6w(lhs, dout, group_sizes, n_groups: int, which: str | None = None):
    """K6w: the launch on CUDA tensors, the plain version on CPU ones.
    ``which``: the kernel, ``wgrad_path``'s choice by default; ``"simple"``
    runs the simple kernel whatever the shape, which holds the TMA path to
    its float32 bits on the card. On meta tensors, the shape-only op."""
    if lhs.device.type == "meta":
        return _k6w_shape(lhs, dout, n_groups)
    if not _on_cuda(lhs, "ragged_dot_wgrad"):
        return ragged_dot_wgrad_plain(lhs, dout, group_sizes, n_groups)
    if lhs.dim() != 2 or dout.dim() != 2 or group_sizes.dim() != 1:
        raise ValueError("K6w takes lhs [M, K], dout [M, N] and "
                         "group_sizes [G]")
    m, k = lhs.shape
    n = dout.shape[1]
    if dout.shape[0] != m or group_sizes.shape[0] != n_groups:
        raise ValueError(f"K6w: lhs {tuple(lhs.shape)}, dout "
                         f"{tuple(dout.shape)} and group_sizes "
                         f"{tuple(group_sizes.shape)} do not fit {n_groups} "
                         f"groups")
    _check_operands("K6w", lhs, "dout", dout, group_sizes)
    if max(m, k, n, n_groups) > _INT32_MAX:
        raise ValueError("K6w: M, K, N and G must fit in int32")
    out = torch.empty((n_groups, k, n), dtype=lhs.dtype, device=lhs.device)
    if out.numel() == 0:
        return out
    which = which or wgrad_path(lhs, dout)
    stream = torch.cuda.current_stream(lhs.device).cuda_stream
    err = build.library().ragged_dot_wgrad_launch(
        lhs.data_ptr(), dout.data_ptr(), group_sizes.data_ptr(),
        out.data_ptr(), m, k, n, n_groups, int(lhs.dtype == torch.bfloat16),
        int(which == "tma"), stream,
    )
    build.check(err, "ragged_dot_wgrad")
    build.count_launch(ragged_dot_wgrad, which)
    return out


ragged_dot_wgrad.launches = 0
ragged_dot_wgrad.launches_by_path = {"tma": 0, "simple": 0}


class _RaggedDot(torch.autograd.Function):
    """K6 forward; backward: K6 over (dout, rhs read transposed) for lhs,
    K6w for rhs, each only where its input needs a gradient. Rows past
    the sum get a zero lhs gradient (K6 writes zeros there) and add
    nothing to rhs's. The data gradient copies rhs transposed only where
    K6 takes the simple path on CUDA tensors."""

    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes):
        ctx.save_for_backward(lhs, rhs, group_sizes)
        return _k6(lhs, rhs, group_sizes)

    @staticmethod
    def backward(ctx, dout):
        lhs, rhs, group_sizes = ctx.saved_tensors
        dout = dout.contiguous()
        dlhs = drhs = None
        if ctx.needs_input_grad[0]:
            if (dout.device.type in ("cpu", "meta")
                    or path(dout, rhs) == "tma"):
                dlhs = _k6(dout, rhs, group_sizes, trans=True)
            else:
                dlhs = _k6(dout, rhs.transpose(1, 2).contiguous(),
                           group_sizes)
        if ctx.needs_input_grad[1]:
            drhs = ragged_dot_wgrad(lhs, dout, group_sizes, rhs.shape[0])
        return dlhs, drhs, None
