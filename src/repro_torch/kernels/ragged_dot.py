"""K6 — the grouped matrix product of the MoE layer's ragged dispatch.

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
``jax.lax.ragged_dot`` under ``jax.value_and_grad``): the gradient of lhs
is K6 itself over the output's gradient and ``rhs`` transposed to
[G, N, K] (a copy of G K N elements), and the gradient of rhs is K6w
(``ragged_dot_wgrad``, ``csrc/ragged_dot_wgrad.cu``), one CTA per output
tile looping over its group's rows, deterministic. Backward's K6 launches
count in ``ragged_dot.launches`` as the forward's do, K6w's in
``ragged_dot_wgrad.launches``. On CPU tensors both directions run the
plain versions; on CUDA tensors a kernel that fails to build or launch
raises, and nothing gives way to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (
    ragged_dot_plain,
    ragged_dot_wgrad_plain,
)

_INT32_MAX = (1 << 31) - 1


def path(lhs, rhs) -> str:
    """Which K6 kernel takes ``lhs`` [M, K] and ``rhs`` [G, K, N]:
    ``"tma"`` where a TMA tensor map can describe both (K and N multiples
    of the 16-byte vector, 8 bfloat16 or 4 float32; K and G positive; both
    bases 16-byte aligned), else ``"simple"``. Shape and alignment only,
    never a failure."""
    k = lhs.shape[1]
    g, _, n = rhs.shape
    per_vec = 16 // lhs.element_size()  # elements in a 16-byte vector
    fits = (k % per_vec == 0 and n % per_vec == 0 and k > 0 and g > 0
            and lhs.data_ptr() % 16 == 0 and rhs.data_ptr() % 16 == 0)
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


def _k6(lhs, rhs, group_sizes):
    """K6's forward: the launch on CUDA tensors, the plain version on CPU
    ones."""
    if not _on_cuda(lhs, "ragged_dot"):
        return ragged_dot_plain(lhs, rhs, group_sizes)
    if lhs.dim() != 2 or rhs.dim() != 3 or group_sizes.dim() != 1:
        raise ValueError("K6 takes lhs [M, K], rhs [G, K, N] and "
                         "group_sizes [G]")
    m, k = lhs.shape
    g, k2, n = rhs.shape
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
    stream = torch.cuda.current_stream(lhs.device).cuda_stream
    err = build.library().ragged_dot_launch(
        lhs.data_ptr(), rhs.data_ptr(), group_sizes.data_ptr(),
        out.data_ptr(), m, k, n, g, int(lhs.dtype == torch.bfloat16),
        int(which == "tma"), stream,
    )
    build.check(err, "ragged_dot")
    build.count_launch(ragged_dot, which)
    return out


ragged_dot.launches = 0
ragged_dot.launches_by_path = {"tma": 0, "simple": 0}


def ragged_dot_wgrad(lhs, dout, group_sizes, n_groups: int):
    """K6w: the gradient of ``ragged_dot(lhs, rhs, group_sizes)`` with
    respect to rhs, from the output's gradient ``dout`` [M, N]:
    [G, K, N] in lhs's dtype (float32 accumulation), ``drhs[g] =
    lhs[rows of g].T @ dout[rows of g]``, zeros for an empty group, rows
    past the sum ignored. The CUDA kernel for CUDA tensors (it reads the
    sizes on the device), the plain version for CPU tensors."""
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
    stream = torch.cuda.current_stream(lhs.device).cuda_stream
    err = build.library().ragged_dot_wgrad_launch(
        lhs.data_ptr(), dout.data_ptr(), group_sizes.data_ptr(),
        out.data_ptr(), m, k, n, n_groups, int(lhs.dtype == torch.bfloat16),
        stream,
    )
    build.check(err, "ragged_dot_wgrad")
    build.count_launch(ragged_dot_wgrad)
    return out


ragged_dot_wgrad.launches = 0


class _RaggedDot(torch.autograd.Function):
    """K6 forward; backward: K6 over (dout, rhs transposed) for lhs, K6w
    for rhs, each only where its input needs a gradient. Rows past the
    sum get a zero lhs gradient (K6 writes zeros there) and add nothing
    to rhs's."""

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
            dlhs = _k6(dout, rhs.transpose(1, 2).contiguous(), group_sizes)
        if ctx.needs_input_grad[1]:
            drhs = ragged_dot_wgrad(lhs, dout, group_sizes, rhs.shape[0])
        return dlhs, drhs, None
