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
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ragged_dot_plain

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
    version for CPU tensors."""
    if lhs.device.type == "cpu":
        return ragged_dot_plain(lhs, rhs, group_sizes)
    if lhs.device.type != "cuda":
        raise ValueError(f"no ragged_dot kernel for {lhs.device}")
    if lhs.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"K6 takes float32 or bfloat16, got {lhs.dtype}")
    if lhs.dim() != 2 or rhs.dim() != 3 or group_sizes.dim() != 1:
        raise ValueError("K6 takes lhs [M, K], rhs [G, K, N] and "
                         "group_sizes [G]")
    m, k = lhs.shape
    g, k2, n = rhs.shape
    if k2 != k or group_sizes.shape[0] != g:
        raise ValueError(f"K6: lhs {tuple(lhs.shape)}, rhs "
                         f"{tuple(rhs.shape)} and group_sizes "
                         f"{tuple(group_sizes.shape)} do not fit")
    if rhs.dtype != lhs.dtype or group_sizes.dtype != torch.int32:
        raise ValueError("K6: rhs must have lhs's dtype and group_sizes "
                         "must be int32")
    for name, t in (("rhs", rhs), ("group_sizes", group_sizes)):
        if t.device != lhs.device:
            raise ValueError(f"K6: {name} is on {t.device}, lhs on "
                             f"{lhs.device}")
    for name, t in (("lhs", lhs), ("rhs", rhs),
                    ("group_sizes", group_sizes)):
        if not t.is_contiguous():
            raise ValueError(f"K6: {name} must be contiguous")
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
