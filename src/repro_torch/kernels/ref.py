"""Plain torch key comparisons shared by the kernels' plain versions (port
of ``key_leq``/``key_lt`` in ``repro/kernels/ref.py``).

The JAX package compares keys as (hi:int32, lo:uint32) pairs because the
TPU vector unit has no int64. Native int64 order is the same order for the
non-negative key domain and for the KEY_MAX padding, so the port compares
int64 keys directly, on the CPU and in the CUDA kernels alike.
"""
from __future__ import annotations

import torch


def key_leq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a <= b on int64 keys."""
    return a <= b


def key_lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b on int64 keys."""
    return a < b
