"""Build the port's parameter tree, and its optimizer state, from numpy
copies of another one.

The tree arrives as nested dicts of numpy arrays (for example
``np.asarray`` of each leaf of the JAX package's ``init_params``), with the
stacked ``layers`` leading axis; it keeps its structure and every leaf its
dtype. A bfloat16 leaf (numpy's ``ml_dtypes`` extension type, which torch
cannot read directly) is carried over through its 16-bit pattern. An
optimizer state arrives as its three fields (the JAX package's
``OptState``: m and v trees and the int32 step), so both packages can
start a step from the same state.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.ops import resolve_device


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy the tensor may own
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_numpy(tree, *, device=None):
    """The same tree with every leaf a tensor on ``device`` (``cuda`` unless
    the caller passes another), dtypes kept."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device=device)
                for k, v in tree.items()}
    return _tensor(tree, device)


def opt_state_from_numpy(m, v, step, *, device=None):
    """The port's ``OptState`` from numpy copies of an optimizer state's
    fields (for example ``np.asarray`` of each leaf of the JAX package's
    ``OptState``), on ``device`` (``cuda`` unless the caller passes
    another); the step is an int32 scalar."""
    from repro_torch.train.optimizer import OptState

    device = resolve_device(device)
    return OptState(m=params_from_numpy(m, device=device),
                    v=params_from_numpy(v, device=device),
                    step=_tensor(np.asarray(step, np.int32), device))
