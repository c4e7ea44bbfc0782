"""Build the port's parameter tree from numpy copies of another one.

The tree arrives as nested dicts of numpy arrays (for example
``np.asarray`` of each leaf of the JAX package's ``init_params``), with the
stacked ``layers`` leading axis; it keeps its structure and every leaf its
dtype. A bfloat16 leaf (numpy's ``ml_dtypes`` extension type, which torch
cannot read directly) is carried over through its 16-bit pattern.
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
