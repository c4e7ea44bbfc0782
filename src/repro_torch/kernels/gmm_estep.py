"""K3 — the GMM E-step kernel.

Replaces the TPU kernel ``gmm_estep_pallas``
(``src/repro/kernels/gmm_estep.py``): the dense (N, K) float32
responsibilities ``softmax_k(log w - z^2/2 - log sd)``, ``z = (x - mu)/sd``,
that the streaming D_update forecaster (``tuning/forecast.py``) computes on
every wave with inserts.

The CUDA source is ``csrc/gmm_estep.cu``; its header says what bounds it on
the H100 (the launch, at the forecaster's sizes, and each thread's serial
work inside it) and how it rounds. A sample gets a group of
``next_pow2(K)`` lanes, one component each (above K = 32 a warp, lane l
taking components l, l + 32, ...): every lane takes the logs of its own
parameters, the max is a butterfly over the group, and the sum adds the K
exponentials in component order, so the kernel rounds exactly as a
one-thread-per-sample loop does, for any K. ``gmm_estep`` below launches
it for CUDA tensors and runs ``ref.gmm_estep_plain`` for CPU tensors;
``gmm_estep.launches`` counts the CUDA launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import gmm_estep_plain


def gmm_estep(x, weights, means, stds):
    """K3: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors. ``x`` float32 [N]; ``weights``/``means``/``stds`` float32 [K]
    with K >= 1. Returns float32 [N, K]."""
    if x.device.type == "cpu":
        return gmm_estep_plain(x, weights, means, stds)
    if x.device.type != "cuda":
        raise ValueError(f"no GMM E-step kernel for {x.device}")
    k = weights.shape[0]
    if k < 1:
        raise ValueError("the E-step kernel needs at least one component")
    for name, t, n in (("x", x, x.shape[0]), ("weights", weights, k),
                       ("means", means, k), ("stds", stds, k)):
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {x.device}")
        if t.dim() != 1 or t.shape[0] != n or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D tensor of "
                             f"length {n}")
    n = x.shape[0]
    out = torch.empty((n, k), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = build.library().gmm_estep_launch(
        x.data_ptr(), weights.data_ptr(), means.data_ptr(), stds.data_ptr(),
        out.data_ptr(), n, k, stream,
    )
    build.check(err, "gmm_estep")
    build.count_launch(gmm_estep)
    return out


gmm_estep.launches = 0
