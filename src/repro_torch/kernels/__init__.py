"""Hand-written Hopper kernels of the port and their plain torch versions.

K1 ``spline_lookup.fused_locate``, K2 ``bmat_rank.bmat_rank``, K3
``gmm_estep.gmm_estep``, K4 ``tile_search.tile_search``, K5
``spline_lookup.spline_lookup``, K6 ``ragged_dot.ragged_dot`` (the MoE
layer's grouped matrix product), K7 ``window_insert.window_insert`` (the
insert's Movement round) and K8 ``spline_corridor.spline_corridor`` (the
spline build's knots) launch CUDA C++ kernels (``csrc/``, built
for ``sm_90a`` at first use by ``build.py``) on CUDA tensors and run their
plain versions on CPU tensors. ``ops`` holds the adapters the index calls
and the kernel-level predict/search/rank API.
"""
from repro_torch.kernels import ops, ref  # noqa: F401
