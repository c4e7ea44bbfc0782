"""Hand-written Hopper kernels of the port and their plain torch versions.

K1 ``spline_lookup.fused_locate``, K2 ``bmat_rank.bmat_rank`` and K3
``gmm_estep.gmm_estep`` launch CUDA C++ kernels (``csrc/``, built for
``sm_90a`` at first use by ``build.py``) on CUDA tensors and run their
plain versions on CPU tensors.
"""
