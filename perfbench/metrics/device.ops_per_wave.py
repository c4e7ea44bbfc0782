"""CUDA kernels in the profiled stretch, over the waves it held."""


def read(run):
    p = run.profile
    if p is None or p.short or not p.waves:
        return None
    return len(p.kernels()) / p.waves
