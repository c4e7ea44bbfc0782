"""Baselines from the paper's evaluation (Section 5.1; port of
``repro/baselines``), built on the same substrate as UpLIF so comparisons
isolate the algorithmic differences (the B+Tree / ALEX / LIPP / DILI design
points). Each baseline is UpLIF minus specific paper contributions — see
each class docstring for the mapping.
"""
from repro_torch.baselines.indexes import AlexLike, BTreeLike, DILILike, LIPPLike

__all__ = ["BTreeLike", "AlexLike", "LIPPLike", "DILILike"]
