"""Median host time of the in-place part of one ``fops.insert`` call in
the final profiled stretch: the slot copies, the dedup and the Movement
rounds (program span ``fops.insert.place``)."""
from perfharness.program import span_ms_p50


def read(run):
    return span_ms_p50(run, "fops.insert.place")
