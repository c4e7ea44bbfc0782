"""Median time of one ``UpLIF.insert`` call of a wave, to its synchronised
result (harness span ``index.insert``)."""
from perfharness.readers import span_pct


def read(run):
    return span_pct(run, "index.insert", 50)
