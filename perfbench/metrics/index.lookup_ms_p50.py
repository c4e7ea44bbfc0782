"""Median time of one ``UpLIF.lookup`` call of a wave, to its synchronised
result (harness span ``index.lookup``)."""
from perfharness.readers import span_pct


def read(run):
    return span_pct(run, "index.lookup", 50)
