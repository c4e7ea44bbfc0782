"""Median host time of the BMAT merge of one ``fops.insert`` call in the
final profiled stretch (program span ``fops.insert.merge``)."""
from perfharness.program import span_ms_p50


def read(run):
    return span_ms_p50(run, "fops.insert.merge")
