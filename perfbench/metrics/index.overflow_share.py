"""Keys the inserts of the final profiled stretch sent to the BMAT, over
the keys they were given, in % (program counters ``insert.overflow`` and
``insert.keys``)."""
from perfharness.program import total


def read(run):
    keys = total(run, "insert.keys")
    if not keys:
        return None
    return 100.0 * total(run, "insert.overflow") / keys
