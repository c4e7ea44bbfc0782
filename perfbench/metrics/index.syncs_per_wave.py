"""The program's host waits for the card in the final profiled stretch,
over the waves it held (program counter ``host_syncs``: blocking copies
to the card, reads back, reads of a device scalar)."""
from perfharness.program import total


def read(run):
    n = total(run, "host_syncs")
    if n is None or not run.profile.waves:
        return None
    return n / run.profile.waves
