"""Share of the profiled stretch in which no kernel or copy ran, in %."""
from perfharness.readers import idle_share


def read(run):
    return idle_share(run)
