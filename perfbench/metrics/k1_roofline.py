"""K1 (the fused locate): its launch's bytes over 3.35 TB/s, over its
device time per launch, in %."""
from perfharness.roofline import share


def read(run):
    return share(run, "k1")
