"""Share of the final profiled stretch's idle device seconds that fall
inside the program's dispatch spans (``fops.*``), where the host issues
the op suite's small operations one by one, in %."""
from perfharness.program import idle_in_spans_share


def read(run):
    return idle_in_spans_share(run, "fops.")
