"""Operations finished in a traced run's window over its seconds, the
profiled stretch included: ``ops_per_s`` of the read-heavy cell, per
layer, where its runs spread too widely for an end-to-end bound."""


def read(run):
    if not run.ops or run.window_s <= 0:
        return None
    return run.ops / run.window_s
