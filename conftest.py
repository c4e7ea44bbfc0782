"""The readers of the port's own spans and counters, in the benchmark's
reader test.

``perfbench/tests/test_perfbench_readers.py`` asks every reader under
``perfbench/metrics/`` for its value over one synthetic traced run
(``_profile()``: two lookup waves), from its ``EXPECTED``. The readers
built on ``perfbench/perfharness/program.py`` also read the program's
tracer (``repro_torch.tracing``). For each test of that file, this fixture
records the program's spans of those two waves into the tracer, after an
insert of an earlier stretch, gives those readers' values beside the
file's own, and empties the tracer afterwards. The read-heavy case is in
``perfbench/tests/test_perfbench_program.py``.
"""
import pytest

PROGRAM_EXPECTED = {
    # two lookups, three host syncs each
    "index.syncs_per_wave": 3.0,
    # idle inside the dispatch spans: 5 + 7 + 3 ms, 5 + 12 ms, of 87 ms
    "device.idle_in_dispatch_share": 100 * 0.032 / 0.087,
    # the stretch held no insert (the earlier stretch's is not read)
    "index.insert_place_ms_p50": None,
    "index.insert_merge_ms_p50": None,
    "index.overflow_share": None,
}


@pytest.fixture(autouse=True)
def _program_trace_for_readers(request, monkeypatch):
    if request.module.__name__.rsplit(".", 1)[-1] != "test_perfbench_readers":
        yield
        return
    from program_trace import insert_call, lookup_call, play
    from repro_torch import tracing

    for name, value in PROGRAM_EXPECTED.items():
        monkeypatch.setitem(request.module.EXPECTED, name, value)
    tracing.reset()
    play([insert_call(0.5, 0.010, 0.004, 400, 100), lookup_call(1.0),
          lookup_call(2.0)])
    yield
    tracing.reset()
