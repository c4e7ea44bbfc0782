"""The check fails what it must: each fault a cell can have, planted in
the program's timed path underneath a whole run on the CPU (the look for
a card skipped), and the control (the reference with float32 keys put in
the program's place) come out not correct; the same runs unbroken come
out correct."""
import pytest
import perfbench_testlib as t

from perfharness import faults, systems

CELLS = ["uplif-wikits-16m.read_heavy", "uplif-wikits-16m.read_only"]
# a read-only cell writes nothing: its inserts cannot be broken
CASES = [(c, f) for c in CELLS for f in faults.FAULTS
         if not (c.endswith("read_only") and f == "unchanged")]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    out = t.run_small(cell, 0.6)
    assert out["correct"], out["check"]
    assert all(v["value"] == 0 for k, v in out["check"].items()
               if "limit" in v)


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_planted_fault_is_not_correct(cell, fault):
    with faults.plant(fault):
        out = t.run_small(cell, 0.6)
    assert not out["correct"], (fault, out["check"])
    assert any(v["value"] > v["limit"] for v in out["check"].values()
               if "limit" in v)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    out = t.run_small(cell, 0.6, factory=systems.Control)
    assert not out["correct"], out["check"]
    assert out["check"]["contents_wrong"]["value"] > 0
