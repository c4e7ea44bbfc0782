"""``run.py`` without a card, and the benchmark's imports."""
import ast
import os
import subprocess
import sys

import pytest
import perfbench_testlib  # noqa: F401 — the import paths

ROOT = perfbench_testlib.ROOT
BENCH_DIR = perfbench_testlib.BENCH_DIR
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _cuda() -> bool:
    import torch
    return torch.cuda.is_available()


def test_run_fails_plainly_without_a_card():
    if _cuda():
        pytest.skip("a CUDA card is present")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    p = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "uplif-wikits-16m.read_only", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    assert p.returncode == 2
    assert p.stdout.strip() == ""
    assert "no CUDA card" in p.stderr


def test_run_names_an_unknown_cell():
    p = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "no.such.cell",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode == 2 and p.stdout.strip() == ""
    assert "no cell 'no.such.cell'" in p.stderr


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    """Top-level names compared whole: ``repro_torch`` is the port."""
    files = sorted(BENCH_DIR.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_the_look_at_loaded_modules_compares_top_level_names_whole():
    from perfharness.cell import forbidden_modules

    assert forbidden_modules(["repro_torch.core", "numpy", "jax_like",
                              "reproduce"]) == []
    assert forbidden_modules(["repro.core.fops", "jaxlib.xla_client",
                              "repro_torch", "flax"]) == [
        "flax", "jaxlib", "repro"]


def test_the_reference_imports_nothing_of_the_program():
    names = {n.split(".")[0] for n in _imports(BENCH_DIR / "reference.py")}
    assert names <= {"__future__", "numpy"}


def test_a_run_loads_no_jax(tmp_path):
    """A whole run on the CPU, in a process of its own: no JAX module and
    no module of the JAX package is loaded once its window has closed."""
    code = (
        "import sys, time; sys.path[:0] = [%r, %r]\n"
        "import perfbench_testlib as t\n"
        "out = t.run_small('uplif-wikits-16m.read_heavy', 0.5)\n"
        "assert out['correct'], out['check']\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(tops & {'jax', 'jaxlib', 'flax', 'repro'}))\n"
    ) % (str(BENCH_DIR / "tests"), str(BENCH_DIR))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.split("\n")[0] == "[]"


@pytest.mark.parametrize("memory_wave,seconds", [(4, 0.0), (1, 0.3)])
def test_memory_is_read_after_the_same_wave_whatever_the_window(
        memory_wave, seconds, monkeypatch):
    """``bytes_per_key`` is read after the window's ``MEMORY_WAVE``-th wave,
    inside the window or driven past a window that held fewer, so that
    every run reads it after the same operations."""
    import torch

    from perfharness import cell, spec, systems
    from perfharness.trace import Recorder

    waves = spec.loop("waves")
    monkeypatch.setattr(waves, "MEMORY_WAVE", memory_wave)
    c = perfbench_testlib.small_cell("uplif-wikits-16m.read_heavy")
    warmup = int(c.traffic["warmup_waves"])
    r = waves.Run(c, 5, "cpu", Recorder(False),
                  cell._Device(torch, "cpu"), systems.build)
    w = r.window(seconds, None, 1.0, False)
    assert (w["waves"] == 0) == (seconds == 0.0)
    assert r.memory[1] == 2 * (warmup + memory_wave)
    assert r.seq >= warmup + memory_wave
