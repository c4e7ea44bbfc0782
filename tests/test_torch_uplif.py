"""The port's UpLIF against the JAX UpLIF, op by op, on the CPU.

Both sides run the op tape of ``tests/test_locate_fused.py`` (drift-heavy
hotspot inserts, in-batch duplicates, tombstone revivals, value updates).
The contract is identity: lookup results, delete hit masks, range rows,
adjusted ranks and final live contents, and also the slot and BMAT arrays
byte for byte, because both sides do the same arithmetic. On the CPU the JAX fused strategy runs its
Pallas kernels in interpret mode and the port's runs the kernels' plain
torch versions.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401 — x64
from repro.core import UpLIF as JaxUpLIF
from repro.core.uplif import UpLIFConfig as JaxConfig
from repro_torch.core import UpLIF, UpLIFConfig
from repro_torch.core.convert import uplif_from_numpy
from repro_torch.core.types import KEY_MAX
from tests.test_locate_fused import _tape

REPO = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps the parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(idx):
    """Slot and BMAT arrays of either index, as numpy."""
    b = idx.bmat.state
    return [np.asarray(a) for a in (*idx.slots, b.keys, b.vals, b.fences,
                                    b.size)]


def _assert_same_arrays(a, b, what):
    for i, (x, y) in enumerate(zip(_arrays(a), _arrays(b))):
        assert x.dtype == y.dtype, f"{what}: array {i} dtype"
        np.testing.assert_array_equal(x, y, err_msg=f"{what}: array {i}")


def _range_bounds(base, ranges):
    """The tape's ranges plus sorted ranges over the loaded keys, and
    ranges past the domain, over everything, and inverted."""
    r = np.random.default_rng(7)
    starts = np.sort(r.choice(base, 12))
    lo = np.concatenate([[a for a, _ in ranges], starts,
                         [KEY_MAX - 5, 0, 9]])
    hi = np.concatenate([[b for _, b in ranges], starts + (1 << 44),
                         [KEY_MAX, KEY_MAX, 3]])
    return lo, hi


def _same_rows(a, b, what):
    """Two (keys, vals) lists of range rows, byte for byte."""
    assert len(a[0]) == len(b[0]), what
    for i, (x, y) in enumerate(zip(a[0] + a[1], b[0] + b[1])):
        assert np.asarray(x).dtype == np.asarray(y).dtype, f"{what}: row {i}"
        np.testing.assert_array_equal(x, y, err_msg=f"{what}: row {i}")


def _run_both(jidx, tidx, ops_tape, probes, bounds):
    """The tape through both indexes; after every op the lookups, range
    rows (``range_query_batch``, ``max_out`` 16 after the last op so rows
    are cut) and ``adjusted_predict`` ranks must agree, and the arrays."""
    lo, hi = bounds
    for step, op in enumerate(ops_tape):
        if op[0] == "insert":
            assert jidx.insert(op[1], op[2]) == tidx.insert(op[1], op[2])
        else:
            np.testing.assert_array_equal(
                np.asarray(jidx.delete(op[1])), tidx.delete(op[1]),
                err_msg=f"delete hits at op {step}",
            )
        fj, vj = jidx.lookup(probes)
        ft, vt = tidx.lookup(probes)
        np.testing.assert_array_equal(fj, ft, err_msg=f"found at op {step}")
        np.testing.assert_array_equal(vj, vt, err_msg=f"values at op {step}")
        max_out = 16 if step == len(ops_tape) - 1 else 256
        _same_rows(jidx.range_query_batch(lo, hi, max_out),
                   tidx.range_query_batch(lo, hi, max_out),
                   f"ranges at op {step}")
        aj = np.asarray(jidx.adjusted_predict(probes))
        at = tidx.adjusted_predict(probes)
        assert aj.dtype == at.dtype
        np.testing.assert_array_equal(aj, at, err_msg=f"ranks at op {step}")
        _assert_same_arrays(jidx, tidx, f"op {step}")
    for a, b in zip(lo[:3], hi[:3]):
        _same_rows([[x] for x in jidx.range_query(a, b, max_out=256)],
                   [[x] for x in tidx.range_query(a, b, max_out=256)],
                   "range_query")
    kj, vj = jidx.extract_live()
    kt, vt = tidx.extract_live()
    np.testing.assert_array_equal(kj, kt)
    np.testing.assert_array_equal(vj, vt)
    assert jidx.size == tidx.size
    assert jidx.measures() == tidx.measures()
    assert jidx.n_inplace == tidx.n_inplace
    assert jidx.memory_bytes() == tidx.memory_bytes()
    assert jidx.index_bytes() == tidx.index_bytes()


@pytest.mark.parametrize("kind", ["rbmat", "b+mat"])
@pytest.mark.parametrize("locate", ["fused", "spline", "binsearch"])
def test_tape_matches_jax(locate, kind):
    base, vals, ops_tape, probes, ranges = _tape(0)
    jidx = JaxUpLIF(base, vals, JaxConfig(locate=locate, bmat_type=kind))
    tidx = UpLIF(base, vals, UpLIFConfig(locate=locate, bmat_type=kind),
                 device="cpu")
    assert tidx.fstatic()._asdict() == jidx.fstatic()._asdict()
    _assert_same_arrays(jidx, tidx, "bulk load")
    _run_both(jidx, tidx, ops_tape, probes, _range_bounds(base, ranges))


@pytest.mark.parametrize("kind", ["rbmat", "b+mat"])
def test_fused_above_f32_bound_matches_jax(kind, monkeypatch):
    """Above the f32 position bound the JAX fused strategy falls back to
    its float64 spline path, while the port's keeps K1 and asks it for
    float64 interpolation. The bound is lowered below the test index's
    capacity; the port must still match the JAX index op by op."""
    from repro_torch.kernels import ops, spline_lookup

    monkeypatch.setattr(ops, "MAX_F32_POSITIONS", 1024)
    modes = []
    plain = spline_lookup.fused_locate_plain

    def spy(*a, **k):
        modes.append(k["interp64"])
        return plain(*a, **k)

    monkeypatch.setattr(spline_lookup, "fused_locate_plain", spy)
    base, vals, ops_tape, probes, ranges = _tape(0)
    jidx = JaxUpLIF(base, vals, JaxConfig(locate="spline", bmat_type=kind))
    tidx = UpLIF(base, vals, UpLIFConfig(locate="fused", bmat_type=kind),
                 device="cpu")
    assert tidx.capacity > ops.MAX_F32_POSITIONS
    _run_both(jidx, tidx, ops_tape, probes, _range_bounds(base, ranges))
    assert modes and all(modes)


def test_bulk_load_byte_identical():
    """The port's own bulk load builds the JAX index's arrays, byte for
    byte, and the converter carries a JAX-built index over unchanged."""
    base, vals, ops_tape, probes, ranges = _tape(1)
    cfg = dict(locate="fused", bmat_type="b+mat")
    jidx = JaxUpLIF(base, vals, JaxConfig(**cfg))
    tidx = UpLIF(base, vals, UpLIFConfig(**cfg), device="cpu")
    for a, b in zip(jidx.rs_model, tidx.rs_model):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert tuple(jidx.rs_static) == tuple(tidx.rs_static)
    assert jidx.alpha == tidx.alpha
    for a, b in zip(jidx._counters, tidx._counters):
        assert int(a) == int(b)
    _assert_same_arrays(jidx, tidx, "bulk load")

    leaves = lambda t: [np.asarray(a) for a in t]  # noqa: E731
    conv = uplif_from_numpy(
        leaves(jidx.slots), leaves(jidx.rs_model), leaves(jidx.bmat.state),
        leaves(jidx._counters), rs_static=tuple(jidx.rs_static),
        gmm=leaves(jidx.gmm), alpha=jidx.alpha, config=UpLIFConfig(**cfg),
        device="cpu",
    )
    _assert_same_arrays(jidx, conv, "converted")
    _run_both(jidx, conv, ops_tape, probes, _range_bounds(base, ranges))


def test_port_imports_no_jax():
    """``repro_torch`` and ``chip_smoke.py`` import neither JAX nor anything
    of the JAX package (checked in a fresh interpreter), the baselines, the
    agent, the pipeline, the gateway, the executor's pool, the LM substrate
    (``models``, ``configs``), ``ServeEngine``, the launch tooling
    (``launch.*``) and the partition specs included."""
    code = (
        "import importlib, importlib.util, pkgutil, sys\n"
        "import repro_torch\n"
        "import repro_torch.baselines, repro_torch.core.rl_agent\n"
        "import repro_torch.data.pipeline, repro_torch.serve\n"
        "import repro_torch.tuning.executor\n"
        "import repro_torch.models, repro_torch.configs\n"
        "from repro_torch.serve import ServeEngine\n"
        "import repro_torch.launch.mesh, repro_torch.launch.specs\n"
        "import repro_torch.launch.program_analysis, repro_torch.launch.dryrun\n"
        "import repro_torch.launch.roofline, repro_torch.launch.train\n"
        "import repro_torch.launch.serve, repro_torch.parallel.partition\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', 'chip_smoke.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print(sum(m.startswith('repro_torch') for m in sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 77  # every module was imported


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    keys = np.arange(1, 2000, 3, dtype=np.int64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        UpLIF(keys)
    idx = UpLIF(keys, device="cpu")
    assert idx.locate_strategy() == "spline"  # "auto" on the CPU
    f, v = idx.lookup(keys[:10])
    assert f.all() and np.array_equal(v, keys[:10])


def test_workload_runner_drives_port():
    from repro_torch.data import WorkloadRunner, make_dataset

    keys = make_dataset("wikits", 20_000)
    runner = WorkloadRunner(keys, init_frac=0.5, batch=512, seed=0)
    idx = UpLIF(runner.init_keys, runner.init_keys + 1,
                UpLIFConfig(locate="fused"), device="cpu")
    res = runner.run(idx, write_rate=0.5, seconds=60.0, max_ops=4096)
    assert res.ops >= 4096
    reads, _ = runner.next_batch(0.0)
    f, v = idx.lookup(reads)
    assert f.all() and np.array_equal(v, reads + 1)
    # run(agent=): a greedy agent that retrains from every state acts each
    # batch, on the port as on the JAX runner, leaving the same arrays
    from repro.core import rl_agent as jrl
    from repro.data import WorkloadRunner as JaxRunner
    from repro_torch.core import rl_agent

    agents = []
    for mod in (jrl, rl_agent):
        agent = mod.QLearningAgent()
        for s in np.ndindex(6, 5, 5, 5, 2):
            agent._q_row(s)[mod.A_RETRAIN] = 1.0
        agents.append(agent)
    jrun = JaxRunner(keys, init_frac=0.5, batch=512, seed=1)
    trun = WorkloadRunner(keys, init_frac=0.5, batch=512, seed=1)
    jidx = JaxUpLIF(jrun.init_keys, jrun.init_keys + 1, JaxConfig())
    tidx = UpLIF(trun.init_keys, trun.init_keys + 1, UpLIFConfig(),
                 device="cpu")
    jres = jrun.run(jidx, 0.5, seconds=600.0, max_ops=2048,
                    agent=agents[0], agent_every=1)
    tres = trun.run(tidx, 0.5, seconds=600.0, max_ops=2048,
                    agent=agents[1], agent_every=1)
    assert tres.ops == jres.ops
    assert tidx.n_retrains == jidx.n_retrains >= 4
    _assert_same_arrays(jidx, tidx, "run(agent=)")


@pytest.mark.parametrize("quantize", ["ceil", "round"])
def test_retrain_and_switch_match_jax(quantize):
    """Full retrain (a fixed D_update GMM, a fitted gap budget, either gap
    quantization), the BMAT switch and the modeled memory accounting leave
    the same index as the JAX shell's."""
    from repro.core.types import GMMState as JaxGMM
    import jax.numpy as jnp
    from repro_torch.core.types import GMMState

    base, vals, ops_tape, probes, ranges = _tape(1)
    cfg = dict(locate="fused", bmat_type="rbmat")
    jidx = JaxUpLIF(base, vals, JaxConfig(**cfg))
    tidx = UpLIF(base, vals, UpLIFConfig(**cfg), device="cpu")
    for op in ops_tape[:3]:
        for idx in (jidx, tidx):
            idx.insert(op[1], op[2]) if op[0] == "insert" else idx.delete(op[1])
    w, mu = np.array([0.5, 0.5]), np.array([float(base[10]), float(base[-10])])
    sd = np.array([1e9, 3e10])
    jidx.retrain_full(JaxGMM(*(jnp.asarray(a) for a in (w, mu, sd))),
                      alpha_target=0.4, gap_quantize=quantize)
    tidx.retrain_full(GMMState(*(torch.tensor(a) for a in (w, mu, sd))),
                      alpha_target=0.4, gap_quantize=quantize)
    assert jidx.bmat.size == tidx.bmat.size == 0
    assert jidx.alpha == tidx.alpha and jidx.n_retrains == tidx.n_retrains
    _assert_same_arrays(jidx, tidx, "retrain")
    for idx in (jidx, tidx):
        idx.switch_bmat_type()
    assert tidx.bmat.tree_type == jidx.bmat.tree_type == "b+mat"
    _run_both(jidx, tidx, ops_tape[3:], probes, _range_bounds(base, ranges))
    for modeled in (False, True):
        assert jidx.memory_bytes(modeled) == tidx.memory_bytes(modeled)
        assert jidx.index_bytes(modeled) == tidx.index_bytes(modeled)
    # the reservoir refit (fit_gmm) feeds the next default retrain
    for a, b in zip(jidx.refreshed_gmm(), tidx.refreshed_gmm()):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-9)
    # the BMAT rebuild packs exactly the given entries
    keys, kv = np.sort(probes[:300]), probes[:300] + 1
    jidx.bmat._rebuild(keys, kv)
    tidx.bmat._rebuild(keys, kv)
    _assert_same_arrays(jidx, tidx, "BMAT rebuild")
    # the subset retrain absorbs the rebuilt BMAT's densest bin as JAX's does
    assert tidx.retrain_subset() == jidx.retrain_subset()
    assert tidx.n_retrains == jidx.n_retrains
    _assert_same_arrays(jidx, tidx, "retrain_subset")
    for a, b in zip(jidx._counters, tidx._counters):
        assert int(a) == int(b)
