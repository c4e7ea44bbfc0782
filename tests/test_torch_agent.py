"""The port's baselines, RL agent and data pipeline against the JAX
package, on the CPU.

The contract is identity where the reference pins it: the four baselines,
the agent's applied actions (``retrain_subset`` at a small BMAT,
``retrain_full`` above 4096 keys, the BMAT switch), ``WorkloadRunner.run``
with an agent, and the ``PackedCorpus`` batches leave the same arrays and
answer the same lookups, byte for byte. The agent's Bellman update, policy
and state encoding equal the JAX agent's, and a Q-table the JAX agent
saved loads in the port with the same policy.
"""
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401 — x64
from repro import baselines as jbaselines
from repro.core import UpLIF as JaxUpLIF
from repro.core import rl_agent as jrl
from repro.core.uplif import UpLIFConfig as JaxConfig
from repro.data import WorkloadRunner as JaxRunner
from repro.data import make_dataset
from repro.data.pipeline import PackedCorpus as JaxCorpus
from repro.data.pipeline import PipelineConfig as JaxPipelineConfig
from repro_torch import baselines
from repro_torch.core import UpLIF, UpLIFConfig
from repro_torch.core import rl_agent
from repro_torch.data import WorkloadRunner
from repro_torch.data.pipeline import PackedCorpus, PipelineConfig
from tests.conftest import make_keys
from tests.test_torch_subset import _same_lookups
from tests.test_torch_uplif import _assert_same_arrays

CFG = dict(batch_bucket=256)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps the parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# baselines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["BTreeLike", "AlexLike", "LIPPLike",
                                  "DILILike"])
def test_baseline_matches_jax(name):
    """tests/test_system.py's baseline case through both packages: the same
    lookups, inserts, arrays and index bytes."""
    keys = make_keys(5000, 41)
    jidx = getattr(jbaselines, name)(keys, keys * 2, JaxConfig(**CFG))
    tidx = getattr(baselines, name)(keys, keys * 2, UpLIFConfig(**CFG),
                                    device="cpu")
    assert tidx.locate_strategy() == jidx.locate_strategy()
    if name == "BTreeLike":
        assert tidx.locate_strategy() == "binsearch"
        assert tidx.fstatic().rs_iters == 0
    _assert_same_arrays(jidx, tidx, f"{name} bulk load")
    f, v = _same_lookups(jidx, tidx, keys)
    assert f.all() and np.array_equal(v, keys * 2)
    r = np.random.default_rng(42)
    new = np.setdiff1d(r.integers(0, 1 << 48, 2000).astype(np.int64), keys)
    r.shuffle(new)
    assert jidx.insert(new, new + 1) == tidx.insert(new, new + 1)
    assert jidx.n_retrains == tidx.n_retrains
    _assert_same_arrays(jidx, tidx, f"{name} insert")
    f, v = _same_lookups(jidx, tidx, new)
    assert f.all() and np.array_equal(v, new + 1)
    f, _ = _same_lookups(jidx, tidx, keys)
    assert f.all()
    assert jidx.index_bytes() == tidx.index_bytes()


# ---------------------------------------------------------------------------
# the RL agent
# ---------------------------------------------------------------------------


def test_rl_agent_bellman_and_policy():
    """tests/test_system.py's Bellman case, and a run of updates, rewards
    and explored choices: the same Q-table, epsilon and policy as JAX's."""
    ja = jrl.QLearningAgent(jrl.AgentConfig(alpha=0.5, gamma=0.5, epsilon=0.0))
    ta = rl_agent.QLearningAgent(
        rl_agent.AgentConfig(alpha=0.5, gamma=0.5, epsilon=0.0))
    s0, s1 = (1, 0, 0, 0, 1), (2, 0, 0, 0, 1)
    for a in (ja, ta):
        a._q_row(s1)[rl_agent.A_KEEP] = 2.0
        a.update(s0, rl_agent.A_RETRAIN, 1.0, s1)
    assert abs(ta.q[s0][rl_agent.A_RETRAIN] - 1.0) < 1e-9
    assert ta.policy() == ja.policy()
    assert ta.policy()[s0] == rl_agent.A_RETRAIN
    # a seeded run: exploration draws, rewards and updates stay in step
    ja, ta = jrl.QLearningAgent(), rl_agent.QLearningAgent()
    r = np.random.default_rng(3)
    for step in range(40):
        s = tuple(int(x) for x in r.integers(0, 3, 5))
        s_next = tuple(int(x) for x in r.integers(0, 3, 5))
        tput, mem = float(r.uniform(1e5, 1e6)), float(r.uniform(1e3, 1e6))
        a = ja.choose(s)
        assert ta.choose(s) == a
        rew = ja.reward(tput, mem)
        assert ta.reward(tput, mem) == rew
        ja.update(s, a, rew, s_next)
        ta.update(s, a, rew, s_next)
    assert ja.epsilon == ta.epsilon
    assert ja.q.keys() == ta.q.keys()
    for k in ja.q:
        np.testing.assert_array_equal(ja.q[k], ta.q[k])
    assert ja.policy() == ta.policy()


@pytest.mark.parametrize("n_new", [3000, 12000])
def test_rl_agent_actions_apply_match_jax(n_new):
    """tests/test_system.py's action case: A_SWITCH, then A_RETRAIN — a
    subset retrain at a BMAT of at most 4096 keys, a full retrain above —
    leave the same arrays as the JAX agent's actions."""
    keys = make_keys(4000, 43)
    jidx = JaxUpLIF(keys, keys, JaxConfig(**CFG))
    tidx = UpLIF(keys, keys, UpLIFConfig(**CFG), device="cpu")
    r = np.random.default_rng(44)
    new = np.setdiff1d(r.integers(0, 1 << 48, n_new).astype(np.int64), keys)
    for idx in (jidx, tidx):
        idx.insert(new, new)
    big = tidx.bmat.size > 4096
    assert big == (n_new > 4096)
    ja, ta = jrl.QLearningAgent(), rl_agent.QLearningAgent()
    t0 = tidx.bmat.tree_type
    ja.apply_action(jidx, jrl.A_SWITCH)
    ta.apply_action(tidx, rl_agent.A_SWITCH)
    assert tidx.bmat.tree_type == jidx.bmat.tree_type != t0
    ja.apply_action(jidx, jrl.A_RETRAIN)
    ta.apply_action(tidx, rl_agent.A_RETRAIN)
    assert tidx.n_retrains == jidx.n_retrains == 1
    assert (tidx.bmat.size == 0) == big
    _assert_same_arrays(jidx, tidx, f"A_RETRAIN at {n_new}")
    f, _ = _same_lookups(jidx, tidx, new)
    assert f.all()
    ja.apply_action(jidx, jrl.A_KEEP)
    ta.apply_action(tidx, rl_agent.A_KEEP)
    _assert_same_arrays(jidx, tidx, "A_KEEP")


def test_encode_state_buckets():
    """tests/test_system.py's encoding case, the bucket edges, and the
    measures of live indexes: the same state tuples as JAX's."""
    m = {"bmat_height": 13, "granularity": 10**7, "error_scaling": 1.5,
         "n_models": 2000, "bmat_type": "b+mat"}
    s = rl_agent.encode_state(m)
    assert len(s) == 5 and s[4] == 1 and s == jrl.encode_state(m)
    for h, g, e, n_m, t in [(0, 0, 0.0, 0, "rbmat"),
                            (4, 10**3, 0.5, 256, "b+mat"),
                            (21, 10**16, 9.0, 20000, "rbmat"),
                            (8, 2**63 - 1, 1.0, 4096, "b+mat")]:
        m = {"bmat_height": h, "granularity": g, "error_scaling": e,
             "n_models": n_m, "bmat_type": t}
        assert rl_agent.encode_state(m) == jrl.encode_state(m)
    keys = make_keys(3000, 45)
    jidx = JaxUpLIF(keys, keys, JaxConfig(**CFG))
    tidx = UpLIF(keys, keys, UpLIFConfig(**CFG), device="cpu")
    assert tidx.measures() == jidx.measures()
    assert (rl_agent.encode_state(tidx.measures())
            == jrl.encode_state(jidx.measures()))


def _forcing_qtable(tmp_path):
    """A Q-table, saved by the JAX agent, whose greedy policy switches a
    B+MAT index to an RBMAT and retrains an RBMAT index, from any state."""
    ja = jrl.QLearningAgent()
    for s in np.ndindex(6, 5, 5, 5, 2):
        ja._q_row(s)[jrl.A_RETRAIN if s[4] == 0 else jrl.A_SWITCH] = 1.0
    path = str(tmp_path / "q.npz")
    ja.save(path)
    return path, ja


def test_qtable_saved_by_jax_loads_in_port(tmp_path):
    path, ja = _forcing_qtable(tmp_path)
    ta = rl_agent.QLearningAgent.load(path)
    jl = jrl.QLearningAgent.load(path)
    assert ta.q.keys() == ja.q.keys() == jl.q.keys()
    for k in ja.q:
        np.testing.assert_array_equal(ta.q[k], ja.q[k])
        assert ta.q[k].dtype == np.float64
    assert ta.policy() == ja.policy() == jl.policy()
    for s in ja.q:
        assert ta.choose(s, explore=False) == ja.choose(s, explore=False)
    # and back: the port's save loads in the JAX agent
    path2 = str(tmp_path / "q2.npz")
    ta.save(path2)
    assert jrl.QLearningAgent.load(path2).policy() == ja.policy()


def test_workload_runner_determinism_and_agent_hook(tmp_path):
    """tests/test_system.py's runner case, then ``run(agent=)``: a greedy
    agent loaded from a JAX Q-table acts every 2 batches on both indexes;
    the batches, results and arrays equal JAX's."""
    keys = make_dataset("logn", 10_000)
    r1, r2 = JaxRunner(keys, seed=3), WorkloadRunner(keys, seed=3)
    for _ in range(3):
        a, b = r1.next_batch(0.5), r2.next_batch(0.5)
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])

    keys = make_dataset("wikits", 20_000)
    jr = JaxRunner(keys, init_frac=0.5, batch=512, seed=0)
    tr = WorkloadRunner(keys, init_frac=0.5, batch=512, seed=0)
    jidx = JaxUpLIF(jr.init_keys, jr.init_keys + 1, JaxConfig(**CFG))
    tidx = UpLIF(tr.init_keys, tr.init_keys + 1, UpLIFConfig(**CFG),
                 device="cpu")
    path, _ = _forcing_qtable(tmp_path)
    jres = jr.run(jidx, 0.5, seconds=600.0, max_ops=4096,
                  agent=jrl.QLearningAgent.load(path), agent_every=2)
    tres = tr.run(tidx, 0.5, seconds=600.0, max_ops=4096,
                  agent=rl_agent.QLearningAgent.load(path), agent_every=2)
    assert tres.ops == jres.ops >= 4096
    assert tidx.bmat.tree_type == jidx.bmat.tree_type != "b+mat"
    assert tidx.n_retrains == jidx.n_retrains >= 1
    assert tres.index_bytes == jres.index_bytes
    assert tres.extra == jres.extra
    _assert_same_arrays(jidx, tidx, "run(agent=)")
    reads, _ = tr.next_batch(0.0)
    f, v = _same_lookups(jidx, tidx, reads)
    assert f.all() and np.array_equal(v, reads + 1)


# ---------------------------------------------------------------------------
# the data pipeline
# ---------------------------------------------------------------------------


def test_pipeline_matches_jax():
    """tests/test_system.py's pipeline case through both packages: batches,
    doc tokens, the index's arrays and retirement equal JAX's."""
    jc = JaxCorpus(JaxPipelineConfig(n_docs=512, seed=1, global_batch=8))
    tc = PackedCorpus(PipelineConfig(n_docs=512, seed=1, global_batch=8),
                      device="cpu")
    np.testing.assert_array_equal(jc.doc_ids, tc.doc_ids)
    np.testing.assert_array_equal(jc.tokens, tc.tokens)
    _assert_same_arrays(jc.index, tc.index, "corpus index")
    for step in (0, 1, 17):
        b = tc.batch(step)
        assert b["tokens"].shape == (8, 1024)
        np.testing.assert_array_equal(b["tokens"], jc.batch(step)["tokens"])
    np.testing.assert_array_equal(tc.batch(0)["tokens"],
                                  tc.batch(0)["tokens"])  # restart-safe
    ids = tc.add_shard(7, 128)
    np.testing.assert_array_equal(jc.add_shard(7, 128), ids)
    toks = tc.doc_tokens(ids[:4], 64)
    assert toks.shape == (4, 64)
    np.testing.assert_array_equal(toks, jc.doc_tokens(ids[:4], 64))
    for c in (jc, tc):
        c.retire_docs(ids[:64])
    np.testing.assert_array_equal(jc.doc_ids, tc.doc_ids)
    _assert_same_arrays(jc.index, tc.index, "after retirement")
    f, _ = tc.index.lookup(ids[:64])
    assert not f.any()
    np.testing.assert_array_equal(tc.batch(5)["tokens"],
                                  jc.batch(5)["tokens"])
    with pytest.raises(KeyError):
        tc.doc_tokens(ids[:2], 8)
