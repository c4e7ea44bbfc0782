"""The port's ``ServeEngine`` against the JAX one, on the CPU (and on the
card where marked).

Both engines serve the smoke ``deepseek-7b`` at float32 compute with the
same weights (a numpy tree from a seed) and no tuner, unless a case says
otherwise; the ``serve_lm`` waves, the consistency case, the aliasing case
and the cold-hit case also serve the two MoE families
(``qwen3-moe-30b-a3b``: GQA and MoE; ``deepseek-v2-236b``: MLA and MoE),
the two recurrent ones (``recurrentgemma-2b``: RG-LRU and a local-window
ring; ``rwkv6-1-6b``) and the encoder-decoder (``whisper-small``, whose
cross K/V stay zero in both engines). Greedy tokens are compared exactly.

Two departures of the port are pinned here (``ROADMAP.md`` §3):
- the port clones a decode cache when it admits it and when a hit takes it,
  because its ``decode_step`` writes its tensors in place: a stored cache
  is never written by a later decode
  (``test_stored_cache_is_never_written``);
- a hit resumes at the matched prefix, not at the stored prompt's length,
  so where the reference reuses another prompt's tokens the port's output
  equals a cold run (``test_hit_past_the_matched_prefix_decodes_cold``);
  for a recurrent state, which cannot be cut back, from the snapshot the
  prefill kept before the last matched token
  (``test_recurrent_hit_resumes_from_a_snapshot``). Where every hit's
  stored prompt is exactly the matched prefix, the tokens are the
  reference's.

Every join here has a timeout, and running into it fails the test.
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401 — x64, as in the full system
import jax
import jax.numpy as jnp
from repro.configs import smoke_config as jsmoke
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs import smoke_config
from repro_torch.kernels import ops
from repro_torch.models import params_from_numpy
from repro_torch.serve import Request, ServeEngine
from tests.test_torch_models import numpy_params

JOIN_S = 60.0
MAX_LEN = 128
# the dense model, the two MoE families (GQA + MoE, MLA + MoE), the two
# recurrent ones and the encoder-decoder
ARCHS = ["deepseek-7b", "qwen3-moe-30b-a3b", "deepseek-v2-236b",
         "recurrentgemma-2b", "rwkv6-1-6b", "whisper-small"]
RECURRENT = ["recurrentgemma-2b", "rwkv6-1-6b"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def model(request):
    """(JAX cfg, JAX params, port cfg, numpy params, jitted JAX steps by
    cache size) of a smoke config at float32 compute: deepseek-7b, or the
    arch a test passes as the fixture's parameter."""
    arch = getattr(request, "param", "deepseek-7b")
    jc = dataclasses.replace(jsmoke(arch), compute_dtype="float32")
    tc = dataclasses.replace(smoke_config(arch), compute_dtype="float32")
    npp = numpy_params(tc)
    return jc, jax.tree_util.tree_map(jnp.asarray, npp), tc, npp, {}


def _jax_engine(model, max_len=MAX_LEN):
    """A fresh JAX engine (empty prefix index, no tuner). Engines of one
    cache size share one jitted decode step, so each compiles once."""
    jc, jp, _, _, steps = model
    eng = JEngine(jc, jp, max_len=max_len, tuner=None)
    eng._decode = steps.setdefault(max_len, eng._decode)
    return eng


def _port_engine(model, device="cpu", max_len=MAX_LEN, **kw):
    _, _, tc, npp, _ = model
    kw.setdefault("tuner", None)
    return ServeEngine(tc, params_from_numpy(npp, device=device),
                       max_len=max_len, device=device, **kw)


def _serve(eng, req_cls, prompts, n_new):
    """One wave; returns the outputs and (hits, misses) after it."""
    done = eng.generate([req_cls(i, p, n_new) for i, p in enumerate(prompts)])
    return [r.out for r in done], (eng.prefix_index.hits,
                                   eng.prefix_index.misses)


def _cold(make, req_cls, prompt, n_new):
    """The tokens of ``prompt`` on a fresh engine."""
    eng = make()
    try:
        return _serve(eng, req_cls, [prompt], n_new)[0][0]
    finally:
        eng.close()


def _serve_lm_waves(vocab):
    """``examples/serve_lm.py``'s waves: a 48-token prompt twice, then
    three requests of that prompt plus 16 fresh tokens each."""
    rng = np.random.default_rng(0)
    base = rng.integers(0, vocab, 48).astype(np.int32)
    return [[base, base],
            [np.concatenate([base, rng.integers(0, vocab, 16)
                             .astype(np.int32)]) for _ in range(3)]]


@pytest.mark.parametrize("model", ARCHS, indirect=True)
def test_serve_lm_waves_match_jax(model):
    """Hits and misses equal the reference's after each wave, and so do the
    tokens of every request whose hit resumes at the stored prompt's full
    length. Requests 11 and 12 hit request 10's 64-token slot on 3 matched
    blocks: the reference resumes at 64 with request 10's logits and
    repeats its tokens; the port decodes their own tails and gives their
    cold runs' tokens."""
    vocab = model[0].vocab
    waves = _serve_lm_waves(vocab)
    jeng = _jax_engine(model, max_len=256)
    teng = _port_engine(model, max_len=256)
    outs = []
    for wave in waves:
        j, jcounts = _serve(jeng, JRequest, wave, 8)
        t, tcounts = _serve(teng, Request, wave, 8)
        assert tcounts == jcounts
        outs.append((j, t))
    assert tcounts == jcounts == (4, 1)
    (j0, t0), (j1, t1) = outs
    assert t0 == j0 and t0[0] == t0[1]
    assert t1[0] == j1[0]
    assert j1[1] == j1[2] == j1[0]  # the reference's quirk
    for i in (1, 2):
        cold_j = _cold(lambda: _jax_engine(model, 256), JRequest,
                       waves[1][i], 8)
        cold_t = _cold(lambda: _port_engine(model, max_len=256), Request,
                       waves[1][i], 8)
        assert t1[i] == cold_t == cold_j != j1[i]
    teng.close()


@pytest.mark.parametrize("model", ARCHS, indirect=True)
def test_prefix_cache_consistency_matches_jax(model):
    """``tests/test_system.py::test_serve_engine_prefix_cache_consistency``
    on both engines: a 40-token prompt, cold and then a hit (the port
    resumes at 32, or at 31 from a snapshot, the reference at 40), the
    same tokens everywhere."""
    prompt = np.random.default_rng(9).integers(0, model[0].vocab, 40)
    prompt = prompt.astype(np.int32)
    jeng, teng = _jax_engine(model), _port_engine(model)
    for rid in range(2):
        [j] = jeng.generate([JRequest(rid, prompt, max_new_tokens=5)])
        [t] = teng.generate([Request(rid, prompt, max_new_tokens=5)])
        assert t.out == j.out
        assert (teng.prefix_index.hits, teng.prefix_index.misses) == (
            jeng.prefix_index.hits, jeng.prefix_index.misses) == (rid, 1)
    teng.close()


def _slot_tensors(slot):
    """The tensors a stored slot holds: a cache's, or its snapshots'."""
    caches = slot if isinstance(slot, list) else [slot]
    return [x for c in caches for field in c if field
            for k, x in field.items() if k != "len"]


@pytest.mark.parametrize("device", ["cpu", pytest.param(
    "cuda", marks=pytest.mark.gpu)])
@pytest.mark.parametrize("model", ARCHS, indirect=True)
def test_stored_cache_is_never_written(model, device, request):
    """A (32 tokens) is admitted; B = A + 16 tokens hits A and extends it;
    C = A + 16 other tokens hits on A's two blocks and decodes its own tail
    from position 32 (31 from A's snapshot); then B again. Were the stored
    caches or snapshots shared with the live one, C's tail would overwrite
    what B's slot relies on (A's, for a snapshot), and B's second run or
    C's would read it. Every stored tensor keeps its value after it is
    admitted; B's second output equals its first and the JAX engine's, and
    C's equals its cold run's."""
    if device == "cuda":
        request.getfixturevalue("cuda")
    rng = np.random.default_rng(21)
    vocab = model[0].vocab
    a = rng.integers(0, vocab, 32).astype(np.int32)
    b = np.concatenate([a, rng.integers(0, vocab, 16).astype(np.int32)])
    c = np.concatenate([a, rng.integers(0, vocab, 16).astype(np.int32)])
    teng = _port_engine(model, device=device)
    outs, kept = [], []
    for p in (a, b, c, b):
        outs.append(_serve(teng, Request, [p], 6)[0][0])
        for sid, slot in teng.prefix_index.slots.items():
            if sid >= len(kept):
                kept.append([x.clone() for x in _slot_tensors(slot)])
    assert (teng.prefix_index.hits, teng.prefix_index.misses) == (3, 1)
    assert outs[3] == outs[1]
    slots = list(teng.prefix_index.slots.values())
    for slot, copy in zip(slots, kept):
        assert all(torch.equal(x, y) for x, y in
                   zip(_slot_tensors(slot), copy))
    assert outs[2] == _cold(lambda: _port_engine(model, device=device),
                            Request, c, 6)
    jeng = _jax_engine(model)
    jouts = [_serve(jeng, JRequest, [p], 6)[0][0] for p in (a, b)]
    assert outs[:2] == jouts
    if not teng.keeps_snapshots:  # a hit's snapshots are shared, never written
        ptrs = {x.data_ptr() for slot in slots for x in _slot_tensors(slot)}
        per_cache = len(_slot_tensors(slots[0]))
        assert len(ptrs) == per_cache * len(slots)  # no two share a tensor
    teng.close()


@pytest.mark.parametrize("model", ARCHS, indirect=True)
def test_hit_past_the_matched_prefix_decodes_cold(model):
    """a: 50 tokens; b: a with tokens 48-49 changed, plus 6 more. After a is
    admitted, b hits a on 3 blocks (48 tokens). The reference resumes at
    a's 50 tokens, decoding b from a cache that holds a's tokens 48-49: its
    warm output differs from its cold one. The port resumes at 48: its warm
    output equals the cold output of both packages."""
    rng = np.random.default_rng(3)
    vocab = model[0].vocab
    a = rng.integers(0, vocab, 50).astype(np.int32)
    b = a.copy()
    b[48:50] = (b[48:50] + 7) % vocab
    b = np.concatenate([b, rng.integers(0, vocab, 6).astype(np.int32)])
    warm = {}
    for name, make, req in (("jax", lambda: _jax_engine(model), JRequest),
                            ("port", lambda: _port_engine(model), Request)):
        eng = make()
        _serve(eng, req, [a], 6)
        out, counts = _serve(eng, req, [b], 6)
        assert counts == (1, 1)
        warm[name] = (out[0], _cold(make, req, b, 6))
        eng.close()
    (jwarm, jcold), (twarm, tcold) = warm["jax"], warm["port"]
    assert jwarm != jcold  # the reference's quirk
    assert twarm == tcold == jcold


def test_default_overlapped_tuner_serves_and_closes(model):
    """With the default tuner (``SelfTuner.overlapped(2, 4096)`` on the
    engine's device) the waves give the tokens and counts of an engine
    without one, the tuner observes every admitted fingerprint, and close
    (run in a thread, bounded) stops its workers."""
    waves = _serve_lm_waves(model[0].vocab)
    tuned = _port_engine(model, tuner=ServeEngine._DEFAULT_TUNER)
    plain = _port_engine(model)
    tuner = tuned.prefix_index.tuner
    assert tuner.cfg.scheduler.async_build
    assert tuner.cfg.scheduler.max_concurrent_builds == 2
    assert tuner.cfg.scheduler.commit_replay_cap == 4096
    for wave in waves:
        assert _serve(tuned, Request, wave, 8) == _serve(plain, Request,
                                                         wave, 8)
    assert tuner.telemetry.n_waves == 2
    admitted = sum(len(p) // ServeEngine.PREFIX_EVERY for w in waves
                   for p in w)
    assert tuner.forecaster.n_obs == admitted == 18
    closer = threading.Thread(target=tuned.close)
    closer.start()
    closer.join(timeout=JOIN_S)
    assert not closer.is_alive(), "close did not finish"
    assert not any(t.name.startswith("uplif-maintenance")
                   and t.is_alive() for t in threading.enumerate())
    tuned.close()  # idempotent
    plain.close()


def test_engine_defaults_to_cuda(model, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, tc, npp, _ = model
    params = params_from_numpy(npp, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(tc, params, tuner=None)


@pytest.mark.parametrize("model", RECURRENT, indirect=True)
def test_recurrent_hit_resumes_from_a_snapshot(model):
    """A recurrent state cannot be cut back, so the prefill keeps a clone
    of the cache before each block's last token (lengths 15, 31, 47) and
    the slot stores them; a hit on n blocks clones snapshot n and decodes
    from token 16 n - 1: one step more than a cut cache would take, and
    the tail. The hit's prefix snapshots are the stored slot's own
    (shared: nothing writes to them)."""
    rng = np.random.default_rng(22)
    vocab = model[0].vocab
    a = rng.integers(0, vocab, 50).astype(np.int32)
    b = np.concatenate([a[:40], rng.integers(0, vocab, 9).astype(np.int32)])
    eng = _port_engine(model)
    assert eng.keeps_snapshots
    steps = []
    decode = eng._decode

    def counted(tok, cache):
        steps.append(cache.length)
        return decode(tok, cache)

    eng._decode = counted
    _serve(eng, Request, [a], 4)
    [snaps] = eng.prefix_index.slots.values()
    assert [c.length for c in snaps] == [15, 31, 47]
    assert all(not c.cuttable for c in snaps)
    del steps[:]
    out, counts = _serve(eng, Request, [b], 4)
    assert counts == (1, 1)
    assert steps[0] == 31 and len(steps) == (49 - 31) + 3
    stored = eng.prefix_index.slots[1]
    assert [c.length for c in stored] == [15, 31, 47]
    assert stored[0] is snaps[0] and stored[1] is snaps[1]
    assert stored[2] is not snaps[2]
    assert out[0] == _cold(lambda: _port_engine(model), Request, b, 4)
    eng.close()


@pytest.mark.gpu
def test_engine_on_cuda_matches_cpu(model, cuda):
    """The serve_lm waves on the card (float32, TF32 off) give the CPU
    engine's tokens and counts, through the fused locate and rank kernels."""
    assert not torch.backends.cuda.matmul.allow_tf32
    waves = _serve_lm_waves(model[0].vocab)
    card = _port_engine(model, device=cuda, max_len=256)
    host = _port_engine(model, max_len=256)
    assert set(card.prefix_index.index.shard_locate()) == {"fused"}
    ops.reset_launch_counts()
    for wave in waves:
        assert _serve(card, Request, wave, 8) == _serve(host, Request, wave,
                                                        8)
    counts = ops.launch_counts()
    assert counts["fused_locate"] > 0 and counts["bmat_rank"] > 0, counts
    card.close()
    host.close()
