"""The port's training path (``repro_torch.models.loss_fn``,
``repro_torch.train``) against the JAX package, on the CPU; and the
reference's own tests (``tests/test_train_and_ckpt.py``) mirrored on the
port.

Both packages start from the same numpy weights (``numpy_params``, through
``params_from_numpy``) and optimizer state (``opt_state_from_numpy``), on
the same numpy batches. Tolerances:
  * ``loss_fn`` in float32 compute: the loss within 1e-5 relative; each
    leaf's gradient within rtol 1e-4 and an atol of 1e-5 of the leaf's
    largest gradient. The two frameworks sum the same float32 terms in
    other orders; where terms of the leaf's magnitude cancel, the result
    moves by a few ulps of the terms, not of the result (about 1e-6 to
    3e-6 of the leaf's largest value at smoke size, on one element in
    10^4), which an absolute 1e-6 would call a mismatch.
  * ``adamw_update`` and ``_schedule``: 1e-6 relative (float32 arithmetic
    in the same order; XLA's ``pow`` and sums may differ by an ulp). The
    global norm's sum, in XLA's order, moves the clip scale by an ulp and
    with it every scaled gradient; where m's two terms cancel, that ulp of
    the terms exceeds 1e-6 of m, so m, v and the params are held within
    1e-6 relative or 1e-6 of their leaf's largest value.
  * ``make_train_step`` over 3 steps: the loss within 1e-5 relative, each
    parameter within ``STEP_TOL`` absolute. Adam's first steps move each
    weight by about lr x sign(g); where g itself is at the float32 noise
    floor of its leaf, the two frameworks can take different steps, so
    parameters are held to a bound of the learning rate's order (1.4e-4
    seen by the third step), and all but a thousandth of each leaf within
    ``STEP_CLOSE`` = 1e-6.
Checkpoints and the resumed loop are held bit for bit.
"""
import dataclasses
import json
import os
import threading

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401 — x64, as in the full system
import jax
import jax.numpy as jnp
from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jget, smoke_config as jsmoke
from repro.models import loss_fn as jloss
from repro.models.init import abstract_params as jabstract_params
from repro.models.transformer import abstract_cache as jabstract_cache
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train.step import make_train_step as jmake_train_step
from repro.train.step import pick_microbatches as jpick
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.models import (
    abstract_cache,
    abstract_params,
    loss_fn,
    opt_state_from_numpy,
    params_from_numpy,
)
from repro_torch.models import transformer as ttransformer
from repro_torch.models.init import (
    ParamDesc,
    flatten_tree,
    param_descriptors,
    rebuild_tree,
    tree_device,
    unflatten_tree,
)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as topt
from repro_torch.train.loop import LoopConfig, SimulatedFailure, run
from repro_torch.train.step import grads_of, make_train_step, \
    pick_microbatches
from tests.test_torch_models import _batch, numpy_params

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_ATOL_OF_MAX = 1e-5
OPT_RTOL = 1e-6
STEP_TOL = 1e-3     # about half the learning rate of the third step
STEP_CLOSE = 1e-6   # ... which all but a few elements a leaf stay within
STEP_FEW = 1e-3     # "a few": this share of each leaf at most (1e-4 seen)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(arch):
    return (dataclasses.replace(jsmoke(arch), compute_dtype="float32"),
            dataclasses.replace(smoke_config(arch), compute_dtype="float32"))


def _jtree(npp):
    return jax.tree_util.tree_map(jnp.asarray, npp)


def _leaves_np(tree):
    """(path, float64 numpy) of a port tree in JAX's leaf order."""
    return [("/".join(p), leaf.detach().double().numpy())
            for p, leaf in flatten_tree(tree)]


def _grads_close(jg, tg):
    jl = jax.tree_util.tree_leaves(jg)
    tl = _leaves_np(tg)
    assert len(jl) == len(tl)
    for a, (path, b) in zip(jl, tl):
        a = np.asarray(a, np.float64)
        np.testing.assert_allclose(
            b, a, rtol=GRAD_RTOL,
            atol=GRAD_ATOL_OF_MAX * max(np.abs(a).max(), 1e-30),
            err_msg=path)


# ------------------------------------------------------------------ loss_fn


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_fn_matches_jax(arch):
    """Value and every leaf's gradient of ``loss_fn`` against
    ``jax.value_and_grad(loss_fn)`` at float32 compute, for all ten smoke
    architectures (the VLM with its image prefix, whisper over 24 frames:
    the unused rows of ``enc_pos`` get zeros, as in JAX)."""
    jc, tc = _f32(arch)
    npp = numpy_params(tc)
    _, jb, tb = _batch(tc, 40)
    jl, jg = jax.value_and_grad(lambda p: jloss(p, jc, jb))(_jtree(npp))
    tl, paths, grads = grads_of(params_from_numpy(npp, device="cpu"), tc,
                                tb)
    assert abs(float(tl) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    _grads_close(jg, unflatten_tree(list(zip(paths, grads))))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_remat_changes_no_gradient(arch, monkeypatch):
    """Grads with and without remat are bit-equal; with it, every layer
    group (every encoder and decoder layer) goes through one checkpoint,
    and a forward that records no gradient takes none."""
    _, tc = _f32(arch)
    assert tc.remat == "block"
    params = params_from_numpy(numpy_params(tc), device="cpu")
    _, _, tb = _batch(tc, 41)
    calls = []
    orig = ttransformer.checkpoint

    def counted(*args, **kw):
        calls.append(kw.get("use_reentrant"))
        return orig(*args, **kw)

    monkeypatch.setattr(ttransformer, "checkpoint", counted)
    with_remat = grads_of(params, tc, tb)
    n = len(calls)
    want = (tc.encdec.n_enc_layers + tc.encdec.n_dec_layers
            if tc.encdec is not None else
            tc.n_layers // len(ttransformer.block_pattern(tc)))
    assert n == want and set(calls) == {False}
    without = grads_of(params, dataclasses.replace(tc, remat="none"), tb)
    assert len(calls) == n
    assert torch.equal(with_remat[0], without[0])
    for a, b in zip(with_remat[2], without[2]):
        assert torch.equal(a, b)
    with torch.inference_mode():
        ttransformer.forward_lm(params, tc, tb)
    with torch.no_grad():
        loss_fn(params, tc, tb)
    assert len(calls) == n


# ---------------------------------------------------------------- optimizer


def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"b": rng.normal(0, 1, (7,)).astype(np.float32),
            "a": {"w": rng.normal(0, 1, (5, 9)).astype(np.float32)}}


@pytest.mark.parametrize("ocfg", [
    dict(warmup_steps=10, total_steps=100),
    dict(warmup_steps=0, total_steps=50, weight_decay=0.0, grad_clip=0.5),
], ids=["warmup", "no_warmup"])
def test_adamw_update_matches_jax(ocfg):
    """121 updates (steps 0-120, through the warmup, the cosine and past
    ``total_steps``) from the same state on the same gradients: params,
    m, v, step, grad_norm and lr within 1e-6 relative every step."""
    jcfg, tcfg = jopt.AdamWConfig(**ocfg), topt.AdamWConfig(**ocfg)
    npp = _opt_tree(0)
    jp = _jtree(npp)
    js = jopt.init_opt_state(jp)
    tp = params_from_numpy(npp, device="cpu")
    ts = opt_state_from_numpy(*(jax.tree_util.tree_map(np.asarray, f)
                                for f in js), device="cpu")
    upd = lambda p, g, s: jopt.adamw_update(p, g, s, jcfg)  # noqa: E731
    for step in range(121):
        g = _opt_tree(100 + step)
        scale = 10.0 if step % 7 == 0 else 0.1  # clipping on and off
        g = jax.tree_util.tree_map(lambda a: a * scale, g)
        jp, js, jm = upd(jp, _jtree(g), js)
        tp, ts, tm = topt.adamw_update(
            tp, params_from_numpy(g, device="cpu"), ts, tcfg)
        assert int(ts.step) == int(js.step) == step + 1
        assert ts.step.dtype == torch.int32
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=OPT_RTOL, err_msg=key)
        for jt, tt in ((jp, tp), (js.m, ts.m), (js.v, ts.v)):
            for a, (path, b) in zip(jax.tree_util.tree_leaves(jt),
                                    _leaves_np(tt)):
                a = np.asarray(a, np.float64)
                np.testing.assert_allclose(b, a, rtol=OPT_RTOL,
                                           atol=OPT_RTOL * np.abs(a).max(),
                                           err_msg=f"step {step}: {path}")


@pytest.mark.parametrize("ocfg", [
    dict(), dict(warmup_steps=10, total_steps=100),
    dict(warmup_steps=0, total_steps=1), dict(warmup_steps=7, lr=1e-2,
                                              min_lr_frac=0.0),
])
def test_schedule_matches_jax(ocfg):
    steps = np.arange(0, 121, dtype=np.float32)
    want = np.asarray(jopt._schedule(jopt.AdamWConfig(**ocfg),
                                     jnp.asarray(steps)))
    got = topt._schedule(topt.AdamWConfig(**ocfg), torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=OPT_RTOL, atol=0)


def test_global_norm_sums_the_leaves_in_jax_order():
    npp = _opt_tree(3)
    want = float(jopt.global_norm(_jtree(npp)))
    got = topt.global_norm(params_from_numpy(npp, device="cpu"))
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= OPT_RTOL * want


def test_grad_clip():
    p = {"w": torch.ones(4)}
    g = {"w": torch.full((4,), 1e6)}
    st = topt.init_opt_state(p)
    cfg = topt.AdamWConfig(grad_clip=1.0, weight_decay=0.0, warmup_steps=0)
    _, _, m = topt.adamw_update(p, g, st, cfg)
    assert float(m["grad_norm"]) > 1e5  # measured pre-clip


# ------------------------------------------------------------------- steps


def _setup(seed=0):
    """The reference's ``_setup`` on both packages: the smoke deepseek-7b
    at float32 compute, the same numpy weights and the JAX state carried
    over, ``AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=100)`` and
    batches of 4 x 32 tokens keyed by the step."""
    jc, tc = _f32("deepseek-7b")
    npp = numpy_params(tc, seed)
    jp = _jtree(npp)
    js = jopt.init_opt_state(jp)
    tp = params_from_numpy(npp, device="cpu")
    ts = opt_state_from_numpy(*(jax.tree_util.tree_map(np.asarray, f)
                                for f in js), device="cpu")

    def batch(step):
        toks = np.random.default_rng(1000 + step).integers(
            0, tc.vocab, (4, 32)).astype(np.int32)
        return {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(
            toks.astype(np.int64))}

    return jc, tc, (jp, js), (tp, ts), batch


def _params_close(jp, tp, what):
    for a, (path, b) in zip(jax.tree_util.tree_leaves(jp), _leaves_np(tp)):
        diff = np.abs(b - np.asarray(a, np.float64))
        assert diff.max() <= STEP_TOL, (what, path, diff.max())
        assert (diff > STEP_CLOSE).mean() <= STEP_FEW, (what, path)


@pytest.mark.parametrize("nm", [1, 4])
def test_train_step_matches_jax(nm):
    """Three ``make_train_step`` steps at nm 1 and 4 against the JAX
    package's, from the same weights and state on the same batches."""
    jc, tc, (jp, js), (tp, ts), batch = _setup()
    kw = dict(lr=3e-3, warmup_steps=5, total_steps=100)
    specs = jax.tree_util.tree_map(lambda _: None, jp)
    jstep = jax.jit(jmake_train_step(jc, lambda t, k: t, specs,
                                     jopt.AdamWConfig(**kw), nm=nm))
    tstep = make_train_step(tc, topt.AdamWConfig(**kw), nm=nm)
    for step in range(3):
        jb, tb = batch(step)
        jp, js, jl, jm = jstep(jp, js, jb)
        tp, ts, tl, tm = tstep(tp, ts, tb)
        assert abs(float(tl) - float(jl)) <= LOSS_RTOL * abs(float(jl))
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        _params_close(jp, tp, f"step {step}")
        _params_close(js.m, ts.m, f"m, step {step}")
        assert int(ts.step) == step + 1


def test_loss_decreases():
    _, tc, _, (params, opt), batch = _setup()
    step_fn = make_train_step(tc, topt.AdamWConfig(
        lr=3e-3, warmup_steps=5, total_steps=100), nm=1)
    _, b = batch(0)  # overfit one batch: loss must fall fast
    losses = []
    for _ in range(25):
        params, opt, loss, _ = step_fn(params, opt, b)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.7, losses[::6]


def test_microbatched_step_matches_fused():
    """The reference's check (5e-2), and the step writes none of its
    inputs: both steps start from the same tensors."""
    _, tc, _, (params, opt), batch = _setup()
    before = [t.clone() for _, t in flatten_tree(params)]
    ocfg = topt.AdamWConfig(lr=1e-3)
    _, b = batch(0)
    p1, _, l1, _ = make_train_step(tc, ocfg, nm=1)(params, opt, b)
    p4, _, l4, _ = make_train_step(tc, ocfg, nm=4)(params, opt, b)
    assert abs(float(l1) - float(l4)) < 5e-2
    d = max(float((a.float() - c.float()).abs().max()) for (_, a), (_, c)
            in zip(flatten_tree(p1), flatten_tree(p4)))
    assert d < 5e-2
    for t, (_, now) in zip(before, flatten_tree(params)):
        assert torch.equal(t, now)
    assert int(opt.step) == 0


def test_microbatches_are_contiguous_row_blocks(monkeypatch):
    """Microbatch i is rows [i B / nm, (i + 1) B / nm), as the reference's
    reshape splits the batch."""
    _, tc, _, (params, opt), batch = _setup()
    seen = []
    import repro_torch.train.step as tstep

    def spy(params, cfg, mb):
        seen.append(mb["tokens"].clone())
        return orig(params, cfg, mb)

    orig = tstep.grads_of
    monkeypatch.setattr(tstep, "grads_of", spy)
    _, b = batch(1)
    make_train_step(tc, topt.AdamWConfig(), nm=2)(params, opt, b)
    assert len(seen) == 2
    assert torch.equal(seen[0], b["tokens"][:2])
    assert torch.equal(seen[1], b["tokens"][2:])


@pytest.mark.parametrize("global_batch", [1, 2, 8, 12, 64, 256])
@pytest.mark.parametrize("seq", [512, 4096, 32768])
@pytest.mark.parametrize("shards", [1, 4, 16])
def test_pick_microbatches(global_batch, seq, shards):
    assert pick_microbatches(global_batch, seq, shards) == jpick(
        global_batch, seq, shards)


def test_pick_microbatches_reference_cases():
    assert pick_microbatches(256, 4096, 16) == 8
    assert pick_microbatches(8, 512, 8) == 1


# -------------------------------------------------------------- checkpoints


def _state():
    _, tc, (jp, js), (tp, ts), _ = _setup()
    return (jp, js), (tp, ts)


def _assert_trees_equal(a, b):
    fa, fb = ckpt._flatten(a), ckpt._flatten(b)
    assert [n for n, _ in fa] == [n for n, _ in fb]
    for (name, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x, y), name


def test_flatten_tree_order_and_rebuild():
    """``flatten_tree`` walks a (params, OptState) pair in JAX's order with
    JAX's keys (dict keys, NamedTuple fields, tuple positions), and
    ``rebuild_tree`` puts the leaves back into the same structure."""
    (jp, js), (tp, ts) = _state()

    def key(k):
        for a in ("key", "name", "idx"):
            if hasattr(k, a):
                return getattr(k, a)
        raise AssertionError(k)

    jl = [(tuple(key(k) for k in path), leaf) for path, leaf
          in jax.tree_util.tree_flatten_with_path((jp, js))[0]]
    tl = flatten_tree((tp, ts))
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (p, j), (_, t) in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(j, np.float32),
                                      t.float().numpy(), err_msg=str(p))
    back = rebuild_tree((tp, ts), [t for _, t in tl])
    assert type(back[1]) is type(ts)
    _assert_trees_equal(back, (tp, ts))
    assert tree_device((tp, ts)) == torch.device("cpu")
    descs = flatten_tree(param_descriptors(smoke_config("deepseek-7b")),
                         is_leaf=lambda x: isinstance(x, ParamDesc))
    assert all(isinstance(d, ParamDesc) for _, d in descs)


def test_checkpoint_roundtrip(tmp_path):
    _, (params, opt) = _state()
    d = str(tmp_path / "ck")
    ckpt.save(d, 7, (params, opt), metadata={"note": "x"})
    (p2, o2), man = ckpt.restore(d, (params, opt), device="cpu")
    assert man["step"] == 7 and man["metadata"]["note"] == "x"
    assert isinstance(o2, topt.OptState)
    _assert_trees_equal((params, opt), (p2, o2))
    assert ckpt.latest_step(d) == 7


def test_checkpoint_names_its_leaves_as_the_reference(tmp_path):
    (jp, js), (tp, ts) = _state()
    jckpt.save(str(tmp_path / "j"), 1, (jp, js))
    ckpt.save(str(tmp_path / "t"), 1, (tp, ts))
    jm, tm = (json.load(open(tmp_path / w / "step_0000000001" /
                             "manifest.json")) for w in "jt")
    assert tm == jm
    names = {leaf["name"] for leaf in tm["leaves"]}
    assert {"0__embed", "0__layers__blk0_attn__wq", "1__m__embed",
            "1__step"} <= names


def test_checkpoint_gc_and_atomicity(tmp_path):
    _, (params, opt) = _state()
    d = str(tmp_path / "ck")
    for s in (1, 2, 3, 4, 5):
        ckpt.save(d, s, (params, opt), keep_last=2)
    steps = sorted(x for x in os.listdir(d) if x.startswith("step_"))
    assert len(steps) == 2 and steps[-1].endswith("5".zfill(10))
    assert not [x for x in os.listdir(d) if x.startswith(".tmp")]


def test_failed_save_leaves_no_partial_checkpoint(tmp_path, monkeypatch):
    """A save that dies mid-write leaves its temp dir removed and the last
    complete checkpoint the latest."""
    _, (params, opt) = _state()
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, (params, opt))
    calls = []
    orig = ckpt._write_leaf

    def dying(*args):
        calls.append(1)
        if len(calls) == 3:
            raise OSError("disk gone")
        return orig(*args)

    monkeypatch.setattr(ckpt, "_write_leaf", dying)
    with pytest.raises(OSError):
        ckpt.save(d, 2, (params, opt))
    assert ckpt.latest_step(d) == 1
    assert sorted(os.listdir(d)) == ["step_0000000001"]


def test_save_async_snapshots_before_returning(tmp_path):
    """The leaves are copied when ``save_async`` returns: writing a leaf
    afterwards does not reach the checkpoint."""
    _, (params, opt) = _state()
    want = params["embed"].clone()
    d = str(tmp_path / "ck")
    t = ckpt.save_async(d, 3, (params, opt), metadata={"a": 1}, keep_last=2)
    assert isinstance(t, threading.Thread)
    params["embed"].add_(1.0)
    t.join(timeout=60)
    assert not t.is_alive()
    (p2, _), man = ckpt.restore(d, (params, opt), device="cpu")
    assert man["metadata"] == {"a": 1} and man["step"] == 3
    assert torch.equal(p2["embed"], want)


def test_restore_into_abstract_trees(tmp_path):
    """``abstract_params`` and ``abstract_opt_state`` (meta tensors) are
    enough to restore a checkpoint."""
    _, tc, _, (params, opt), _ = _setup()
    d = str(tmp_path / "ck")
    ckpt.save(d, 4, (params, opt))
    like = (abstract_params(tc), topt.abstract_opt_state(abstract_params(tc)))
    (p2, o2), _ = ckpt.restore(d, like, device="cpu")
    _assert_trees_equal((params, opt), (p2, o2))


def test_restore_refuses_a_wrong_shape(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, {"w": torch.zeros(3, 4)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(d, {"w": torch.zeros(4, 3)}, device="cpu")
    with pytest.raises(ValueError, match="missing"):
        ckpt.restore(d, {"v": torch.zeros(3, 4)}, device="cpu")


def test_jax_checkpoint_restores_in_the_port_bit_equal(tmp_path):
    (jp, js), (tp, ts) = _state()
    d = str(tmp_path / "ck")
    jckpt.save(d, 5, (jp, js))
    (p2, o2), man = ckpt.restore(d, (tp, ts), device="cpu")
    assert man["step"] == 5
    _assert_trees_equal((tp, ts), (p2, o2))


def test_port_checkpoint_restores_in_jax_bit_equal(tmp_path):
    (jp, js), (tp, ts) = _state()
    d = str(tmp_path / "ck")
    ckpt.save(d, 6, (tp, ts))
    (p2, o2), man = jckpt.restore(d, (jp, js))
    assert man["step"] == 6
    for a, b in zip(jax.tree_util.tree_leaves((jp, js)),
                    jax.tree_util.tree_leaves((p2, o2))):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _bf16_tree():
    x = np.random.default_rng(9).normal(0, 1, (3, 5)).astype(np.float32)
    jt = {"w": jnp.asarray(x).astype(jnp.bfloat16),
          "f": jnp.asarray(x[0])}
    tt = {"w": torch.from_numpy(x).to(torch.bfloat16),
          "f": torch.from_numpy(x[0])}
    return jt, tt


def test_jax_bfloat16_leaf_restores_in_the_port(tmp_path):
    """The JAX package writes a bf16 leaf as a '<V2' npy with "bfloat16" in
    the manifest; the port reads it back through the manifest's dtype."""
    jt, tt = _bf16_tree()
    d = str(tmp_path / "ck")
    jckpt.save(d, 1, jt)
    got, man = ckpt.restore(d, tt, device="cpu")
    assert {m["name"]: m["dtype"] for m in man["leaves"]}["w"] == "bfloat16"
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"], tt["w"]) and torch.equal(got["f"], tt["f"])


def test_port_writes_a_bfloat16_leaf_as_jax_does(tmp_path):
    """The same bytes and manifest for a bf16 leaf; the reference itself
    cannot restore it (``np.load`` gives '|V2', which ``jax.device_put``
    refuses: ROADMAP §3), the port can."""
    jt, tt = _bf16_tree()
    jckpt.save(str(tmp_path / "j"), 1, jt)
    ckpt.save(str(tmp_path / "t"), 1, tt)
    for name in ("w.npy", "f.npy", "manifest.json"):
        a, b = ((tmp_path / w / "step_0000000001" / name).read_bytes()
                for w in "jt")
        assert a == b, name
    with pytest.raises(TypeError):
        jckpt.restore(str(tmp_path / "t"), jt)
    got, _ = ckpt.restore(str(tmp_path / "t"), tt, device="cpu")
    assert torch.equal(got["w"], tt["w"])


# --------------------------------------------------------------------- loop


def test_resume_after_failure_matches_uninterrupted(tmp_path):
    """Kill at step 12, restart from the checkpoint, final params ==
    uninterrupted run, bit for bit (the batch is keyed by the step)."""
    _, tc, _, _, batch = _setup()
    step_fn = make_train_step(tc, topt.AdamWConfig(
        lr=3e-3, warmup_steps=5, total_steps=100), nm=1)

    def fresh():
        p = params_from_numpy(numpy_params(tc), device="cpu")
        return p, topt.init_opt_state(p)

    def next_batch(step):
        return batch(step)[1]

    res_a = run(step_fn, *fresh(), next_batch, LoopConfig(
        total_steps=20, ckpt_every=5, ckpt_dir=str(tmp_path / "a"),
        log_every=100))
    lc = dict(total_steps=20, ckpt_every=5, ckpt_dir=str(tmp_path / "b"),
              log_every=100)
    with pytest.raises(SimulatedFailure):
        run(step_fn, *fresh(), next_batch, LoopConfig(fail_at_step=12, **lc))
    assert ckpt.latest_step(str(tmp_path / "b")) == 10
    res_b = run(step_fn, *fresh(), next_batch, LoopConfig(async_ckpt=True,
                                                          **lc))
    assert len(res_b["losses"]) == 10 and res_b["losses"] == \
        res_a["losses"][10:]
    _assert_trees_equal((res_a["params"], res_a["opt_state"]),
                        (res_b["params"], res_b["opt_state"]))
    assert ckpt.latest_step(str(tmp_path / "b")) == 20


# ---------------------------------------------------------- abstract trees


def _same_structs(jtree, ttree, skip=()):
    """Every JAX ShapeDtypeStruct leaf has a meta tensor of its shape and
    dtype at the same path."""
    jl = {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                   for k in path): leaf
          for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    tl = dict(ckpt._flatten(ttree))
    tl = {k.replace("__", "/"): v for k, v in tl.items()
          if not isinstance(v, int)}
    assert set(jl) - set(skip) == set(tl) - set(skip)
    for name, s in jl.items():
        if name in skip:
            continue
        t = tl[name]
        assert t.device.type == "meta", name
        assert tuple(t.shape) == tuple(s.shape), name
        assert str(t.dtype)[6:] == str(np.dtype(s.dtype)), name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_trees_match_jax(arch):
    """``abstract_params``, ``abstract_opt_state`` and ``abstract_cache``
    of the full config against the reference's ShapeDtypeStruct trees,
    without allocating (meta tensors). The cache's "len" is the port's host
    integer where JAX has an int32 scalar struct (``DecodeCache``)."""
    assert JAX_ARCH_IDS == ARCH_IDS
    jc, tc = jget(arch), get_config(arch)
    jp, tp = jabstract_params(jc), abstract_params(tc)
    _same_structs(jp, tp)
    _same_structs(jopt.abstract_opt_state(jp), topt.abstract_opt_state(tp))
    lens = ("kv/len", "mla/len")
    _same_structs(jabstract_cache(jc, 2, 64), abstract_cache(tc, 2, 64),
                  skip=lens)
    _same_structs(jabstract_cache(jc, 1, 32, "float32"),
                  abstract_cache(tc, 1, 32, "float32"), skip=lens)
