"""The port's launch tooling (``repro_torch.launch``), gradient compression's
all-reduce and the elastic restore, against the JAX package, on the CPU
(and on the card where marked).

* Input cells: ``input_specs`` (meta tensors) has the reference's shapes and
  dtypes for every arch x shape, and ``cell_supported`` its answer and
  reason text.
* FLOPs: ``analyze_program`` gives ``tests/test_system.py``'s expected
  count on its example exactly, and on every smoke config's train step and
  prefill it gives ``analyze_hlo``'s count over the JAX single-device jit:
  exactly, except the two gaps named in ``FLOP_GAPS`` (each within 2%).
* The dry run: the port's CLI in a subprocess writes ``ok`` records for
  both meshes (the unmeasured figures ``null``, never 0) and a ``skipped``
  one for a full-attention ``long_500k``; the reference's CLI on the same
  cell gives the same parameter counts and per-device argument and alias
  bytes. The roofline shows the collective term as "—".
* ``compressed_psum`` over two gloo ranks equals the JAX ``psum`` under
  ``vmap`` bit for bit, and over one rank ``compress_roundtrip``.
* The launchers: ``launch.train.main --device cpu`` trains a smoke config
  and writes a checkpoint that the reference's ``restore`` reads, on the
  reference ``PackedCorpus``'s batches; ``serve`` with the weights carried
  across by ``params_from_numpy`` gives the JAX engine's hit and miss
  counts and, for every request, the JAX engine's cold tokens (the
  reference's hit resumes at the stored prompt's length, reusing the
  first request's tokens past the shared half: ``ROADMAP.md`` §3).

The cases that need the card are in ``tests/test_torch_launch_card.py``,
which imports no JAX.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401 — x64, as in the full system
import jax
import jax.numpy as jnp
from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke
from repro.data.pipeline import PackedCorpus as JCorpus
from repro.data.pipeline import PipelineConfig as JPipelineConfig
from repro.launch import specs as jspecs
from repro.launch.hlo_analysis import analyze_hlo
from repro.models.init import abstract_params as jabstract_params
from repro.models.transformer import forward_lm as jforward_lm
from repro.parallel import compression as jcomp
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro.train import checkpoint as jckpt
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.optimizer import abstract_opt_state as jabstract_opt_state
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.launch import roofline
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import _mesh
from repro_torch.launch.program_analysis import (
    CollectiveInProgram,
    analyze_program,
)
from repro_torch.launch.serve import make_requests, serve
from repro_torch.launch.specs import SHAPES, cell_supported, input_specs
from repro_torch.launch.train import main as train_main
from repro_torch.models import abstract_params, forward_lm, init_params
from repro_torch.models import params_from_numpy
from repro_torch.models.init import flatten_tree, unflatten_tree
from repro_torch.parallel import compression as comp
from repro_torch.parallel.partition import NamedSharding, P
from repro_torch.train import AdamWConfig, abstract_opt_state
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import make_train_step
from tests.test_torch_models import numpy_params

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                JAX_PLATFORMS="cpu")


# ---------------------------------------------------------------------------
# input cells
# ---------------------------------------------------------------------------


def _jax_named(tree):
    pairs, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): leaf for path, leaf in pairs}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_and_cells_match_the_reference(arch):
    jcfg, tcfg = jget_config(arch), get_config(arch)
    for shape in SHAPES:
        assert cell_supported(tcfg, shape) == jspecs.cell_supported(jcfg,
                                                                   shape)
        want = _jax_named(jspecs.input_specs(jcfg, shape))
        got = {"/".join(map(str, p)): leaf
               for p, leaf in flatten_tree(input_specs(tcfg, shape))}
        if tcfg.rwkv is not None and SHAPES[shape]["kind"] == "decode":
            # the port's RWKV cache counts its tokens on the host
            assert got.pop("cache/rwkv/len") == 0
        assert got.keys() == want.keys(), shape
        for name, sds in want.items():
            leaf = got[name]
            if name.endswith("/len"):  # the reference's int32 scalar
                assert leaf == 0 and sds.shape == () and sds.dtype == "int32"
                continue
            assert leaf.device.type == "meta"
            assert tuple(leaf.shape) == tuple(sds.shape), (shape, name)
            assert str(leaf.dtype).split(".")[-1] == str(sds.dtype), name


# ---------------------------------------------------------------------------
# FLOP counts
# ---------------------------------------------------------------------------


def test_flop_count_exact_on_the_scan_example():
    """``tests/test_system.py::test_hlo_flops_counter``'s program: five
    tanh(c @ w) layers, its gradient in both arguments."""

    def f(x, w):
        c = x
        for wl in w:
            c = torch.tanh(c @ wl)
        return torch.autograd.grad(c.sum(), (x, w))

    x = torch.empty(8, 64, device="meta", requires_grad=True)
    w = torch.empty(5, 64, 64, device="meta", requires_grad=True)
    res = analyze_program(f, x, w)
    exp = 5 * 2 * 8 * 64 * 64 + 5 * (2 * 8 * 64 * 64 + 2 * 64 * 8 * 64)
    assert res["dot_flops"] == exp
    assert res["traffic_bytes_proxy"] > 0
    assert res["collective_bytes_total"] == 0.0
    assert set(res["collective_bytes"]) == {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute"}


# The only places where the port's count differs from XLA's dot count on
# the smoke configs (train step; every prefill is exact):
FLOP_GAPS = {
    # Under block remat, torch's checkpoint recomputes a layer up to the
    # last tensor its backward saved, so the shared experts' down
    # projection (computed first, its output dead in the backward) runs
    # again; XLA drops the dead product from the recompute.
    "deepseek-v2-236b": 0.018692,
    # The backward of RWKV-6's readout r . att has an outer product (no
    # contracted axis): torch runs it as a bmm with k = 1, which counts
    # 2 m n, where XLA rewrites a dot without contracting dimensions into
    # a broadcast multiply that is no dot.
    "rwkv6-1-6b": 0.010309,
}


def _smoke_batch(cfg, make):
    b, s = 2, 32
    if cfg.encdec is not None:
        return {"enc_frames": make((b, s, cfg.d_model), cfg.compute_dtype),
                "dec_tokens": make((b, s), "int32")}
    out = {"tokens": make((b, s), "int32")}
    if cfg.vlm is not None:
        out["image_embeds"] = make((b, cfg.vlm.n_image_tokens, cfg.d_model),
                                   cfg.compute_dtype)
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_flops_match_xla_on_the_smoke_configs(arch):
    jc, tc = jsmoke(arch), smoke_config(arch)
    ident = lambda t, kind: t  # noqa: E731
    jb = _smoke_batch(jc, lambda s, d: jax.ShapeDtypeStruct(s, jnp.dtype(d)))
    tb = _smoke_batch(tc, lambda s, d: torch.empty(
        s, dtype=getattr(torch, d), device="meta"))
    jp = jabstract_params(jc)
    want = {
        "train": analyze_hlo(jax.jit(jmake_train_step(
            jc, ident, None, JAdamWConfig(), 1)).lower(
            jp, jabstract_opt_state(jp), jb).compile().as_text()),
        "prefill": analyze_hlo(jax.jit(
            lambda p, b: jforward_lm(p, jc, b, ident, remat=False)).lower(
            jp, jb).compile().as_text()),
    }

    def prefill(p, b):
        with torch.no_grad():
            return forward_lm(p, tc, b, remat=False)

    tp = abstract_params(tc)
    got = {
        "train": analyze_program(make_train_step(tc, AdamWConfig(), 1), tp,
                                 abstract_opt_state(tp), tb),
        "prefill": analyze_program(prefill, tp, tb),
    }
    assert got["prefill"]["dot_flops"] == want["prefill"]["dot_flops"]
    rel = got["train"]["dot_flops"] / want["train"]["dot_flops"] - 1
    assert rel == pytest.approx(FLOP_GAPS.get(arch, 0.0), abs=1e-6)
    assert abs(rel) <= 0.02


def test_ragged_dispatch_counts_k6_and_its_backward():
    """On meta tensors K6 and K6w are shape-only ops with a FLOP formula:
    2 M K N each, so a forward counts one product and its gradient three,
    never 0."""
    from repro_torch.kernels.ragged_dot import ragged_dot

    m, k, n, g = 64, 32, 48, 4
    lhs = torch.empty(m, k, device="meta", requires_grad=True)
    rhs = torch.empty(g, k, n, device="meta", requires_grad=True)
    sizes = torch.empty(g, dtype=torch.int32, device="meta")
    fwd = analyze_program(lambda: ragged_dot(lhs, rhs, sizes))
    assert fwd["dot_flops"] == 2 * m * k * n
    both = analyze_program(lambda: torch.autograd.grad(
        ragged_dot(lhs, rhs, sizes).sum(), (lhs, rhs)))
    assert both["dot_flops"] == 3 * 2 * m * k * n
    tc = dataclasses.replace(smoke_config("qwen3-moe-30b-a3b"))
    ragged = dataclasses.replace(tc, moe=dataclasses.replace(
        tc.moe, dispatch="ragged"))
    tb = {"tokens": torch.empty((2, 32), dtype=torch.int32, device="meta")}
    tp = abstract_params(tc)
    with torch.no_grad():
        f_r = analyze_program(forward_lm, tp, ragged, tb)["dot_flops"]
        f_d = analyze_program(forward_lm, tp, tc, tb)["dot_flops"]
    assert 0 < f_r < f_d  # only the routed rows, no dispatch products


def test_a_collective_in_a_counted_program_raises(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        x = torch.ones(300)
        with pytest.raises(CollectiveInProgram):
            analyze_program(comp.compressed_psum, x)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the dry run and the roofline
# ---------------------------------------------------------------------------


def _dryrun(module, out, *args):
    res = subprocess.run(
        [sys.executable, "-m", module, "--arch", "whisper-small",
         "--out", str(out), *args],
        capture_output=True, text=True, env=_env(), cwd=REPO, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    return res.stdout


def test_dryrun_cli_matches_the_reference(tmp_path):
    out = _dryrun("repro_torch.launch.dryrun", tmp_path / "port",
                  "--shape", "decode_32k")
    assert "[ok]   whisper-small decode_32k pod16x16" in out
    assert "DRY-RUN SUMMARY: 2 ok, 0 skipped-by-design, 0 errors" in out
    recs = {}
    for mesh in ("pod16x16", "pod2x16x16"):
        with open(tmp_path / "port" / "baseline" /
                  f"whisper-small__decode_32k__{mesh}.json") as f:
            recs[mesh] = rec = json.load(f)
        assert rec["status"] == "ok" and rec["flops_per_device"] > 0
        assert rec["flops_split"] == "ideal"
        assert rec["flops_global"] == rec["flops_per_device"] * (
            512 if mesh == "pod2x16x16" else 256)
        for name in ("temp_size_in_bytes", "generated_code_size_in_bytes"):
            assert rec["memory"][name] is None
            assert f"memory.{name}" in rec["unmeasured"]
        assert rec["collective_bytes_total"] is None
        assert set(rec["collective_bytes_per_device"].values()) == {None}
        assert rec["compile_s"] is None
        for key in ("collective_bytes_per_device", "collective_bytes_total",
                    "compile_s", "flops_cost_analysis",
                    "bytes_accessed_per_device"):
            assert rec["unmeasured"][key]
    out = _dryrun("repro_torch.launch.dryrun", tmp_path / "port",
                  "--shape", "long_500k", "--single-pod-only")
    assert "[skip] whisper-small long_500k pod16x16" in out
    with open(tmp_path / "port" / "baseline" /
              "whisper-small__long_500k__pod16x16.json") as f:
        skip = json.load(f)
    assert skip["status"] == "skipped"
    assert skip["reason"] == jspecs.cell_supported(
        jget_config("whisper-small"), "long_500k")[1]

    _dryrun("repro.launch.dryrun", tmp_path / "ref", "--shape", "decode_32k",
            "--single-pod-only")
    with open(tmp_path / "ref" / "baseline" /
              "whisper-small__decode_32k__pod16x16.json") as f:
        ref = json.load(f)
    got = recs["pod16x16"]
    for key in ("n_params", "n_active_params"):
        assert got[key] == ref[key]
    for key in ("argument_size_in_bytes", "alias_size_in_bytes"):
        assert got["memory"][key] == ref["memory"][key]

    table = roofline.table(roofline.load("baseline", str(tmp_path / "port")))
    row = next(line for line in table.splitlines()
               if line.startswith("| whisper-small | decode_32k | pod16x16"))
    assert row.split("|")[6].strip() == "—"  # t_coll: not measured
    assert roofline.CARD in table


def test_run_cell_and_roofline_terms(tmp_path):
    rec = run_cell("deepseek-7b", "decode_32k", False, "tp_fsdp", "dense",
                   str(tmp_path), "t")
    assert rec["status"] == "ok"
    t = roofline.terms(rec, 256)
    assert t["t_collective"] is None and t["t_compute"] > 0
    assert t["bottleneck"] in ("compute", "memory", "undetermined")
    low = (rec["memory"]["argument_size_in_bytes"]
           + rec["memory"]["output_size_in_bytes"])
    assert t["t_memory"] == (
        low / roofline.HBM_BW,
        max(low, rec["traffic_bytes_proxy"]) / roofline.HBM_BW)
    skip = run_cell("deepseek-7b", "long_500k", False, "tp_fsdp", "dense",
                    str(tmp_path), "t")
    assert skip["status"] == "skipped"
    assert "skip" in roofline.table([skip])


def _roofline_rec(flops, args, outs, proxy):
    return {"arch": "a", "shape": "decode_32k", "mesh": "pod16x16",
            "status": "ok", "n_active_params": 1, "flops_per_device": flops,
            "memory": {"argument_size_in_bytes": args,
                       "output_size_in_bytes": outs},
            "traffic_bytes_proxy": proxy, "collective_bytes_total": None}


@pytest.mark.parametrize("t_c,lo,hi,want", [
    (2.0, 0.5, 1.0, "compute"),        # above the range's high end
    (0.5, 1.0, 2.0, "memory"),         # below its low end
    (1.0, 0.5, 2.0, "undetermined"),   # inside it
    (1.0, 2.0, 0.5, "memory"),         # a proxy below the exact bytes
])
def test_roofline_bound_from_the_memory_range(t_c, lo, hi, want):
    rec = _roofline_rec(t_c * roofline.PEAK_FLOPS,
                        lo * roofline.HBM_BW / 4, lo * roofline.HBM_BW * 3 / 4,
                        hi * roofline.HBM_BW)
    t = roofline.terms(rec, 256)
    assert t["t_memory"] == pytest.approx((lo, max(lo, hi)))
    assert t["bottleneck"] == want
    assert bool(t["unmeasured"]) == (want == "undetermined")
    f_lo, f_hi = t["roofline_fraction"]
    assert f_lo == pytest.approx(t_c / max(t_c, lo, hi))
    assert f_hi == pytest.approx(t_c / max(t_c, lo))
    row = roofline.table([rec]).splitlines()[-1].split("|")
    assert row[7].strip() == want
    assert row[6].strip() == "—"
    if want == "undetermined":
        assert t["unmeasured"]["bottleneck"] == roofline.UNDETERMINED
        assert row[10].strip() == "—"


# ---------------------------------------------------------------------------
# compressed_psum
# ---------------------------------------------------------------------------


def _inputs(n_ranks, shape=(1000,)):
    r = np.random.default_rng(17)
    return [r.normal(0, 3, shape).astype(np.float32) for _ in range(n_ranks)]


def test_compressed_psum_one_rank_is_the_roundtrip(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        for x in _inputs(1, (37, 11)) + _inputs(1, (512,)):
            t = torch.from_numpy(x)
            got = comp.compressed_psum(t)
            assert got.shape == t.shape and got.dtype == torch.float32
            assert torch.equal(got, comp.compress_roundtrip(t))
    finally:
        dist.destroy_process_group()


_RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.parallel.compression import compressed_psum
    rank, store, src, dst = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=2)
    x = torch.from_numpy(np.load(src)[rank])
    np.save(dst, compressed_psum(x).numpy())
    dist.destroy_process_group()
""")


def test_compressed_psum_two_ranks_matches_jax_psum(tmp_path):
    xs = np.stack(_inputs(2, (3, 700)))
    np.save(tmp_path / "x.npy", xs)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(rank), str(tmp_path / "store"),
         str(tmp_path / "x.npy"), str(tmp_path / f"out{rank}.npy")],
        env=_env(), cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for rank in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-2000:]
    want = np.asarray(jax.vmap(lambda x: jcomp.compressed_psum(x, "i"),
                               axis_name="i")(jnp.asarray(xs)))
    for rank in range(2):
        got = np.load(tmp_path / f"out{rank}.npy")
        assert got.dtype == np.float32 and got.shape == xs.shape[1:]
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want[rank].view(np.uint32))


# ---------------------------------------------------------------------------
# the elastic restore
# ---------------------------------------------------------------------------


def test_elastic_restore_with_new_sharding(tmp_path):
    """``tests/test_train_and_ckpt.py::test_elastic_restore_with_new_sharding``
    on the port: a one-device mesh places every leaf; a sharding over more
    devices raises."""
    cfg = smoke_config("deepseek-7b")
    params = init_params(cfg, 0, device="cpu")
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, params)
    mesh = _mesh((1,), ("data",))
    sh = unflatten_tree([(p, NamedSharding(mesh, P()))
                         for p, _ in flatten_tree(params)])
    p2, _ = ckpt.restore(d, params, shardings=sh, device="cpu")
    for (_, a), (_, b) in zip(flatten_tree(params), flatten_tree(p2)):
        assert torch.equal(a, b)
    big = unflatten_tree([(p, NamedSharding(_mesh((2,), ("data",)), P()))
                          for p, _ in flatten_tree(params)])
    with pytest.raises(ValueError, match="runs on one card"):
        ckpt.restore(d, params, shardings=big, device="cpu")


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------


def test_train_launcher_checkpoint_restores_in_the_reference(tmp_path):
    d = str(tmp_path / "ck")
    res = train_main(["--arch", "deepseek-7b", "--steps", "3", "--batch",
                      "2", "--seq", "32", "--device", "cpu", "--ckpt-dir",
                      d])
    assert len(res["losses"]) == 3 and np.isfinite(res["losses"]).all()
    assert ckpt.latest_step(d) == 3
    jc = jsmoke("deepseek-7b")
    jp = jabstract_params(jc)
    (p, o), man = jckpt.restore(d, (jp, jabstract_opt_state(jp)))
    assert man["metadata"] == {"arch": jc.name, "strategy": "tp_fsdp"}
    want = flatten_tree((res["params"], res["opt_state"]))
    got = jax.tree_util.tree_leaves((p, o))
    assert len(got) == len(want)
    for (path, t), a in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), t.numpy(), err_msg=path)
    # the batches are the reference corpus's
    jcorpus = JCorpus(JPipelineConfig(vocab=jc.vocab, seq_len=32,
                                      global_batch=2, n_docs=2048))
    for step in range(3):
        np.testing.assert_array_equal(res["corpus"].batch(step)["tokens"],
                                      jcorpus.batch(step)["tokens"])
    # a second run resumes from the checkpoint
    more = train_main(["--arch", "deepseek-7b", "--steps", "4", "--batch",
                       "2", "--seq", "32", "--device", "cpu", "--ckpt-dir",
                       d])
    assert len(more["losses"]) == 1 and ckpt.latest_step(d) == 4


def test_train_wrap_step_sees_every_step(tmp_path):
    from repro_torch.configs import smoke_config
    from repro_torch.launch.train import train

    cfg = smoke_config("deepseek-7b")
    kw = dict(steps=2, batch=2, seq=16, device="cpu")
    seen = []

    def wrap_step(step_fn):
        def step(params, opt, batch):
            seen.append(batch["tokens"].clone())
            return step_fn(params, opt, batch)
        return step

    got = train(cfg, ckpt_dir=str(tmp_path / "a"), wrap_step=wrap_step, **kw)
    want = train(cfg, ckpt_dir=str(tmp_path / "b"), **kw)
    assert got["losses"] == want["losses"]
    assert len(seen) == 2
    for step, toks in enumerate(seen):
        np.testing.assert_array_equal(
            toks.numpy(), want["corpus"].batch(step)["tokens"])


def test_launchers_default_to_cuda(monkeypatch):
    from repro_torch.launch import serve as serve_mod

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_mod.main(["--requests", "1"])


def test_serve_matches_the_jax_engine():
    n_req, plen, new = 3, 32, 4
    tc = dataclasses.replace(smoke_config("deepseek-7b"),
                             compute_dtype="float32")
    jc = dataclasses.replace(jsmoke("deepseek-7b"), compute_dtype="float32")
    npp = numpy_params(tc)
    jp = jax.tree_util.tree_map(jnp.asarray, npp)
    res = serve(tc, requests=n_req, prompt_len=plen, new_tokens=new,
                device="cpu", params=params_from_numpy(npp, device="cpu"))
    reqs = make_requests(tc, n_req, plen, new)
    assert [r.rid for r in res["done"]] == list(range(n_req))
    for a, b in zip(res["done"], reqs):
        np.testing.assert_array_equal(a.prompt, b.prompt)
    assert (reqs[1].prompt[:plen // 2] == reqs[0].prompt[:plen // 2]).all()

    max_len = plen + new + 8
    warm = JEngine(jc, jp, max_len=max_len, tuner=None)
    step = warm._decode
    jdone = warm.generate([JRequest(r.rid, r.prompt, new) for r in reqs])
    assert (res["hits"], res["misses"]) == (warm.prefix_index.hits,
                                           warm.prefix_index.misses)
    assert res["hits"] == n_req - 1
    for r, jr in zip(res["done"], jdone):
        cold = JEngine(jc, jp, max_len=max_len, tuner=None)
        cold._decode = step
        [c] = cold.generate([JRequest(jr.rid, jr.prompt, new)])
        assert r.out == c.out, r.rid
    # the reference's hits resume at the stored prompt's length: each
    # takes the first request's tokens
    assert all(jr.out == jdone[0].out for jr in jdone)
    assert res["tokens"] == n_req * new and res["tokens_per_s"] > 0
