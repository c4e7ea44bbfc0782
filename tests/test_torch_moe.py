"""The port's MoE layer (``repro_torch.models.moe``) and its grouped matrix
product K6 (``repro_torch.kernels.ragged_dot``) against the JAX package, on
the CPU (and on the card where marked).

Both packages compute with the same weights and inputs, made from numpy
seeds (``tests.test_torch_models.numpy_params``). Routing is compared
exactly: the top-k indices, ties included (``jax.lax.top_k`` puts the lower
index first), and the capacity mask ``keep``. The layer's outputs at
float32 compute are held within ``F32_TOL`` = 1e-5: the two frameworks sum
the same float32 products in other orders, a few ulps at these sizes. At
bfloat16 compute the bound is ``test_layer_matches_jax``'s (0.15).

K6's plain version (``ragged_dot_plain``) is held to ``jax.lax.ragged_dot``
within 1e-5 at float32 and within one bfloat16 ulp of the reference's
value at bfloat16 (both round a float32 sum once; the sums differ in
order only). On the card K6 is held to the plain version within
``K6_F32_TOL`` at float32 (its fmaf chain against cuBLAS's blocked sums of
up to 5120 products), and at bfloat16 within one bfloat16 ulp plus that
float32 bound: the tensor cores sum the products in another order than
cuBLAS, and near zero, where a bf16 ulp is small, the two float32 sums
can differ by more than one (seen on the H100 at K = 2048). K6's float32
arithmetic is one fmaf chain per output, so on the card it is also held
bit for bit to ``_fmaf_chain``, that chain written with ``ref.fma_f32``.
Which K6 kernel runs (``k6.path``: TMA or the simple one) depends on shape
and alignment only; the CPU tests pin the choice, the card's tests count
the launches of each.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401 — x64, as in the full system
import jax
import jax.numpy as jnp
import repro.models.moe as jmoe
from repro.configs import smoke_config as jsmoke
from repro.models import forward_lm as jforward
from repro_torch.configs import smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels import ragged_dot as k6
from repro_torch.kernels.ragged_dot import ragged_dot
from repro_torch.kernels.ref import fma_f32, ragged_dot_plain
from repro_torch.models import compute_params, forward_lm, params_from_numpy
from repro_torch.models import moe as tmoe
from tests.test_torch_models import BF16_TOL, DTYPES, _np, numpy_params

MOE = ["qwen3-moe-30b-a3b", "deepseek-v2-236b"]
F32_TOL = 1e-5
K6_F32_TOL = 1e-4
BF16_ULP = 2.0 ** -7  # one bf16 ulp is at most 2^-7 of the value


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


def _cfgs(arch, dtype, **moe):
    """The smoke config of ``arch`` in both packages, at ``dtype`` compute,
    with ``moe`` fields replaced."""
    out = []
    for get in (jsmoke, smoke_config):
        cfg = get(arch)
        cfg = dataclasses.replace(
            cfg, compute_dtype=dtype,
            moe=dataclasses.replace(cfg.moe, **moe))
        out.append(cfg)
    return out


_LAYER0 = {}


def _layer0(arch):
    """Layer 0's parameters in both packages (float32 numpy weights)."""
    if arch not in _LAYER0:
        npp = numpy_params(smoke_config(arch))
        np0 = {k: v[0] for k, v in npp["layers"]["blk0_attn"].items()}
        _LAYER0[arch] = ({k: jnp.asarray(v) for k, v in np0.items()},
                         params_from_numpy(np0, device="cpu"))
    return _LAYER0[arch]


def _x(cfg, dtype, seed=30, b=2, s=8):
    x = np.random.default_rng(seed).normal(0, 1, (b, s, cfg.d_model))
    jdt, tdt = DTYPES[dtype]
    x = x.astype(np.float32)
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _jax_keep(top_i, n_experts, cap):
    """``keep`` as ``repro/models/moe.py:44-47`` computes it."""
    t, k = top_i.shape
    onehot = jax.nn.one_hot(top_i, n_experts, dtype=jnp.int32)
    pos = jnp.cumsum(onehot.reshape(t * k, n_experts), axis=0) - 1
    pos = (pos.reshape(t, k, n_experts) * onehot).sum(-1)
    return np.asarray(pos < cap)


# ------------------------------------------------------------------ router


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_router_matches_jax(arch, dtype):
    """Top-k indices and the capacity mask exactly, the renormalized
    probabilities within the dtype's tolerance; at a capacity factor of
    0.5 some (token, k) are dropped and some kept."""
    jc, tc = _cfgs(arch, dtype)
    jp, tp = _layer0(arch)
    jx, tx = _x(tc, dtype)
    jtop_p, jtop_i = jmoe._router(jx, jp, jc, jx.dtype)
    ttop_p, ttop_i = tmoe._router(tx, tp, tc, tx.dtype)
    assert ttop_p.dtype == DTYPES[dtype][1]
    np.testing.assert_array_equal(np.asarray(jtop_i), ttop_i.numpy())
    tol = F32_TOL if dtype == "float32" else BF16_ULP
    np.testing.assert_allclose(_np(jtop_p), _np(ttop_p), rtol=tol, atol=tol)
    t = tx.shape[0] * tx.shape[1]
    k, e = tc.moe.top_k, tc.moe.n_experts
    cap = max(int(0.5 * t * k / e), 1)
    want = _jax_keep(jtop_i.reshape(t, k), e, cap)
    _, keep = tmoe._capacity_slots(ttop_i.reshape(t, k), e, cap)
    np.testing.assert_array_equal(want, keep.numpy())
    assert want.any() and not want.all()


def test_top_k_breaks_ties_to_the_lower_index():
    """Equal probabilities come out lower index first, as
    ``jax.lax.top_k`` orders them (``torch.topk`` promises no order)."""
    rng = np.random.default_rng(31)
    levels = np.array([0.1, 0.2, 0.3], np.float32)
    probs = levels[rng.integers(0, 3, (64, 16))]
    for k in (1, 2, 6, 16):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = tmoe._top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
        np.testing.assert_array_equal(np.asarray(jv), tv.numpy())


def test_router_ties_match_jax():
    """A router whose columns come in equal pairs gives every token tied
    probabilities; the picks equal the reference's, lower index first."""
    jc, tc = _cfgs("qwen3-moe-30b-a3b", "float32")
    jp, tp = _layer0("qwen3-moe-30b-a3b")
    w = np.asarray(jp["router"]).copy()
    w[:, 1::2] = w[:, 0::2]
    jp, tp = dict(jp, router=jnp.asarray(w)), dict(
        tp, router=torch.from_numpy(w))
    jx, tx = _x(tc, "float32", seed=32)
    _, ji = jmoe._router(jx, jp, jc, jnp.float32)
    tprob, ti = tmoe._router(tx, tp, tc, torch.float32)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    # each tied pair is picked together, the even (lower) index first
    assert (ti[..., 0] % 2 == 0).all() and (ti[..., 1] == ti[..., 0] + 1).all()


# ---------------------------------------------------------------- dispatch


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dispatch", ["dense", "dense_chunked", "ragged"])
@pytest.mark.parametrize("arch", MOE)
def test_dispatch_matches_jax(monkeypatch, arch, dispatch, dtype):
    """``moe_layer`` of layer 0 on 16 tokens in both packages: dense (with
    capacity drops at the configs' factor of 1.25), dense_chunked over two
    chunks of 8 (``MOE_CHUNK`` lowered in both packages) and ragged."""
    monkeypatch.setattr(jmoe, "MOE_CHUNK", 8)
    monkeypatch.setattr(tmoe, "MOE_CHUNK", 8)
    jc, tc = _cfgs(arch, dtype, dispatch=dispatch)
    jp, tp = _layer0(arch)
    jx, tx = _x(tc, dtype)
    a = jmoe.moe_layer(jx, jp, jc)
    b = tmoe.moe_layer(tx, tp, tc)
    assert b.shape == tx.shape and b.dtype == tx.dtype
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def test_dense_chunked_runs_each_chunk_on_its_own(monkeypatch):
    """Above ``MOE_CHUNK`` (a multiple of it) the chunked dispatch is the
    dense one over each chunk; otherwise it is the dense one over all."""
    monkeypatch.setattr(tmoe, "MOE_CHUNK", 8)
    _, tc = _cfgs("qwen3-moe-30b-a3b", "float32", capacity_factor=0.5)
    _, tp = _layer0("qwen3-moe-30b-a3b")
    _, tx = _x(tc, "float32")
    chunked = tmoe.moe_dense_chunked(tx, tp, tc)
    each = torch.cat([tmoe.moe_dense(tx[i:i + 1], tp, tc) for i in (0, 1)])
    assert torch.equal(chunked, each)
    # drops are per chunk here, so the whole-batch dispatch differs
    assert not torch.equal(chunked, tmoe.moe_dense(tx, tp, tc))
    _, tx3 = _x(tc, "float32", b=1, s=12)  # not a multiple: one dispatch
    assert torch.equal(tmoe.moe_dense_chunked(tx3, tp, tc),
                       tmoe.moe_dense(tx3, tp, tc))


def test_ragged_matches_dense_forward():
    """``tests/test_models_smoke.py::test_moe_ragged_matches_dense`` on the
    port: at a capacity factor of 8 nothing drops, so the two dispatches
    are one function; float32 logits within 1e-4, the same argmax."""
    cfg = dataclasses.replace(smoke_config("qwen3-moe-30b-a3b"),
                              compute_dtype="float32")
    cfg_r = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch="ragged", capacity_factor=8.0))
    cfg_d = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))
    params = params_from_numpy(numpy_params(cfg), device="cpu")
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 16))
    batch = {"tokens": torch.from_numpy(toks)}
    ld, lr = forward_lm(params, cfg_d, batch), forward_lm(params, cfg_r, batch)
    np.testing.assert_allclose(ld.numpy(), lr.numpy(), rtol=1e-4, atol=1e-4)
    assert torch.equal(ld.argmax(-1), lr.argmax(-1))


@pytest.mark.parametrize("arch", MOE)
def test_ragged_forward_matches_jax(arch):
    """The whole forward with ragged dispatch, in both packages."""
    jc, tc = _cfgs(arch, "float32", dispatch="ragged")
    npp = numpy_params(tc)
    toks = np.random.default_rng(33).integers(0, tc.vocab, (2, 12))
    a = jforward(jax.tree_util.tree_map(jnp.asarray, npp), jc,
                 {"tokens": jnp.asarray(toks, jnp.int32)})
    b = forward_lm(params_from_numpy(npp, device="cpu"), tc,
                   {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", MOE)
def test_compute_params_keeps_the_router_as_stored(arch):
    """The router stays in its stored dtype (float32 for qwen3-moe,
    bfloat16 for deepseek-v2), as the norm scales do; the experts take the
    compute dtype. A bfloat16 copy of qwen3-moe's float32 router would
    route some tokens otherwise."""
    cfg = smoke_config(arch)
    pd = getattr(torch, cfg.param_dtype)
    params = params_from_numpy(jax.tree_util.tree_map(
        lambda a: a.astype(jnp.dtype(cfg.param_dtype)),
        numpy_params(cfg)), device="cpu")
    layer = compute_params(params, cfg, "cpu")["layers"]["blk0_attn"]
    stored = params["layers"]["blk0_attn"]
    assert layer["router"].dtype == pd
    assert torch.equal(layer["router"], stored["router"])
    for k in ("we1", "we2", "we3", "ws1", "ws2", "ws3"):
        if k in stored:
            assert layer[k].dtype == torch.bfloat16, k
    if cfg.param_dtype == "float32":
        x = torch.from_numpy(np.random.default_rng(34).normal(
            0, 1, (1024, cfg.d_model)).astype(np.float32))
        w = stored["router"][0]
        keep = tmoe._top_k(torch.softmax(x @ w, -1), 2)[1]
        cast = tmoe._top_k(torch.softmax(
            x @ w.to(torch.bfloat16).float(), -1), 2)[1]
        assert not torch.equal(keep, cast)


# -------------------------------------------------------------------- K6


def _ragged_case(case, seed=35):
    """(lhs, rhs, group_sizes) as numpy float32 / int32 arrays."""
    rng = np.random.default_rng(seed)
    m, k, n, g = {"small": (40, 24, 20, 6), "wide": (96, 128, 72, 9),
                  "odd": (37, 33, 19, 5)}[case]
    sizes = rng.integers(0, 2 * m // g + 1, g)
    sizes[rng.integers(0, g, 2)] = 0          # empty groups
    while sizes.sum() > m - 5:                # rows past the sum
        sizes[sizes.argmax()] -= 1
    lhs = rng.normal(0, 1, (m, k)).astype(np.float32)
    rhs = (rng.normal(0, 1, (g, k, n)) / np.sqrt(k)).astype(np.float32)
    return lhs, rhs, sizes.astype(np.int32)


def _bf16_close(got, want, sums_tol=0.0):
    """Within one bf16 ulp of ``want``, plus ``sums_tol`` relative and
    absolute where the two float32 sums differ in more than order."""
    got, want = _np(got), _np(want)
    tol = BF16_ULP * np.abs(want) + sums_tol * (1 + np.abs(want))
    assert (np.abs(got - want) <= tol).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["small", "wide", "odd"])
def test_ragged_dot_plain_matches_jax(case, dtype):
    lhs, rhs, sizes = _ragged_case(case)
    jdt, tdt = DTYPES[dtype]
    want = jax.lax.ragged_dot(jnp.asarray(lhs).astype(jdt),
                              jnp.asarray(rhs).astype(jdt),
                              jnp.asarray(sizes))
    got = ragged_dot_plain(torch.from_numpy(lhs).to(tdt),
                           torch.from_numpy(rhs).to(tdt),
                           torch.from_numpy(sizes))
    assert got.dtype == tdt and got.shape == (lhs.shape[0], rhs.shape[2])
    assert not _np(got)[sizes.sum():].any()
    if dtype == "float32":
        np.testing.assert_allclose(_np(want), _np(got), rtol=F32_TOL,
                                   atol=F32_TOL)
    else:
        _bf16_close(got, want)


def test_ragged_dot_plain_cuts_groups_at_the_last_row():
    """A group running past row M is cut there, as the reference cuts it;
    a negative size counts as 0."""
    lhs, rhs, _ = _ragged_case("small")
    for sizes in ([10, 0, 50, 5, 0, 0], [10, -3, 20, 0, 0, 30]):
        sizes = np.asarray(sizes, np.int32)
        got = ragged_dot_plain(torch.from_numpy(lhs), torch.from_numpy(rhs),
                               torch.from_numpy(sizes))
        want = np.zeros((lhs.shape[0], rhs.shape[2]), np.float32)
        start = 0
        for g, s in enumerate(np.maximum(sizes, 0)):
            end = min(start + s, lhs.shape[0])
            want[start:end] = lhs[start:end] @ rhs[g]
            start = end
        np.testing.assert_allclose(want, got.numpy(), rtol=F32_TOL,
                                   atol=F32_TOL)
    # and the reference's own cut, where the sizes run past M
    sizes = np.asarray([10, 0, 50, 5, 0, 0], np.int32)
    ref = jax.lax.ragged_dot(jnp.asarray(lhs), jnp.asarray(rhs),
                             jnp.asarray(sizes))
    got = ragged_dot_plain(torch.from_numpy(lhs), torch.from_numpy(rhs),
                           torch.from_numpy(sizes))
    np.testing.assert_allclose(np.asarray(ref), got.numpy(), rtol=F32_TOL,
                               atol=F32_TOL)


def test_ragged_dot_wrapper_runs_the_plain_version_on_the_cpu():
    lhs, rhs, sizes = (torch.from_numpy(a) for a in _ragged_case("small"))
    before = ops.launch_counts()["ragged_dot"]
    assert torch.equal(ragged_dot(lhs, rhs, sizes),
                       ragged_dot_plain(lhs, rhs, sizes))
    assert ops.launch_counts()["ragged_dot"] == before


def _fmaf_chain(lhs, rhs, sizes):
    """K6's float32 arithmetic: each output one chain of single-rounding
    multiply-adds over k = 0 .. K - 1 in order, from 0 (``ref.fma_f32``);
    rows past the sum zero, groups cut at row M, negative sizes 0."""
    m, k = lhs.shape
    out = torch.zeros((m, rhs.shape[2]), dtype=torch.float32,
                      device=lhs.device)
    start = 0
    for g, size in enumerate(sizes.tolist()):
        end = min(start + max(int(size), 0), m)
        if end > start:
            acc = torch.zeros_like(out[start:end])
            for kk in range(k):
                acc = fma_f32(lhs[start:end, kk:kk + 1],
                              rhs[g, kk:kk + 1, :], acc)
            out[start:end] = acc
        start = end
    return out


@pytest.mark.parametrize("case", ["small", "wide", "odd"])
def test_fmaf_chain_matches_plain(case):
    """The bit-level reference of K6's float32 path computes ragged_dot."""
    lhs, rhs, sizes = (torch.from_numpy(a) for a in _ragged_case(case))
    got = _fmaf_chain(lhs, rhs, sizes)
    assert not got[int(sizes.sum()):].any()
    torch.testing.assert_close(got, ragged_dot_plain(lhs, rhs, sizes),
                               rtol=F32_TOL, atol=F32_TOL)


# (lhs shape, rhs shape, dtype, lhs offset in elements) -> K6's kernel
K6_PATHS = {
    "qwen3_we1_bf16": ((4096, 2048), (128, 2048, 768), "bfloat16", 0, "tma"),
    "deepseek_f32": ((3072, 5120), (160, 5120, 1536), "float32", 0, "tma"),
    "k_tail_bf16": ((300, 2056), (5, 2056, 256), "bfloat16", 0, "tma"),
    "n_tail_f32": ((300, 256), (5, 256, 776), "float32", 0, "tma"),
    "odd": ((333, 100), (7, 100, 70), "bfloat16", 0, "simple"),
    "k_off_vector_f32": ((64, 66), (4, 66, 64), "float32", 0, "simple"),
    "n_off_vector_bf16": ((64, 64), (4, 64, 36), "bfloat16", 0, "simple"),
    "view_16_byte": ((300, 264), (5, 264, 256), "bfloat16", 264, "tma"),
    "view_8_byte": ((64, 64), (4, 64, 64), "float32", 2, "simple"),
    "k_zero": ((64, 0), (4, 0, 64), "bfloat16", 0, "simple"),
    "no_groups": ((64, 64), (0, 64, 64), "float32", 0, "simple"),
}


@pytest.mark.parametrize("case", sorted(K6_PATHS))
def test_k6_path_is_chosen_by_shape_and_alignment(case):
    """TMA where a tensor map can describe lhs and rhs (K and N multiples
    of 16 bytes' worth of elements, K and G positive, 16-byte aligned
    bases, a view off a 128-byte line included), else the simple kernel.
    Only shapes and pointers are read, so CPU tensors stand in for the
    card's (rhs as one element expanded: its shape and an aligned
    address)."""
    (m, k), (g, k2, n), dtype, off, want = K6_PATHS[case]
    tdt = DTYPES[dtype][1]
    lhs = torch.empty(m * k + off, dtype=tdt)[off:].view(m, k)
    rhs = torch.empty((1, 1, 1), dtype=tdt).expand(g, k2, n)
    assert lhs.data_ptr() % 16 == (off * lhs.element_size()) % 16
    assert k6.path(lhs, rhs) == want


# ------------------------------------------------------------------ the card

# chip_smoke.py phase 17c's shapes: (M, K, N, G) of qwen3-moe's expert
# up- and down-projections at 2 x 256 tokens and deepseek-v2's at 512
K6_SHAPES = {"qwen3_we1": (4096, 2048, 768, 128),
             "qwen3_we2": (4096, 768, 2048, 128),
             "deepseek_v2_we1": (3072, 5120, 1536, 160)}


def _k6_inputs(m, k, n, g, dtype, device, seed=36, empty=False):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    if empty:  # empty groups and rows past the sum
        w = torch.rand(g, generator=gen)
        w[::3] = 0
        sizes = (w / w.sum() * (m - 100)).floor().to(torch.int32)
    else:  # a routing's load: every row in some group
        e = torch.randint(0, g, (m,), generator=gen)
        sizes = torch.bincount(e, minlength=g).to(torch.int32)
    lhs = torch.randn(m, k, generator=gen)
    rhs = torch.randn(g, k, n, generator=gen) / k ** 0.5
    tdt = DTYPES[dtype][1]
    return lhs.to(device, tdt), rhs.to(device, tdt), sizes.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", sorted(K6_SHAPES) + ["empty", "odd"])
def test_k6_matches_plain_on_cuda(cuda, shape, dtype):
    m, k, n, g = {"empty": (1000, 256, 192, 40),
                  "odd": (333, 100, 70, 7)}.get(shape, K6_SHAPES.get(shape))
    lhs, rhs, sizes = _k6_inputs(m, k, n, g, dtype, cuda,
                                 empty=shape == "empty")
    before = dict(ragged_dot.launches_by_path)
    got = ragged_dot(lhs, rhs, sizes)
    want = ragged_dot_plain(lhs, rhs, sizes)
    torch.cuda.synchronize()
    took = [p for p, c in ragged_dot.launches_by_path.items()
            if c != before[p]]
    assert took == ["simple" if shape == "odd" else "tma"]
    assert got.dtype == lhs.dtype and got.shape == (m, n)
    total = int(sizes.sum())
    assert not got[total:].any()
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=K6_F32_TOL,
                                   atol=K6_F32_TOL)
    else:  # the tensor cores' float32 sums against cuBLAS's
        _bf16_close(got, want, K6_F32_TOL)


# (M, K, N, G) and how the rows fall into the groups
K6_EDGES = {
    "big_groups": ((1000, 256, 256, 6), "uniform"),  # 2-3 row tiles a group
    "one_group": ((700, 256, 384, 9), "one"),        # every row in group 4
    "all_empty": ((300, 128, 256, 7), "zero"),       # every size 0
    "k_tail": ((300, 2056, 256, 5), "uniform"),      # K off BK, on 8
    "n_tail": ((300, 256, 776, 5), "uniform"),       # N off BN, on 8
    "past_m": ((400, 128, 128, 6), "past"),          # cut at M, a size < 0
    "view": ((300, 264, 256, 5), "uniform"),         # lhs off a 128-B line
    "many_items": ((8192, 128, 1024, 64), "uniform"),  # items > CTAs
}


def _k6_edge(case, dtype, device, seed=37):
    (m, k, n, g), kind = K6_EDGES[case]
    gen = torch.Generator(device="cpu").manual_seed(seed)
    if kind == "uniform":
        e = torch.randint(0, g, (m,), generator=gen)
        sizes = torch.bincount(e, minlength=g).to(torch.int32)
    else:
        sizes = torch.zeros(g, dtype=torch.int32)
        if kind == "one":
            sizes[4] = m
        elif kind == "past":
            sizes[:] = torch.tensor([100, -5, 250, 80, 0, 30])
    off = k if case == "view" else 0  # a row in: 16-byte aligned, not 128
    tdt = DTYPES[dtype][1]
    buf = torch.randn(m * k + off, generator=gen).to(device, tdt)
    lhs = buf[off:].view(m, k)
    rhs = (torch.randn(g, k, n, generator=gen) / k ** 0.5).to(device, tdt)
    return lhs, rhs, sizes.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(K6_EDGES))
def test_k6_edge_cases_on_cuda(cuda, case, dtype):
    """K6's TMA path where a row tile straddles nothing: groups over 64
    rows, one group holding every row, every size zero, K and N tails,
    groups cut at row M and a negative size, lhs as a view off a 128-byte
    line, more work items than CTAs. float32 equals the fmaf chain bit for
    bit; bfloat16 is within one ulp plus the float32 bound of the plain
    version."""
    lhs, rhs, sizes = _k6_edge(case, dtype, cuda)
    if case == "view":
        assert lhs.data_ptr() % 128 != 0 and lhs.data_ptr() % 16 == 0
    before = ragged_dot.launches_by_path["tma"]
    got = ragged_dot(lhs, rhs, sizes)
    torch.cuda.synchronize()
    assert ragged_dot.launches_by_path["tma"] == before + 1
    m = lhs.shape[0]
    total = min(int(sizes.clamp(min=0).sum()), m)
    assert not got[total:].any()
    if case == "all_empty":
        assert not got.any()
    want = ragged_dot_plain(lhs, rhs, sizes)
    if dtype == "float32":
        assert torch.equal(got, _fmaf_chain(lhs, rhs, sizes))
        torch.testing.assert_close(got, want, rtol=K6_F32_TOL,
                                   atol=K6_F32_TOL)
    else:
        _bf16_close(got, want, K6_F32_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["odd", "small", "wide"])
def test_k6_float32_is_the_fmaf_chain_on_cuda(cuda, shape):
    """float32 K6, on either path, bit for bit the fmaf chain of
    ``ref.fma_f32`` (the simple kernel at the odd shape, TMA otherwise)."""
    m, k, n, g = {"odd": (333, 100, 70, 7), "small": (200, 64, 128, 5),
                  "wide": (640, 512, 512, 12)}[shape]
    lhs, rhs, sizes = _k6_inputs(m, k, n, g, "float32", cuda,
                                 empty=shape == "small")
    got = ragged_dot(lhs, rhs, sizes)
    assert torch.equal(got, _fmaf_chain(lhs, rhs, sizes))


@pytest.mark.gpu
def test_k6_never_syncs_the_host(cuda):
    """Under ``set_sync_debug_mode("error")`` any host sync raises: the
    wrapper reads no group size on the host, and neither does
    ``moe_ragged`` around it."""
    lhs, rhs, sizes = _k6_inputs(512, 256, 128, 16, "bfloat16", cuda)
    _, tc = _cfgs("qwen3-moe-30b-a3b", "bfloat16", dispatch="ragged")
    _, tp = _layer0("qwen3-moe-30b-a3b")
    gp = {k: v.to(cuda) for k, v in compute_params(tp, tc, "cpu").items()}
    _, tx = _x(tc, "bfloat16")
    x = tx.to(cuda)
    ragged_dot(lhs, rhs, sizes)  # builds and loads the library first
    tmoe.moe_ragged(x, gp, tc)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        before = ops.launch_counts()["ragged_dot"]
        ragged_dot(lhs, rhs, sizes)
        tmoe.moe_ragged(x, gp, tc)
        assert ops.launch_counts()["ragged_dot"] == before + 4
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.gpu
@pytest.mark.parametrize("dispatch", ["dense", "ragged"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_layer_on_cuda_matches_cpu(cuda, arch, dispatch):
    """float32 on the card (TF32 off) against the CPU; ragged through K6."""
    assert not torch.backends.cuda.matmul.allow_tf32
    _, tc = _cfgs(arch, "float32", dispatch=dispatch)
    _, tp = _layer0(arch)
    _, tx = _x(tc, "float32")
    before = ops.launch_counts()["ragged_dot"]
    got = tmoe.moe_layer(tx.to(cuda), {k: v.to(cuda) for k, v in tp.items()},
                         tc)
    launched = ops.launch_counts()["ragged_dot"] - before
    assert launched == (3 if dispatch == "ragged" else 0)
    torch.testing.assert_close(got.cpu(), tmoe.moe_layer(tx, tp, tc),
                               rtol=K6_F32_TOL, atol=K6_F32_TOL)
