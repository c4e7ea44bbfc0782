"""K6's backward: ``ragged_dot``'s gradients (``kernels.ragged_dot``:
K6 over the output's gradient and rhs read transposed for lhs, K6w for
rhs) against ``jax.grad`` of ``jax.lax.ragged_dot``, K6w's plain version
(``ragged_dot_wgrad_plain``) against a per-group loop, the kernels' path
choices, and ``moe_ragged``'s gradients against ``moe_dense``'s, on the CPU
(and on the card where marked: K6w's TMA path against its plain version
and, in float32, bit for bit against its simple kernel; K6's dgrad mode
against K6 over a transposed copy of rhs).

Tolerances. float32: within ``F32_TOL`` = 1e-4, relative and absolute, as
K6's forward is held (the frameworks sum the same products in other
orders). bfloat16: within one bf16 ulp of the reference's value plus
``F32_TOL`` relative and absolute: each side rounds a float32 sum of the
same products once, and the sums differ in order only. On the card K6w is
held to its plain version the same way (its fmaf chain over a group's rows
against cuBLAS's blocked sums), and two K6w calls must give the same bits.
The MoE layer's gradients through the ragged dispatch are held to the
dense dispatch's (at capacity 8, where nothing drops, the two are one
function) within ``F32_TOL`` in float32.
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401 — x64, as in the full system
import jax
import jax.numpy as jnp
from repro_torch.configs import smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels import ragged_dot as rd
from repro_torch.kernels.ragged_dot import ragged_dot, ragged_dot_wgrad
from repro_torch.kernels.ref import ragged_dot_plain, ragged_dot_wgrad_plain
from repro_torch.models import moe as tmoe
from repro_torch.models import params_from_numpy
from tests.test_torch_models import DTYPES, _np, numpy_params
from tests.test_torch_moe import BF16_ULP, _ragged_case

F32_TOL = 1e-4
MOE = ["qwen3-moe-30b-a3b", "deepseek-v2-236b"]
# sizes that run past M = 40 (the "small" case's lhs); and with a negative
# size, which the port counts as 0 (the reference's rows are then not any
# one group's: only the per-group loop holds that case)
EDGE_SIZES = {"past_m": [10, 0, 50, 5, 0, 0],
              "negative": [10, -3, 20, 0, 0, 30]}


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


def _case(case):
    """(lhs, rhs, sizes, dout) as numpy: the K6 tests' cases (empty groups
    and rows past the sum), and ``EDGE_SIZES``' over the "small" case."""
    lhs, rhs, sizes = _ragged_case("small" if case in EDGE_SIZES else case)
    if case in EDGE_SIZES:
        sizes = np.asarray(EDGE_SIZES[case], np.int32)
    dout = np.random.default_rng(41).normal(
        0, 1, (lhs.shape[0], rhs.shape[2])).astype(np.float32)
    return lhs, rhs, sizes, dout


def _close(got, want, dtype):
    got, want = _np(got), _np(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    else:
        tol = BF16_ULP * np.abs(want) + F32_TOL * (1 + np.abs(want))
        assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


def _port_grads(lhs, rhs, sizes, dout):
    """(out, dlhs, drhs) of ``ragged_dot`` by autograd."""
    lhs = lhs.detach().requires_grad_(True)
    rhs = rhs.detach().requires_grad_(True)
    out = ragged_dot(lhs, rhs, sizes)
    out.backward(dout)
    return out.detach(), lhs.grad, rhs.grad


def _rows(sizes, m):
    """Rows in some group, as the reference cuts them."""
    return min(int(np.maximum(sizes, 0).sum()), m)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["small", "wide", "odd", "past_m"])
def test_ragged_dot_grads_match_jax(case, dtype):
    lhs, rhs, sizes, dout = _case(case)
    jdt, tdt = DTYPES[dtype]
    jl, jr, jd = (jnp.asarray(a).astype(jdt) for a in (lhs, rhs, dout))
    _, vjp = jax.vjp(
        lambda a, b: jax.lax.ragged_dot(a, b, jnp.asarray(sizes)), jl, jr)
    want_l, want_r = vjp(jd)
    out, got_l, got_r = _port_grads(
        *(torch.from_numpy(a).to(tdt) for a in (lhs, rhs)),
        torch.from_numpy(sizes), torch.from_numpy(dout).to(tdt))
    assert got_l.dtype == tdt and got_r.dtype == tdt
    assert got_l.shape == lhs.shape and got_r.shape == rhs.shape
    _close(got_l, want_l, dtype)
    _close(got_r, want_r, dtype)
    # rows past the sum get exact zeros; empty groups too
    assert not _np(got_l)[_rows(sizes, lhs.shape[0]):].any()
    start, m = 0, lhs.shape[0]
    for g, s in enumerate(np.maximum(sizes, 0)):
        if min(start + s, m) == start:
            assert not _np(got_r[g]).any(), g
        start = min(start + s, m)


@pytest.mark.parametrize("case",
                         ["small", "wide", "odd", "past_m", "negative"])
def test_wgrad_plain_matches_a_group_loop(case):
    """``ragged_dot_wgrad_plain`` against numpy, group by group, in
    float64: each group's rows cut as ``ragged_dot_plain`` cuts them."""
    lhs, rhs, sizes, dout = _case(case)
    got = ragged_dot_wgrad_plain(torch.from_numpy(lhs),
                                 torch.from_numpy(dout),
                                 torch.from_numpy(sizes), rhs.shape[0])
    want = np.zeros(rhs.shape)
    start, m = 0, lhs.shape[0]
    for g, s in enumerate(np.maximum(sizes, 0)):
        end = min(start + s, m)
        want[g] = lhs[start:end].astype(np.float64).T @ dout[start:end]
        start = end
    assert got.dtype == torch.float32 and got.shape == rhs.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


def test_cpu_backward_runs_the_plain_versions():
    """On CPU tensors both directions are the plain versions, bit for
    bit, and no kernel launch is counted."""
    lhs, rhs, sizes, dout = (torch.from_numpy(a) for a in _case("wide"))
    before = ops.launch_counts()
    _, dl, dr = _port_grads(lhs, rhs, sizes, dout)
    assert torch.equal(dl, ragged_dot_plain(dout, rhs.transpose(1, 2),
                                            sizes))
    assert torch.equal(dr, ragged_dot_wgrad_plain(lhs, dout, sizes,
                                                  rhs.shape[0]))
    assert torch.equal(dr, ragged_dot_wgrad(lhs, dout, sizes, rhs.shape[0]))
    assert ops.launch_counts() == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["small", "wide", "odd", "past_m"])
def test_cpu_data_gradient_reads_rhs_in_place(case, dtype, monkeypatch):
    """The CPU backward hands the plain version rhs's transposed view (no
    copy: the view shares rhs's storage), and its lhs gradient equals
    ``jax.vjp``'s."""
    lhs, rhs, sizes, dout = _case(case)
    jdt, tdt = DTYPES[dtype]
    seen = []

    def spy(a, b, gs):
        seen.append(b)
        return ragged_dot_plain(a, b, gs)

    monkeypatch.setattr(rd, "ragged_dot_plain", spy)
    t_rhs = torch.from_numpy(rhs).to(tdt)
    _, got_l, _ = _port_grads(torch.from_numpy(lhs).to(tdt), t_rhs,
                              torch.from_numpy(sizes),
                              torch.from_numpy(dout).to(tdt))
    assert len(seen) == 2  # the forward, then the data gradient
    view = seen[1]
    assert view.shape == (rhs.shape[0], rhs.shape[2], rhs.shape[1])
    assert view.data_ptr() == t_rhs.data_ptr() and not view.is_contiguous()
    jl, jr, jd = (jnp.asarray(a).astype(jdt) for a in (lhs, rhs, dout))
    _, vjp = jax.vjp(
        lambda a, b: jax.lax.ragged_dot(a, b, jnp.asarray(sizes)), jl, jr)
    _close(got_l, vjp(jd)[0], dtype)


@pytest.mark.parametrize("case", ["small", "wide", "odd", "past_m",
                                  "negative"])
def test_k6_trans_mode_on_cpu_is_the_transposed_product(case):
    """``_k6(..., trans=True)`` on CPU tensors: rhs stored [G, K, N] read
    as [G, N, K], against numpy group by group in float64 (rows past the
    sum zero, each group's rows cut as the reference cuts them)."""
    lhs, rhs, sizes, dout = _case(case)
    got = rd._k6(torch.from_numpy(dout), torch.from_numpy(rhs),
                 torch.from_numpy(sizes), trans=True)
    want = np.zeros(lhs.shape)
    start, m = 0, lhs.shape[0]
    for g, size in enumerate(np.maximum(sizes, 0)):
        end = min(start + size, m)
        want[start:end] = dout[start:end].astype(np.float64) @ rhs[g].T
        start = end
    assert got.dtype == torch.float32 and got.shape == lhs.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


def _fmaf_rows(a, b, block=None):
    """K6w's float32 sum of ``a.T @ b`` over the rows, as the kernels run
    it: one fmaf chain from 0 over the rows in order (each step rounded
    once: the float32 product is exact in float64), or with ``block`` one
    chain per ``block`` rows, the blocks' sums added in order."""
    total = np.zeros((a.shape[1], b.shape[1]), np.float32)
    acc = np.zeros_like(total)
    for r in range(a.shape[0]):
        acc = (acc.astype(np.float64) + np.outer(
            a[r].astype(np.float64), b[r].astype(np.float64))).astype(
            np.float32)
        if block and ((r + 1) % block == 0 or r + 1 == a.shape[0]):
            total, acc = total + acc, np.zeros_like(acc)
    return total if block else acc


def test_blocked_sums_on_a_long_group():
    """Why float32 K6w sums a group in blocks of 128 rows: over 3,500 rows
    of unit normals one fmaf chain drifts past ``F32_TOL`` of the float64
    sum (1.8 times it), the blocks stay within a third of it (0.28), closer
    than the CPU's matmul (the plain version, 0.46)."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3500, 128)).astype(np.float32)
    b = rng.standard_normal((3500, 96)).astype(np.float32)
    exact = a.astype(np.float64).T @ b.astype(np.float64)
    tol = F32_TOL * (1 + np.abs(exact))
    chain = np.abs(_fmaf_rows(a, b) - exact) / tol
    blocks = np.abs(_fmaf_rows(a, b, 128) - exact) / tol
    plain = np.abs(ragged_dot_wgrad_plain(
        torch.from_numpy(a), torch.from_numpy(b),
        torch.tensor([3500], dtype=torch.int32), 1)[0].numpy() - exact) / tol
    assert chain.max() > 1 and blocks.max() < 1 / 3
    assert blocks.max() < plain.max()


# (M, K, N, dtype, element offset of lhs's view) -> K6w's path
WGRAD_PATHS = {
    "bf16_aligned": ((64, 2048, 768, "bfloat16", 0), "tma"),
    "f32_aligned": ((64, 768, 2048, "float32", 0), "tma"),
    "bf16_k_on_8": ((64, 200, 72, "bfloat16", 0), "tma"),
    "f32_n_on_4": ((64, 100, 68, "float32", 0), "tma"),
    "bf16_k_off_8": ((64, 100, 64, "bfloat16", 0), "simple"),
    "bf16_n_off_8": ((64, 64, 70, "bfloat16", 0), "simple"),
    "f32_n_off_4": ((64, 64, 70, "float32", 0), "simple"),
    "empty_m": ((0, 64, 64, "float32", 0), "simple"),
    "view_off_16": ((64, 64, 64, "float32", 1), "simple"),
    "view_on_16": ((64, 64, 64, "bfloat16", 8), "tma"),
}


@pytest.mark.parametrize("case", sorted(WGRAD_PATHS))
def test_wgrad_path_by_shape_and_alignment(case):
    """K6w's path depends on shape and alignment only, so it is decided
    the same on CPU tensors: TMA where K and N are multiples of the
    16-byte vector, M is positive and the bases are 16-byte aligned."""
    (m, k, n, dtype, off), want = WGRAD_PATHS[case]
    tdt = DTYPES[dtype][1]
    buf = torch.zeros(m * k + off + 64, dtype=tdt)
    base = (-buf.data_ptr() // buf.element_size()) % (64 // buf.element_size())
    lhs = buf[base + off:base + off + m * k].view(m, k)
    dout = torch.zeros(m, n, dtype=tdt)
    assert rd.wgrad_path(lhs, dout) == want
    # the data gradient's K6 takes (dout, rhs [G, K, N]) by the same test
    rhs = torch.zeros(3, k, n, dtype=tdt)
    if off == 0 and m > 0:
        assert rd.path(dout, rhs) == want


def test_launch_counts_reset_by_path():
    """``ops.reset_launch_counts`` zeroes K6's and K6w's counts by path,
    the dgrad mode's key included."""
    assert set(ragged_dot.launches_by_path) == {"tma", "tma_dgrad",
                                                "simple"}
    assert set(ragged_dot_wgrad.launches_by_path) == {"tma", "simple"}
    ragged_dot_wgrad.launches_by_path["tma"] += 3
    ragged_dot.launches_by_path["tma_dgrad"] += 2
    ops.reset_launch_counts()
    assert not any(ragged_dot_wgrad.launches_by_path.values())
    assert not any(ragged_dot.launches_by_path.values())


def test_only_the_inputs_that_need_a_gradient_get_one():
    """A frozen rhs takes no K6w; a frozen lhs no data gradient."""
    lhs, rhs, sizes, dout = (torch.from_numpy(a) for a in _case("small"))
    a = lhs.clone().requires_grad_(True)
    ragged_dot(a, rhs, sizes).backward(dout)
    assert a.grad is not None and rhs.grad is None
    b = rhs.clone().requires_grad_(True)
    ragged_dot(lhs, b, sizes).backward(dout)
    assert b.grad is not None and lhs.grad is None
    with torch.no_grad():
        assert ragged_dot(a, b, sizes).grad_fn is None


def _layer_grads(cfg, p, x):
    """(output, d x, d each parameter) of the MoE layer under ``cfg`` for
    a fixed random output gradient."""
    p = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    x = x.detach().requires_grad_(True)
    out = tmoe.moe_layer(x, p, cfg)
    dout = torch.from_numpy(np.random.default_rng(42).normal(
        0, 1, tuple(out.shape)).astype(np.float32)).to(out.device)
    names = sorted(p)
    grads = torch.autograd.grad(out, [x] + [p[k] for k in names], dout,
                                allow_unused=True)
    return out.detach(), dict(zip(["x"] + names, grads))


def _moe_inputs(cfg):
    """Layer 0's MoE weights (the router, the experts and any shared
    expert; float32 numpy weights) and an input (2, 8, d)."""
    npp = numpy_params(cfg)
    p = params_from_numpy({k: v[0] for k, v in
                           npp["layers"]["blk0_attn"].items()
                           if k == "router" or k[:2] in ("we", "ws")},
                          device="cpu")
    x = torch.from_numpy(np.random.default_rng(43).normal(
        0, 1, (2, 8, cfg.d_model)).astype(np.float32))
    return p, x


@pytest.mark.parametrize("arch", MOE)
def test_moe_ragged_grads_match_dense(arch):
    """``test_moe_ragged_matches_dense``'s setting (capacity 8: nothing
    drops, so the two dispatches are one function), backwards: the input's
    and every weight's gradient of the ragged dispatch (through K6 and K6w
    on the card, their plain versions here) equal the dense dispatch's
    within ``F32_TOL``. An expert that took no token gets exact zeros."""
    base = dataclasses.replace(smoke_config(arch), compute_dtype="float32")
    cfg_r, cfg_d = (dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, dispatch=d, capacity_factor=8.0))
        for d in ("ragged", "dense"))
    p, x = _moe_inputs(base)
    out_r, g_r = _layer_grads(cfg_r, p, x)
    out_d, g_d = _layer_grads(cfg_d, p, x)
    np.testing.assert_allclose(out_r.numpy(), out_d.numpy(), rtol=F32_TOL,
                               atol=F32_TOL)
    assert set(g_r) == set(g_d)
    for name in g_r:
        assert g_r[name] is not None, name
        np.testing.assert_allclose(g_r[name].numpy(), g_d[name].numpy(),
                                   rtol=F32_TOL, atol=F32_TOL, err_msg=name)
    _, top_i = tmoe._router(x.reshape(-1, base.d_model), p, cfg_r,
                            torch.float32)
    took = torch.bincount(top_i.reshape(-1), minlength=base.moe.n_experts)
    for w in ("we1", "we2", "we3"):
        per_expert = g_r[w].reshape(base.moe.n_experts, -1).abs().amax(1)
        assert bool((per_expert[took == 0] == 0).all()), w
        assert bool((per_expert[took > 0] > 0).all()), w


# ------------------------------------------------------------------ the card


def _card_case(m, k, n, g, dtype, device, seed=44):
    """Inputs on ``device``: every third group empty and 7 rows past the
    sum."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    w = torch.rand(g, generator=gen)
    w[::3] = 0
    sizes = (w / w.sum() * (m - 7)).floor().to(torch.int32)
    lhs = torch.randn(m, k, generator=gen)
    dout = torch.randn(m, n, generator=gen)
    rhs = torch.randn(g, k, n, generator=gen) / k ** 0.5
    tdt = DTYPES[dtype][1]
    return (lhs.to(device, tdt), rhs.to(device, tdt), sizes.to(device),
            dout.to(device, tdt))


# (M, K, N, G): smoke-sized expert projections, and tile edges off 64
CARD_SHAPES = {"smoke_up": (256, 64, 96, 8), "smoke_down": (256, 96, 64, 8),
               "odd": (333, 100, 70, 7)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
def test_wgrad_matches_plain_on_cuda(cuda, shape, dtype):
    lhs, _, sizes, dout = _card_case(*CARD_SHAPES[shape], dtype, cuda)
    g = sizes.shape[0]
    before = ragged_dot_wgrad.launches
    got = ragged_dot_wgrad(lhs, dout, sizes, g)
    again = ragged_dot_wgrad(lhs, dout, sizes, g)
    want = ragged_dot_wgrad_plain(lhs, dout, sizes, g)
    torch.cuda.synchronize()
    assert ragged_dot_wgrad.launches == before + 2
    assert torch.equal(got, again)  # no atomics: the same bits
    assert not got[sizes.cpu() == 0].any()
    _close(got.cpu(), want.cpu(), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
def test_backward_matches_plain_on_cuda(cuda, shape, dtype):
    """The Function's backward on the card (K6 for lhs, K6w for rhs)
    against the plain versions' on the same inputs."""
    lhs, rhs, sizes, dout = _card_case(*CARD_SHAPES[shape], dtype, cuda)
    k6, k6w = ragged_dot.launches, ragged_dot_wgrad.launches
    _, dl, dr = _port_grads(lhs, rhs, sizes, dout)
    torch.cuda.synchronize()
    assert ragged_dot.launches == k6 + 2 and ragged_dot_wgrad.launches == \
        k6w + 1
    _close(dl.cpu(), ragged_dot_plain(dout, rhs.transpose(1, 2).contiguous(),
                                      sizes).cpu(), dtype)
    _close(dr.cpu(), ragged_dot_wgrad_plain(lhs, dout, sizes,
                                            rhs.shape[0]).cpu(), dtype)
    assert not dl[int(sizes.sum()):].any()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", MOE)
def test_moe_ragged_grads_on_cuda_match_cpu(cuda, arch):
    """The MoE layer's ragged backward on the card launches K6w and gives
    every expert weight the CPU's gradient (float32, TF32 off)."""
    assert not torch.backends.cuda.matmul.allow_tf32
    base = dataclasses.replace(smoke_config(arch), compute_dtype="float32")
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, dispatch="ragged"))
    p, x = _moe_inputs(base)
    before = ops.launch_counts()["ragged_dot_wgrad"]
    _, card = _layer_grads(cfg, {k: v.to(cuda) for k, v in p.items()},
                           x.to(cuda))
    torch.cuda.synchronize()
    assert ops.launch_counts()["ragged_dot_wgrad"] == before + 3
    _, host = _layer_grads(cfg, p, x)
    for name, g in host.items():
        np.testing.assert_allclose(card[name].cpu().numpy(), g.numpy(),
                                   rtol=F32_TOL, atol=F32_TOL, err_msg=name)
    assert all(bool(card[w].abs().amax() > 0) for w in ("we1", "we2", "we3"))


# K6w's TMA path at its edges: (M, K, N, G) and how the rows fall
WGRAD_EDGES = {
    "long_group": ((3600, 256, 192, 4), "long"),  # 3,500 rows: the ring wraps
    "one_row_groups": ((300, 128, 136, 200), "ones"),  # 200 groups of 1 row
    "boundaries": ((400, 200, 72, 10), "ragged"),   # inside k-steps and boxes
    "tails": ((500, 200, 72, 9), "uniform"),        # K, N on 8, off 128
    "g160": ((1000, 256, 192, 160), "uniform"),
    "all_empty": ((300, 128, 256, 7), "zero"),
    "past": ((700, 136, 264, 40), "past"),          # past the sum and M
    "view": ((300, 64, 64, 5), "uniform"),          # lhs off 16 bytes
}


def _wgrad_edge(case, dtype, device, seed=45):
    (m, k, n, g), kind = WGRAD_EDGES[case]
    gen = torch.Generator(device="cpu").manual_seed(seed)
    sizes = torch.zeros(g, dtype=torch.int32)
    if kind == "uniform":
        e = torch.randint(0, g, (m,), generator=gen)
        sizes = torch.bincount(e, minlength=g).to(torch.int32)
    elif kind == "long":
        sizes[1] = 3500
    elif kind == "ones":
        sizes[:] = 1
    elif kind == "ragged":  # 3 + 17 + 29 + 1: inside one 64-row box
        sizes[:] = torch.tensor([3, 17, 29, 1, 0, 70, 9, 64, 65, 13])
    elif kind == "past":  # a size below 0; the sizes sum past M
        sizes[:6] = torch.tensor([5, 37, 0, 100, 200, -3])
        sizes[6:] = 50
    tdt = DTYPES[dtype][1]
    off = 1 if case == "view" else 0
    buf = torch.randn(m * k + off, generator=gen).to(device, tdt)
    lhs = buf[off:].view(m, k)
    dout = torch.randn(m, n, generator=gen).to(device, tdt)
    return lhs, dout, sizes.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(WGRAD_EDGES))
def test_wgrad_edge_cases_on_cuda(cuda, case, dtype):
    """K6w at its edges: the TMA path (the simple one for a view off 16
    bytes) within ``_close`` of the plain version, twice the same bits,
    exact zeros for empty groups, and in float32 the simple kernel's bits
    on the same inputs."""
    lhs, dout, sizes = _wgrad_edge(case, dtype, cuda)
    g = sizes.shape[0]
    want_path = "simple" if case == "view" else "tma"
    assert rd.wgrad_path(lhs, dout) == want_path
    before = dict(ragged_dot_wgrad.launches_by_path)
    got = ragged_dot_wgrad(lhs, dout, sizes, g)
    again = ragged_dot_wgrad(lhs, dout, sizes, g)
    simple = rd._k6w(lhs, dout, sizes, g, "simple")
    torch.cuda.synchronize()
    after = ragged_dot_wgrad.launches_by_path
    assert after[want_path] - before[want_path] == (3 if case == "view"
                                                    else 2)
    assert torch.equal(got, again)
    assert not got[sizes.cpu() <= 0].any()
    if dtype == "float32":
        assert torch.equal(got, simple)
    want = ragged_dot_wgrad_plain(lhs, dout, sizes, g)
    _close(got.cpu(), want.cpu(), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", ["smoke_up", "smoke_down", "g160",
                                   "tails"])
def test_dgrad_mode_matches_the_copy_on_cuda(cuda, shape, dtype):
    """K6's dgrad mode (rhs read transposed in place) against K6 over a
    transposed copy: bit for bit in float32 (one fmaf chain over the
    reduction in order), within ``_close`` in bfloat16; counted under
    ``"tma_dgrad"``."""
    m, k, n, g = {**CARD_SHAPES, "g160": (1000, 256, 192, 160),
                  "tails": (500, 200, 72, 9)}[shape]
    lhs, rhs, sizes, dout = _card_case(m, k, n, g, dtype, cuda)
    assert rd.path(dout, rhs) == "tma"
    before = dict(ragged_dot.launches_by_path)
    got = rd._k6(dout, rhs, sizes, trans=True)
    want = rd._k6(dout, rhs.transpose(1, 2).contiguous(), sizes)
    torch.cuda.synchronize()
    now = ragged_dot.launches_by_path
    assert (now["tma_dgrad"] - before["tma_dgrad"],
            now["tma"] - before["tma"]) == (1, 1)
    assert got.shape == lhs.shape
    if dtype == "float32":
        assert torch.equal(got, want)
    else:
        _close(got.cpu(), want.cpu(), dtype)
    assert not got[int(sizes.sum()):].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_paths_on_cuda(cuda, dtype):
    """On a TMA shape autograd's backward runs K6 in its dgrad mode and
    K6w on its TMA path, with no transposed copy of rhs: the backward's
    peak stays below its two gradients and half of rhs; on a shape off
    the vector (the simple paths) K6 runs over the copy."""
    lhs, rhs, sizes, dout = _card_case(1024, 256, 512, 16, dtype, cuda)
    a, b = (t.detach().requires_grad_(True) for t in (lhs, rhs))
    out = ragged_dot(a, b, sizes)
    k6, k6w = (dict(f.launches_by_path) for f in (ragged_dot,
                                                   ragged_dot_wgrad))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out.backward(dout)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    grads = (lhs.numel() + rhs.numel()) * lhs.element_size()
    assert peak < grads + rhs.numel() * rhs.element_size() // 2, peak
    assert ragged_dot.launches_by_path["tma_dgrad"] == k6["tma_dgrad"] + 1
    assert ragged_dot_wgrad.launches_by_path["tma"] == k6w["tma"] + 1
    lhs, rhs, sizes, dout = _card_case(*CARD_SHAPES["odd"], dtype, cuda)
    k6, k6w = (dict(f.launches_by_path) for f in (ragged_dot,
                                                   ragged_dot_wgrad))
    _port_grads(lhs, rhs, sizes, dout)
    torch.cuda.synchronize()
    assert ragged_dot.launches_by_path["simple"] == k6["simple"] + 2
    assert ragged_dot.launches_by_path["tma_dgrad"] == k6["tma_dgrad"]
    assert ragged_dot_wgrad.launches_by_path["simple"] == k6w["simple"] + 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tma_launches_from_a_fresh_thread(cuda, dtype):
    """K6, its dgrad mode and K6w launched from a thread whose only CUDA
    work is theirs (as autograd's worker runs a backward; every output is
    served from PyTorch's cache, so nothing else makes a context current
    there): each encodes its tensor maps and gives the main thread's
    bits."""
    lhs, rhs, sizes, dout = _card_case(*CARD_SHAPES["smoke_up"], dtype, cuda)
    g = sizes.shape[0]
    calls = {"k6": lambda: rd._k6(lhs, rhs, sizes),
             "dgrad": lambda: rd._k6(dout, rhs, sizes, trans=True),
             "k6w": lambda: ragged_dot_wgrad(lhs, dout, sizes, g)}
    want = {name: fn() for name, fn in calls.items()}
    spare = [fn() for fn in calls.values()]  # blocks the thread reuses
    torch.cuda.synchronize()
    del spare
    got = {}

    def run():
        try:
            for name, fn in calls.items():
                got[name] = fn()
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 — reported below
            got["error"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and "error" not in got, got.get("error")
    for name in calls:
        assert torch.equal(got[name], want[name]), name
