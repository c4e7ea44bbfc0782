"""K6's backward: ``ragged_dot``'s gradients (``kernels.ragged_dot``:
K6 over the output's gradient and rhs transposed for lhs, K6w for rhs)
against ``jax.grad`` of ``jax.lax.ragged_dot``, K6w's plain version
(``ragged_dot_wgrad_plain``) against a per-group loop, and ``moe_ragged``'s
gradients against ``moe_dense``'s, on the CPU (and on the card where
marked).

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

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401 — x64, as in the full system
import jax
import jax.numpy as jnp
from repro_torch.configs import smoke_config
from repro_torch.kernels import ops
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
