"""K8, the spline corridor, on the card (skipped without one): the kernel
pair's knot indices against the host loop (``_greedy_spline_knots``) on
the cases below and at the benchmark cell's scale (16M ``wikits`` keys at
the positions of the paper's index), an ``UpLIF`` built on the card
against one built on the CPU, the launches a build makes and the scratch
it leaves. No JAX here: ``tests/test_torch_spline_build.py`` holds the
plain version and the host loop to the JAX package's loop on the same
cases."""
import numpy as np
import pytest
import torch

from repro_torch.core import UpLIF, UpLIFConfig
from repro_torch.core.gmm import init_gmm_uniform
from repro_torch.core.nullifier import nullify
from repro_torch.core.radix_spline import (
    _DEF_WINDOW,
    _greedy_spline_knots,
    build_radix_spline,
)
from repro_torch.data.datasets import make_fb, make_wikits
from repro_torch.kernels import ops
from repro_torch.kernels.spline_corridor import spline_corridor

CASES = ("wikits", "fb", "n0", "n1", "n2", "linear_cap", "max_error_0",
         "near_2_63")
CELL_KEYS = 16_000_000


def cell_positions(keys):
    """The slot positions a bulk load of sorted ``keys`` gives them with
    the paper's index (``UpLIFConfig()``: alpha 1.0, d_max 32, W 64), as
    ``UpLIF._bulk_load`` calls ``nullify``."""
    cfg = UpLIFConfig()
    gmm = init_gmm_uniform(float(keys[0]), float(keys[-1]),
                           cfg.gmm_components)
    return nullify(keys, keys, gmm, alpha_target=cfg.alpha_target,
                   d_max=cfg.d_max, tail_slack=max(64, cfg.window),
                   align=cfg.window, device="cpu").positions


def make_case(case: str):
    """(keys, positions, max_error) of one case: sorted unique int64 keys
    and int64 positions."""
    r = np.random.default_rng(CASES.index(case))
    if case in ("wikits", "fb"):
        make = make_wikits if case == "wikits" else make_fb
        keys = np.unique(make(100_000, 3))
        return keys, cell_positions(keys), UpLIFConfig().max_error
    if case in ("n0", "n1", "n2"):
        n = int(case[1])
        return (np.arange(n, dtype=np.int64) * 1000 + 5,
                np.arange(n, dtype=np.int64) * 3, 24)
    if case == "linear_cap":  # one straight line: segments end at the cap
        n = _DEF_WINDOW + 64
        return (10**9 + 7 * np.arange(n, dtype=np.int64),
                3 * np.arange(n, dtype=np.int64), 24)
    if case == "max_error_0":
        keys = np.unique(make_wikits(4_000, 4))
        return keys, cell_positions(keys), 0
    # near 2^63 float64 keys are 1024 apart, so neighbouring keys round to
    # one float64: dx is 0, slopes are inf, and a bound whose numerator is
    # 0 as well is NaN
    keys = ((1 << 63) - 1) - np.cumsum(r.integers(1, 300, 5000))[::-1]
    positions = np.cumsum(r.integers(1, 3, 5000)).astype(np.int64)
    return keys.astype(np.int64), positions, 2


def host_knots(keys, positions, max_error):
    with np.errstate(divide="ignore", invalid="ignore"):
        return _greedy_spline_knots(keys, positions, max_error)


def device_knots(keys, positions, max_error, device):
    return spline_corridor(torch.as_tensor(keys, device=device),
                           torch.as_tensor(positions, device=device),
                           max_error, _DEF_WINDOW)


def _storages(tree):
    """The distinct storages of the tensors in a tree of named tuples."""
    if isinstance(tree, torch.Tensor):
        return {tree.untyped_storage().data_ptr(): tree.untyped_storage()}
    out = {}
    for leaf in tree:
        out.update(_storages(leaf))
    return out


def _allocated_for(storages, device) -> int:
    """What the caching allocator counts for fresh storages of the same
    sizes (it rounds each allocation up)."""
    before = torch.cuda.memory_allocated(device)
    held = [torch.empty(s.nbytes(), dtype=torch.uint8, device=device)
            for s in storages.values()]
    grown = torch.cuda.memory_allocated(device) - before
    del held
    return grown


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
def test_k8_equals_the_host_loop(cuda, case):
    keys, positions, max_error = make_case(case)
    ops.reset_launch_counts()
    got = device_knots(keys, positions, max_error, cuda)
    torch.cuda.synchronize()
    assert ops.launch_counts()["spline_corridor"] == (2 if len(keys) > 1
                                                      else 0)
    assert got.dtype == torch.int64 and got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  host_knots(keys, positions, max_error))


@pytest.mark.gpu
def test_k8_equals_the_host_loop_at_the_cell_scale(cuda):
    keys = np.unique(make_wikits(CELL_KEYS, 0))
    positions = cell_positions(keys)
    got = device_knots(keys, positions, UpLIFConfig().max_error, cuda)
    np.testing.assert_array_equal(
        got.cpu().numpy(),
        host_knots(keys, positions, UpLIFConfig().max_error))


@pytest.mark.gpu
def test_an_index_built_on_the_card_equals_one_built_on_the_cpu(cuda):
    keys = np.unique(make_wikits(300_000, 5))
    host = UpLIF(keys, keys * 2 + 1, device="cpu")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda)
    ops.reset_launch_counts()
    card = UpLIF(keys, keys * 2 + 1, device=cuda)
    torch.cuda.synchronize()
    assert ops.launch_counts()["spline_corridor"] == 2
    grown = torch.cuda.memory_allocated(cuda) - base
    # no scratch outlives the build: what it holds is the live index
    assert grown == _allocated_for(_storages(card.fstate), cuda)
    assert card.rs_static == host.rs_static
    for part in ("slots", "model"):
        for name, a, b in zip(getattr(host.fstate, part)._fields,
                              getattr(card.fstate, part),
                              getattr(host.fstate, part)):
            assert a.dtype == b.dtype, (part, name)
            assert torch.equal(a.cpu(), b), (part, name)


@pytest.mark.gpu
def test_a_build_leaves_only_the_model(cuda):
    keys, positions, max_error = make_case("wikits")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda)
    ops.reset_launch_counts()
    model, static = build_radix_spline(keys, positions, max_error=max_error,
                                       device=cuda)
    torch.cuda.synchronize()
    assert ops.launch_counts()["spline_corridor"] == 2
    grown = torch.cuda.memory_allocated(cuda) - base
    assert grown == _allocated_for(_storages(model), cuda)
    want, want_static = build_radix_spline(keys, positions,
                                           max_error=max_error, device="cpu")
    assert static == want_static
    for a, b in zip(model, want):
        assert torch.equal(a.cpu(), b)
