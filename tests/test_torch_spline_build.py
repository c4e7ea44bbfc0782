"""K8, the spline corridor, on the CPU: its plain version's knot indices
against the port's host loop (``_greedy_spline_knots``) and the JAX
package's, knot for knot, and the CPU build of the radix spline against
the JAX package's build, on the cases of
``tests/test_torch_spline_build_card.py`` (which holds the CUDA kernels to
the host loop on the same cases); the names the benchmark reads its
launches by, and what the wrapper refuses."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401 — x64
from repro.core.radix_spline import _greedy_spline_knots as jax_knots
from repro.core.radix_spline import build_radix_spline as jax_build
from repro_torch.core.radix_spline import _DEF_WINDOW, build_radix_spline
from repro_torch.kernels import ops
from repro_torch.kernels.spline_corridor import spline_corridor
from tests.test_torch_spline_build_card import CASES, host_knots, make_case

CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc" / "spline_corridor.cu")


@pytest.mark.parametrize("case", CASES)
def test_plain_k8_equals_the_host_loops(case):
    keys, positions, max_error = make_case(case)
    got = spline_corridor(torch.from_numpy(keys), torch.from_numpy(positions),
                          max_error, _DEF_WINDOW)
    assert got.dtype == torch.int64
    want = host_knots(keys, positions, max_error)
    with np.errstate(divide="ignore", invalid="ignore"):
        ref = jax_knots(keys, positions, max_error)
    np.testing.assert_array_equal(want, ref)
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "linear_cap":
        assert want.tolist() == [0, _DEF_WINDOW - 1, len(keys) - 1]
    if case == "near_2_63":  # dx 0 with a 0 numerator: the NaN path runs
        same = np.diff(keys.astype(np.float64)) == 0
        assert (same & (np.diff(positions) == max_error)).any()
    # the CPU build is the host loop's, as before: the JAX package's arrays
    with np.errstate(divide="ignore", invalid="ignore"):
        model, static = build_radix_spline(keys, positions,
                                           max_error=max_error, device="cpu")
        jm, js = jax_build(keys, positions, max_error=max_error)
    assert tuple(static) == tuple(js)
    for name, a, b in zip(model._fields, model, jm):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


def test_every_kernel_name_holds_the_launch_key():
    """The benchmark's trace matches the launch counts' keys by substring
    against the device events' names: both of K8's ``__global__``s must
    hold ``spline_corridor``, and no other key may match them."""
    names = re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
        CSRC.read_text())
    assert len(names) == 2
    ops.reset_launch_counts()
    keys = ops.launch_counts()
    assert keys["spline_corridor"] == 0
    for n in names:
        assert [k for k in keys if k in n] == ["spline_corridor"], n


@pytest.mark.parametrize("bad", ["dtype", "length", "device", "window",
                                 "max_error"])
def test_spline_corridor_refuses_what_it_cannot_take(bad):
    keys, positions, max_error = make_case("n2")
    k, p = torch.from_numpy(keys), torch.from_numpy(positions)
    window = _DEF_WINDOW
    if bad == "dtype":
        p = p.to(torch.int32)
    elif bad == "length":
        p = p[:1]
    elif bad == "device":
        p = p.to("meta")
    elif bad == "window":
        window = 0
    else:
        max_error = 2.5
    with pytest.raises((ValueError, TypeError)):
        spline_corridor(k, p, max_error, window)
