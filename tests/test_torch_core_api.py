"""The rest of ``repro_torch.core``'s public surface against the JAX
package on the CPU: ``rs_predict`` bit for bit with the reference's
arithmetic as written, and within one ulp of its jitted form (trained
keys, queries between them and clamped extrapolation on both sides),
``gmm_pdf`` and
``gmm_cdf`` in float64, ``state_memory_bytes`` of the same bulk-loaded
index, ``init_counters``' starting counts, ``OpStats``, the
``bucket_width`` alias, and the exports of ``repro_torch``,
``repro_torch.core`` and ``repro_torch.kernels``."""
import ast
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro.core  # noqa: F401 — x64
from repro.core import UpLIF as JaxUpLIF
from repro.core.gmm import GMMState as JaxGMMState
from repro.core.gmm import gmm_cdf as jax_gmm_cdf
from repro.core.gmm import gmm_pdf as jax_gmm_pdf
from repro.core.radix_spline import build_radix_spline as jax_build
from repro.core.radix_spline import rs_predict as jax_rs_predict
from repro.core.state import init_counters as jax_init_counters
from repro.core.state import state_memory_bytes as jax_state_memory_bytes
from repro.core.uplif import UpLIFConfig as JaxConfig
import repro_torch
import repro_torch.core
from repro_torch.core import (
    GMMState,
    UpLIF,
    UpLIFConfig,
    build_radix_spline,
    fit_gmm,
    gmm_cdf,
    gmm_pdf,
    rs_predict,
)
from repro_torch.core.state import init_counters, state_memory_bytes
from repro_torch.core.types import OpStats
from tests.conftest import make_keys

SRC = Path(__file__).resolve().parent.parent / "src"


def _distribution(dist: str):
    """``tests/test_radix_spline.py``'s key sets and gapped positions."""
    r = np.random.default_rng(1)
    if dist == "uniform":
        keys = make_keys(20000, 1)
    elif dist == "clustered":
        centers = r.integers(0, 1 << 48, 40)
        keys = np.unique(
            (centers[:, None] + r.integers(0, 4096, (40, 600))).reshape(-1)
        ).astype(np.int64)
    else:  # the property test's cumulative positions
        keys = make_keys(500, 7)
        return keys, np.cumsum(r.integers(1, 5, len(keys))).astype(np.int64)
    return keys, np.arange(len(keys)) * 3


@pytest.mark.parametrize("max_error", [8, 32])
@pytest.mark.parametrize("dist", ["uniform", "clustered", "cumulative"])
def test_rs_predict_bit_for_bit(dist, max_error):
    keys, pos = _distribution(dist)
    jm, js = jax_build(keys, pos, max_error=max_error)
    tm, ts = build_radix_spline(keys, pos, max_error=max_error, device="cpu")
    assert tuple(js) == tuple(ts)
    r = np.random.default_rng(2)
    q = np.concatenate([
        keys,
        r.integers(int(keys[0]), int(keys[-1]), 3000),   # between keys
        [0, int(keys[0]) - 1, int(keys[-1]) + 1,          # clamped below
         int(keys[-1]) + 10**6, (1 << 52) - 1],           # and above
    ]).astype(np.int64)
    with jax.disable_jit():  # the reference's arithmetic as written
        want = np.asarray(jax_rs_predict(jm, js, jnp.asarray(q)))
    got = rs_predict(tm, ts, torch.from_numpy(q))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy().view(np.int64),
                                  want.view(np.int64))
    # jitted on the CPU, XLA contracts the float64 lerp into one fused
    # multiply-add (ROADMAP §3): at most one ulp from the port's
    jitted = np.asarray(jax_rs_predict(jm, js, jnp.asarray(q)))
    ulps = np.abs(jitted.view(np.int64) - got.numpy().view(np.int64))
    assert ulps.max() <= 1
    assert np.abs(got.numpy()[: len(keys)] - pos).max() <= max_error + 1e-6
    tail = got.numpy()[-5:]
    assert tail[0] == tail[1] and tail[2] == tail[3] == tail[4]  # clamped


@pytest.mark.parametrize("k", [1, 4, 9])
def test_gmm_pdf_and_cdf_match_jax(k):
    r = np.random.default_rng(k)
    sample = np.concatenate([r.normal(1e12 * c, 3e10, 400) for c in range(k)])
    state = fit_gmm(sample, n_components=k)
    jstate = JaxGMMState(*[jnp.asarray(a.numpy()) for a in state])
    x = np.concatenate([sample[::7], np.linspace(-5e11, 1e12 * k + 5e11, 301)])
    for ours, theirs in ((gmm_pdf, jax_gmm_pdf), (gmm_cdf, jax_gmm_cdf)):
        got = ours(state, x)
        want = np.asarray(theirs(jstate, jnp.asarray(x)))
        assert got.dtype == torch.float64
        # relative, but for values that underflow to subnormals far out
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                   atol=np.finfo(np.float64).tiny)
    cdf = gmm_cdf(state, np.sort(x)).numpy()
    # the weights sum to 1 within rounding, as in the reference
    assert np.all(np.diff(cdf) >= 0) and 0 <= cdf.min() and cdf.max() < 1 + 1e-12


def test_state_memory_bytes_matches_jax():
    keys = make_keys(30_000, 3)
    for cfg in (dict(), dict(bmat_type="rbmat", bmat_capacity=1 << 14)):
        jidx = JaxUpLIF(keys, keys + 1, JaxConfig(**cfg))
        tidx = UpLIF(keys, keys + 1, UpLIFConfig(**cfg), device="cpu")
        want = jax_state_memory_bytes(jidx.fstate)
        assert state_memory_bytes(tidx.fstate) == want
        assert want > 8 * tidx.capacity  # slots, model and BMAT, counted


def test_init_counters_holds_its_starting_counts():
    given = dict(n_keys=7, n_bmat_live=3, n_inplace=11, n_overflow=2,
                 min_granularity=1 << 40)
    for kw in (dict(), given):
        c = init_counters("cpu", **kw)
        j = jax_init_counters(**kw)
        assert c._fields == j._fields
        for a, b in zip(c, j):
            assert a.dtype == torch.int64 and a.dim() == 0
            assert int(a) == int(b)
    assert int(init_counters("cpu").min_granularity) == np.iinfo(np.int64).max


def test_opstats_and_bucket_width():
    from repro.core.types import OpStats as JaxOpStats
    from repro.core.uplif import bucket_width as jax_bucket_width
    from repro_torch.core.uplif import bucket_width

    assert OpStats._fields == JaxOpStats._fields
    stats = OpStats(*[torch.tensor(i, dtype=torch.int64) for i in range(5)])
    assert int(stats.min_granularity) == 4
    for n in (1, 255, 256, 300, 1025, 5000):
        assert bucket_width(n, 256) == jax_bucket_width(n, 256)


def _exports(rel: str) -> list:
    tree = ast.parse((SRC / "repro" / rel).read_text())
    return [a.asname or a.name for n in tree.body
            if isinstance(n, ast.ImportFrom) for a in n.names]


@pytest.mark.parametrize("pkg", ["core", "kernels"])
def test_packages_export_what_the_reference_exports(pkg):
    names = _exports(f"{pkg}/__init__.py")
    assert names  # the reference exports something
    port = importlib.import_module(f"repro_torch.{pkg}")
    ref = importlib.import_module(f"repro.{pkg}")
    for name in names:
        ours, theirs = getattr(port, name), getattr(ref, name)
        if isinstance(theirs, int):  # KEY_MAX, TOMBSTONE
            assert ours == theirs, name
        else:
            assert ours.__name__.rsplit(".", 1)[-1] == \
                theirs.__name__.rsplit(".", 1)[-1], name
    assert repro_torch.core.GMMState is GMMState
    assert repro_torch.__version__ == repro.__version__ == "1.0.0"
