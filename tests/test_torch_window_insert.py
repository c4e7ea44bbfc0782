"""K7, the window insert, on the CPU: its plain version against the JAX
package's Movement round, and the names the benchmark reads its launches
by.

The JAX package has no function for one round: ``insert`` and ``sinsert``
(``src/repro/core/fops.py``) inline the grid-segment accept around
``_inplace_window_insert``. ``_jax_round`` below is that accept, as both
write it, around the JAX ``_inplace_window_insert``; the port's
``window_insert`` must leave the same slot view, ok mask, failed spans and
counters, byte for byte, on the branch-reaching cases of
``tests/test_torch_window_insert_card.py`` (which holds the CUDA kernels
to the plain version on the same cases)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401 — x64
import jax.numpy as jnp
from repro.core import fops as jfops
from repro_torch.core.types import KEY_MAX
from repro_torch.kernels import ops
from repro_torch.kernels.window_insert import MAX_WINDOW, window_insert
from tests.test_torch_window_insert_card import (
    CASES,
    MOVEMENT_K,
    VIEWS,
    make_case,
    run_round,
)

CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc" / "window_insert.cu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_round(c, W):
    """The JAX package's round on case ``c``, as numpy in the layout of
    ``run_round``."""
    cap, total = c["cap"], c["total"]
    pending, sid = c["pending"], c["sid"]
    ins_slot = np.clip(np.minimum(c["j"] + 1, c["icap"]), 0, cap - 1)
    row = ins_slot // W if sid is None else sid * (cap // W) + ins_slot // W
    bucket = np.where(pending, row, total // W + 1)
    order = np.argsort(bucket, kind="stable")
    bs, ps = bucket[order], pending[order]
    accept = ps & np.concatenate([[True], bs[1:] != bs[:-1]])
    starts = np.clip(bs * W, 0, total - W)
    qk = np.where(pending, c["keys"], KEY_MAX)
    sk, sv, so, can, span, _ = jfops._inplace_window_insert(
        *(jnp.asarray(c[k][:total]) for k in ("sk", "sv", "so")),
        jnp.asarray(qk[order]), jnp.asarray(c["vals"][order]),
        jnp.asarray(starts), jnp.asarray(accept), jnp.asarray(ps), W,
        MOVEMENT_K,
    )
    ok_s = np.asarray(can) & ps
    span = np.asarray(span)
    ok = np.empty_like(ok_s)
    ok[order] = ok_s
    failed = np.empty_like(span)
    failed[order] = span
    return {"sk": np.asarray(sk), "sv": np.asarray(sv), "so": np.asarray(so),
            "ok": ok, "failed_span": failed,
            "n_placed": np.asarray(ok_s.sum(), dtype=np.int64),
            "min_span": np.asarray(min(KEY_MAX, span.min(initial=KEY_MAX)),
                                   dtype=np.int64)}


@pytest.mark.parametrize("W", [16, 64, 128])
@pytest.mark.parametrize("view", VIEWS)
@pytest.mark.parametrize("case", CASES)
def test_plain_k7_equals_the_jax_round(case, view, W):
    c = make_case(case, view, W)
    got = run_round(window_insert, c, W, "cpu")
    want = _jax_round(c, W)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_every_kernel_name_holds_the_launch_key():
    """The benchmark's trace matches the launch counts' keys by substring
    against the device events' names: every ``__global__`` of K7 must
    hold ``window_insert``, the key its launches are counted under."""
    src = CSRC.read_text()
    names = re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", src)
    assert len(names) == 2
    assert all("window_insert" in n for n in names)
    ops.reset_launch_counts()
    assert ops.launch_counts()["window_insert"] == 0


@pytest.mark.parametrize("bad", ["window", "dtype", "length", "counters",
                                 "cap"])
def test_window_insert_refuses_what_it_cannot_take(bad):
    c = make_case("random", "single", 64)
    t = {k: torch.as_tensor(c[k]) for k in
         ("sk", "sv", "so", "keys", "vals", "j", "icap", "pending")}
    kw = dict(cap=c["cap"], total=c["total"], window=64,
              movement_k=MOVEMENT_K)
    if bad == "window":
        kw["window"] = 2 * MAX_WINDOW
    elif bad == "dtype":
        t["j"] = t["j"].to(torch.int32)
    elif bad == "length":
        t["sk"] = t["sk"][:-64]
    elif bad == "counters":
        kw["n_placed"] = torch.zeros((), dtype=torch.int64)
    else:
        kw["cap"] = c["cap"] + 1
    with pytest.raises(ValueError):
        window_insert(*(t[k] for k in ("sk", "sv", "so", "keys", "vals", "j",
                                       "icap", "pending")), **kw)
