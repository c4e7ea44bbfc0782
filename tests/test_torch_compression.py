"""The port's gradient compression (``repro_torch.parallel.compression``)
against the JAX package's, on the CPU: the int8 payload, the float16 scales
and the round trip bit for bit on the same numpy inputs (ties included:
both round half to even), the error-feedback state over rounds, and the
wire bytes; with the reference's own tests
(``tests/test_train_and_ckpt.py``) mirrored on the port."""
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401 — x64, as in the full system
import jax.numpy as jnp
from repro.parallel import compression as jcomp
from repro_torch.parallel import compression as comp

SHAPES = [(1000,), (256,), (3, 7, 13), (2, 256), (1,)]


def _inputs(shape, seed):
    x = np.random.default_rng(seed).normal(0, 3, shape).astype(np.float32)
    return x, jnp.asarray(x), torch.from_numpy(x)


def _ties():
    """One block whose largest |x| is 127, so its scale is 1.0 and each
    x / scale is x: halves that round to even (2.5 -> 2, -3.5 -> -4,
    0.5 -> 0), and a second block of zeros (the 1e-12 scale floor)."""
    x = np.zeros(512, np.float32)
    x[:6] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5]
    return x


@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_is_bit_identical_to_jax(shape):
    x, jx, tx = _inputs(shape, 1)
    jq, js = jcomp.quantize(jx)
    tq, ts = comp.quantize(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float16
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    n = int(np.prod(shape))
    np.testing.assert_array_equal(
        comp.dequantize(tq, ts, shape, n).numpy(),
        np.asarray(jcomp.dequantize(jq, js, shape, n)))
    np.testing.assert_array_equal(comp.compress_roundtrip(tx).numpy(),
                                  np.asarray(jcomp.compress_roundtrip(jx)))


def test_rounding_ties_go_to_even_as_in_jax():
    x = _ties()
    jq, js = jcomp.quantize(jnp.asarray(x))
    tq, ts = comp.quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq[0, :6].tolist() == [127, 2, -4, 0, 0, 2]


def test_ef_compress_grads_is_bit_identical_to_jax():
    """Twenty rounds of error feedback on a two-leaf tree: the compressed
    grads and the carried residuals equal the reference's every round."""
    rng = np.random.default_rng(7)
    g = {"a": rng.normal(0, 1, (300,)).astype(np.float32),
         "b": {"w": rng.normal(0, 2, (4, 70)).astype(np.float32)}}
    jg = {"a": jnp.asarray(g["a"]), "b": {"w": jnp.asarray(g["b"]["w"])}}
    tg = {"a": torch.from_numpy(g["a"]),
          "b": {"w": torch.from_numpy(g["b"]["w"])}}
    jef, tef = jcomp.init_ef_state(jg), comp.init_ef_state(tg)
    for _ in range(20):
        jc, jef = jcomp.ef_compress_grads(jg, jef)
        tc, tef = comp.ef_compress_grads(tg, tef)
        for path in (("a",), ("b", "w")):
            pick = lambda t: t[path[0]] if len(path) == 1 else \
                t[path[0]][path[1]]  # noqa: E731
            np.testing.assert_array_equal(pick(tc).numpy(),
                                          np.asarray(pick(jc)))
            np.testing.assert_array_equal(pick(tef).numpy(),
                                          np.asarray(pick(jef)))


def test_compression_roundtrip_error_bound():
    """``test_compression_roundtrip_error_bound`` on the port: |err| is
    at most max|x| / 127."""
    x, _, tx = _inputs((1000,), 5)
    err = np.abs(x - comp.compress_roundtrip(tx).numpy())
    assert err.max() <= float(np.abs(x).max()) / 127.0


def test_error_feedback_preserves_sum():
    """``test_error_feedback_preserves_sum`` on the port: over 50 rounds
    the compressed grads sum to the true sum within one step."""
    g = {"w": torch.from_numpy(np.random.default_rng(6).normal(
        0, 1, (512,)).astype(np.float32))}
    ef = comp.init_ef_state(g)
    acc = np.zeros(512)
    for _ in range(50):
        cg, ef = comp.ef_compress_grads(g, ef)
        acc += cg["w"].numpy()
    true = 50 * g["w"].numpy()
    assert np.abs(acc - true).max() < np.abs(g["w"].numpy()).max() / 100.0


@pytest.mark.parametrize("shape", [(4096,), (1000,), (3, 300), (1,)])
def test_wire_bytes_match_jax(shape):
    jp = {"w": jnp.zeros(shape, jnp.float32), "b": jnp.zeros((5,))}
    tp = {"w": torch.zeros(shape), "b": torch.zeros(5)}
    assert comp.wire_bytes_f32(tp) == jcomp.wire_bytes_f32(jp)
    assert comp.wire_bytes_int8(tp) == jcomp.wire_bytes_int8(jp)


def test_wire_bytes_ratio():
    p = {"w": torch.zeros(4096)}
    ratio = comp.wire_bytes_f32(p) / comp.wire_bytes_int8(p)
    assert 3.5 < ratio < 4.0
