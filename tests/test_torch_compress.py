"""The port's int8 primitives (``repro_torch.optim.compress``) against the
reference's, bit for bit.

The engine's int8 page bytes are built from these, so they must agree
exactly with the reference as its engine runs them: under ``jax.jit``,
where XLA turns ``/ 127.0`` into a multiplication by the float32
reciprocal.  Inputs are float32 and bfloat16, with all-zero slices and
exact half-step ties (both libraries round half to even).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compress as J
from repro_torch.optim import compress as T

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(x: np.ndarray, dtype: str):
    """The same values in both frameworks (bfloat16 rounded once, by JAX,
    and carried bit for bit)."""
    jdt, tdt = DTYPES[dtype]
    jx = jnp.asarray(x).astype(jdt)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt)
    return jx, tx


def _inputs(seed: int) -> np.ndarray:
    """(6, 4, 32) values over eight decades, one all-zero slice."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((6, 4, 32)) * 10.0 ** rng.uniform(
        -4, 4, (6, 4, 1))
    x[2, 1] = 0.0
    return x.astype(np.float32)


def _same(a_jax, b_torch):
    a = np.asarray(a_jax)
    b = b_torch.numpy()
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                  b.reshape(-1).view(np.uint8))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_headwise_scales_and_quantize_bit_exact(dtype, seed):
    jx, tx = _both(_inputs(seed), dtype)
    js = jax.jit(J.headwise_scales)(jx)
    ts = T.headwise_scales(tx)
    _same(js, ts)
    assert float(ts[2, 1]) == 0.0                   # zero slice, scale 0
    jq = jax.jit(J.quantize_int8)(jx, js[..., None])
    tq = T.quantize_int8(tx, ts[..., None])
    _same(jq, tq)
    assert int(tq[2, 1].abs().max()) == 0           # quantizes to 0
    _same(jax.jit(J.decompress_int8)(jq, js[..., None]),
          T.decompress_int8(tq, ts[..., None]))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("seed", [0, 3])
def test_compress_int8_bit_exact(dtype, seed):
    for x in (_inputs(seed), np.zeros((4, 8), np.float32)):
        jx, tx = _both(x, dtype)
        jq, js = jax.jit(J.compress_int8)(jx)
        tq, ts = T.compress_int8(tx)
        _same(jq, tq)
        _same(js, ts)


@pytest.mark.parametrize("scale", [0.25, 1.0, 2.0])
def test_half_step_ties_round_to_even(scale):
    """x / scale lands exactly on k + 0.5: both round to the even
    neighbour, and the clip holds at +-127."""
    steps = np.array([0.5, 1.5, 2.5, 3.5, -0.5, -1.5, -2.5, 126.5, 127.5,
                      -127.5, 200.0], np.float32)
    jx, tx = _both(steps * scale, "float32")
    sc = np.full((1,), scale, np.float32)
    tq = T.quantize_int8(tx, torch.from_numpy(sc))
    _same(jax.jit(J.quantize_int8)(jx, jnp.asarray(sc)), tq)
    assert tq.tolist() == [0, 2, 2, 4, 0, -2, -2, 126, 127, -127, 127]


def test_scale_matches_jit_not_eager_division():
    """The reason for the reciprocal: on inputs where x * f32(1/127) and
    x / 127 differ, the port follows the jitted reference."""
    x = np.random.default_rng(4).uniform(0.01, 100, (4096, 1)) \
        .astype(np.float32)
    exact = (torch.from_numpy(x).amax(-1) / 127.0).numpy()
    jitted = np.asarray(jax.jit(J.headwise_scales)(jnp.asarray(x)))
    ported = T.headwise_scales(torch.from_numpy(x)).numpy()
    assert (jitted != exact).any()
    np.testing.assert_array_equal(ported, jitted)
    assert T.SCALE_EPS == J.SCALE_EPS
