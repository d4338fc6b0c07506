"""The GPU kernel (ops/edt_triton.py) in interpreter mode on the CPU: byte
parity vs the XLA core and the oracle. On a card, chip_smoke.py and the
``gpu``-marked tests run it compiled."""

import numpy as np
import pytest

import jax.numpy as jnp

from sdfref import oracle
from chaq_sdfgen.ops import edt_triton
from chaq_sdfgen.models.sdf_model import hard_sdf_exact_from_bool


@pytest.mark.parametrize("shape,spread", [((64, 48), 8), ((40, 140), 5), ((139, 131), 13)])
def test_fused_sdf_bytes_matches_xla(shape, spread):
    rng = np.random.default_rng(spread)
    b = rng.random(shape) < 0.35
    got = edt_triton.sdf_bytes(jnp.asarray(b), spread, interpret=True)
    want = hard_sdf_exact_from_bool(jnp.asarray(b), spread, core="xla")
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_fused_sdf_bytes_matches_oracle_asymmetric():
    rng = np.random.default_rng(0)
    b = rng.random((48, 40)) < 0.25
    img2ch = np.zeros((48, 40, 2), dtype=np.uint8)
    img2ch[..., 1] = np.where(b, 255, 0)
    want = oracle.sdf_pipeline_openmp(img2ch, spread=10, asymmetric=True, channel=1)
    got = edt_triton.sdf_bytes(jnp.asarray(b), 10, asymmetric=True, interpret=True)
    np.testing.assert_array_equal(np.asarray(got), want)


def test_fused_sdf_bytes_batched():
    rng = np.random.default_rng(1)
    b = rng.random((3, 32, 32)) < 0.4
    got = np.asarray(edt_triton.sdf_bytes(jnp.asarray(b), 6, interpret=True))
    for i in range(3):
        want = np.asarray(hard_sdf_exact_from_bool(jnp.asarray(b[i]), 6, core="xla"))
        np.testing.assert_array_equal(got[i], want)


def test_fused_uniform():
    for fill in (True, False):
        b = np.full((16, 16), fill, dtype=bool)
        got = edt_triton.sdf_bytes(jnp.asarray(b), 5, interpret=True)
        want = hard_sdf_exact_from_bool(jnp.asarray(b), 5, core="xla")
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("shape,spread", [
    ((2, 3), 1),        # smallest image the kernel takes
    ((3, 130), 4),      # width just past one 128-column tile
    ((17, 1), 6),       # a single column
    ((16, 128), 9),     # exactly one tile
    ((33, 257), 2),     # partial tiles in both directions
    ((129, 16), 40),    # band larger than the image
])
def test_kernel_edge_shapes(shape, spread):
    """Padding to whole tiles and the sentinel rows must not leak into the
    image: every shape matches the XLA core."""
    rng = np.random.default_rng(sum(shape) + spread)
    b = jnp.asarray(rng.random(shape) < 0.3)
    got = edt_triton.sdf_bytes(b, spread, interpret=True)
    want = hard_sdf_exact_from_bool(b, spread, core="xla")
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("spread", [252, 253, 254])
def test_kernel_u8_u16_storage_boundary(spread):
    """Row distances are stored as u8 while band + 1 <= 255 and as u16
    beyond; the bytes must not change across the boundary."""
    band = spread + 2
    assert edt_triton.storage_dtype(band + 1) == (jnp.uint8 if band + 1 <= 255 else jnp.uint16)
    b = np.zeros((40, 300), bool)
    b[3, 7] = b[30, 280] = True
    got = edt_triton.sdf_bytes(jnp.asarray(b), spread, interpret=True)
    want = hard_sdf_exact_from_bool(jnp.asarray(b), spread, core="xla")
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_kernel_rejects_one_row_and_wide_sentinels():
    with pytest.raises(ValueError):
        edt_triton.sdf_bytes(jnp.zeros((1, 8), bool), 3, interpret=True)
    with pytest.raises(ValueError):
        edt_triton.storage_dtype(65536)
