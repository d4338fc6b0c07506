"""BRUTE (OpenCL-kernel) mode parity: byte-for-byte vs the oracle's
transcription of opencl/sdf.cl, including the triangle candidate-set quirk.
BASELINE config 2."""

import numpy as np
import pytest

import jax.numpy as jnp

from sdfref import oracle
from chaq_sdfgen.models.sdf_model import hard_sdf_brute
from chaq_sdfgen.ops import brute


def _img(b):
    img2ch = np.zeros(b.shape + (2,), dtype=np.uint8)
    img2ch[..., 1] = np.where(b, 255, 0)
    img2ch[..., 0] = np.where(b, 230, 30)
    return img2ch


@pytest.mark.parametrize("spread", [1, 2, 5, 12])
@pytest.mark.parametrize("invert", [False, True])
def test_brute_matches_opencl_oracle(spread, invert):
    rng = np.random.default_rng(10 + spread)
    b = rng.random((33, 29)) < 0.3
    img2ch = _img(b)
    want = oracle.sdf_pipeline_opencl(
        img2ch, spread=spread, asymmetric=False, use_luminance=False, invert=invert
    )
    got = hard_sdf_brute(jnp.asarray(img2ch), spread=spread, invert=invert)
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("asymmetric", [False, True])
def test_brute_asymmetric_and_luminance(asymmetric):
    rng = np.random.default_rng(20)
    b = rng.random((24, 24)) < 0.5
    img2ch = _img(b)
    want = oracle.sdf_pipeline_opencl(
        img2ch, spread=6, asymmetric=asymmetric, use_luminance=True
    )
    got = hard_sdf_brute(
        jnp.asarray(img2ch), spread=6, asymmetric=asymmetric, use_luminance=True
    )
    np.testing.assert_array_equal(np.asarray(got), want)


def test_brute_uniform_images_inf_fallback():
    for fill in (0, 255):
        img2ch = np.full((10, 14, 2), fill, dtype=np.uint8)
        want = oracle.sdf_pipeline_opencl(img2ch, spread=4)
        got = hard_sdf_brute(jnp.asarray(img2ch), spread=4)
        np.testing.assert_array_equal(np.asarray(got), want)


def test_brute_diagonal_quirk_reproduced():
    # A pixel whose only nearby opposite neighbour sits on the exact
    # diagonal: the reference skips it and must fall back to a farther
    # candidate (or INF); verify we reproduce that, not the true nearest.
    b = np.zeros((7, 7), dtype=bool)
    b[3, 3] = True  # center true; nearest opposite of center is everything
    # isolate: make a true pixel at (0,0) whose nearest false is (1,1)? —
    # instead simplest: all true except (2,2); pixel (3,3) has nearest
    # opposite at exact diagonal distance sqrt(2).
    b = np.ones((7, 7), dtype=bool)
    b[2, 2] = False
    img2ch = _img(b)
    want = oracle.sdf_pipeline_opencl(img2ch, spread=3)
    got = hard_sdf_brute(jnp.asarray(img2ch), spread=3)
    np.testing.assert_array_equal(np.asarray(got), want)
    # and sanity: the oracle's candidate d2 at (3,3) must NOT be 2
    d2 = oracle.opencl_nearest_d2(b, 3)
    assert d2[3, 3] != 2


def test_row_seed_distances_reference_values():
    seeds = np.array([[0, 1, 0, 0, 1, 0, 0, 0]], dtype=bool)
    l1, l2, r1, r2 = [np.asarray(x)[0] for x in brute.row_seed_distances(jnp.asarray(seeds), 9)]
    np.testing.assert_array_equal(l1, [9, 0, 1, 2, 0, 1, 2, 3])
    np.testing.assert_array_equal(l2, [9, 9, 9, 9, 3, 4, 5, 6])
    np.testing.assert_array_equal(r1, [1, 0, 2, 1, 0, 9, 9, 9])
    np.testing.assert_array_equal(r2, [4, 3, 9, 9, 9, 9, 9, 9])
