"""Randomized cross-validation: EXACT (XLA core + GPU kernel interpreted) and BRUTE
modes vs the oracle over random shapes, spreads, densities, and flags."""

import numpy as np
import pytest

import jax.numpy as jnp

from sdfref import oracle
from chaq_sdfgen.models.sdf_model import hard_sdf_exact, hard_sdf_brute
from chaq_sdfgen.ops import edt_triton


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_exact(seed):
    rng = np.random.default_rng(1000 + seed)
    h = int(rng.integers(2, 90))
    w = int(rng.integers(2, 90))
    spread = int(rng.integers(1, 30))
    dens = float(rng.uniform(0.02, 0.95))
    asym = bool(rng.integers(0, 2))
    invert = bool(rng.integers(0, 2))
    channel = int(rng.integers(0, 2))
    img2ch = (rng.random((h, w, 2)) * 255).astype(np.uint8)
    if rng.random() < 0.3:  # sometimes binary
        img2ch[..., 1] = np.where(rng.random((h, w)) < dens, 255, 0)
    want = oracle.sdf_pipeline_openmp(
        img2ch, spread=spread, asymmetric=asym, channel=channel, test_above=not invert
    )
    got = hard_sdf_exact(
        jnp.asarray(img2ch), spread=spread, asymmetric=asym, channel=channel,
        test_above=not invert, core="xla",
    )
    np.testing.assert_array_equal(np.asarray(got), want)
    # the GPU kernel in interpreter mode (H >= 2)
    if h >= 2:
        b = oracle.img_to_bool(img2ch, channel=channel, test_above=not invert)
        gotp = edt_triton.sdf_bytes(
            jnp.asarray(b), spread, asymmetric=asym, interpret=True
        )
        np.testing.assert_array_equal(np.asarray(gotp), want)


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_brute(seed):
    rng = np.random.default_rng(2000 + seed)
    h = int(rng.integers(4, 48))
    w = int(rng.integers(4, 48))
    spread = int(rng.integers(1, 10))
    asym = bool(rng.integers(0, 2))
    invert = bool(rng.integers(0, 2))
    lum = bool(rng.integers(0, 2))
    img2ch = (rng.random((h, w, 2)) * 255).astype(np.uint8)
    want = oracle.sdf_pipeline_opencl(
        img2ch, spread=spread, asymmetric=asym, use_luminance=lum, invert=invert
    )
    got = hard_sdf_brute(
        jnp.asarray(img2ch), spread=spread, asymmetric=asym,
        use_luminance=lum, invert=invert,
    )
    np.testing.assert_array_equal(np.asarray(got), want)
