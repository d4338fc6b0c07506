"""Hard-mode EXACT pipeline parity: byte-for-byte vs the NumPy oracle (and
hence vs the reference OpenMP binary / golden sample)."""

import numpy as np
import pytest

import jax.numpy as jnp

from sdfref import oracle
from chaq_sdfgen.models.sdf_model import hard_sdf_exact, hard_sdf_exact_from_bool
from chaq_sdfgen.ops import edt


def test_exact_matches_golden_sample(sample_input_2ch, sample_golden):
    out = hard_sdf_exact(
        jnp.asarray(sample_input_2ch),
        spread=100,
        asymmetric=True,
        channel=0,
        test_above=True,
        core="xla",
    )
    np.testing.assert_array_equal(np.asarray(out), sample_golden)


@pytest.mark.parametrize("spread", [1, 3, 16, 64])
@pytest.mark.parametrize("asymmetric", [False, True])
def test_exact_matches_oracle_random(spread, asymmetric):
    rng = np.random.default_rng(42 + spread)
    b = rng.random((48, 40)) < 0.3
    img2ch = np.zeros((48, 40, 2), dtype=np.uint8)
    img2ch[..., 1] = np.where(b, 255, 0)
    want = oracle.sdf_pipeline_openmp(img2ch, spread=spread, asymmetric=asymmetric, channel=1)
    got = hard_sdf_exact(
        jnp.asarray(img2ch), spread=spread, asymmetric=asymmetric, channel=1, core="xla"
    )
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize(
    "shape", [(1, 1), (1, 17), (17, 1), (5, 64), (64, 5), (33, 47)]
)
def test_exact_degenerate_and_nonsquare(shape):
    rng = np.random.default_rng(7)
    b = rng.random(shape) < 0.4
    img2ch = np.zeros(shape + (2,), dtype=np.uint8)
    img2ch[..., 1] = np.where(b, 200, 20)
    want = oracle.sdf_pipeline_openmp(img2ch, spread=8, asymmetric=False, channel=1)
    got = hard_sdf_exact(jnp.asarray(img2ch), spread=8, core="xla")
    np.testing.assert_array_equal(np.asarray(got), want)


def test_exact_uniform_images():
    # uniform true and uniform false: one EDT field is all-INF in the
    # reference; our finite sentinel must clamp to the same bytes.
    for fill, spread, asym in [(255, 16, False), (0, 16, False), (255, 7, True), (0, 7, True)]:
        img2ch = np.full((12, 9, 2), fill, dtype=np.uint8)
        want = oracle.sdf_pipeline_openmp(img2ch, spread=spread, asymmetric=asym, channel=1)
        got = hard_sdf_exact(jnp.asarray(img2ch), spread=spread, asymmetric=asym, core="xla")
        np.testing.assert_array_equal(np.asarray(got), want)


def test_invert_flag_matches_oracle():
    rng = np.random.default_rng(3)
    img2ch = (rng.random((20, 20, 2)) * 255).astype(np.uint8)
    want = oracle.sdf_pipeline_openmp(img2ch, spread=10, channel=1, test_above=False)
    got = hard_sdf_exact(jnp.asarray(img2ch), spread=10, channel=1, test_above=False, core="xla")
    np.testing.assert_array_equal(np.asarray(got), want)


def test_luminance_channel_matches_oracle():
    rng = np.random.default_rng(4)
    img2ch = (rng.random((20, 20, 2)) * 255).astype(np.uint8)
    want = oracle.sdf_pipeline_openmp(img2ch, spread=10, channel=0)
    got = hard_sdf_exact(jnp.asarray(img2ch), spread=10, channel=0, core="xla")
    np.testing.assert_array_equal(np.asarray(got), want)


def test_row_nearest_sq_exact():
    rng = np.random.default_rng(5)
    b = rng.random((8, 30)) < 0.25
    band = 31
    got = np.asarray(edt.row_nearest_sq(jnp.asarray(b), band))
    big = edt.big_sentinel(band)
    for y in range(b.shape[0]):
        xs = np.nonzero(b[y])[0]
        for x in range(b.shape[1]):
            if len(xs) == 0:
                want = big
            else:
                d = np.abs(xs - x).min()
                want = min(d * d, big)
            assert got[y, x] == want, (y, x)


def test_batched_leading_dims():
    rng = np.random.default_rng(6)
    imgs = (rng.random((3, 16, 16, 2)) * 255).astype(np.uint8)
    batched = hard_sdf_exact(jnp.asarray(imgs), spread=6, core="xla")
    for i in range(3):
        single = hard_sdf_exact(jnp.asarray(imgs[i]), spread=6, core="xla")
        np.testing.assert_array_equal(np.asarray(batched[i]), np.asarray(single))


@pytest.mark.parametrize("spread", [300, 1024])
def test_exact_large_spread_u16_strips(spread):
    """band > 253 routes through u16 row-distance strips + wide-group
    adaptive pass 2 (the reference EDT is spread-independent,
    openmp/df.c:29-136); still byte-exact at any -s."""
    from chaq_sdfgen.ops import edt_triton

    rng = np.random.default_rng(spread)
    b = rng.random((256, 250)) < 0.02  # sparse: large distances live
    inside = oracle.felzenszwalb_edt_2d(oracle.bool_to_indicator(b, True))
    outside = oracle.felzenszwalb_edt_2d(oracle.bool_to_indicator(b, False))
    want = oracle.float_to_byte(
        oracle.signed_merge(outside, inside), spread, False
    )
    got = edt_triton.sdf_bytes(jnp.asarray(b), spread, interpret=True)
    np.testing.assert_array_equal(np.asarray(got), want)


def test_exact_large_spread_single_seed():
    from chaq_sdfgen.ops import edt_triton

    b = np.zeros((200, 130), bool)
    b[5, 7] = True
    inside = oracle.felzenszwalb_edt_2d(oracle.bool_to_indicator(b, True))
    outside = oracle.felzenszwalb_edt_2d(oracle.bool_to_indicator(b, False))
    want = oracle.float_to_byte(
        oracle.signed_merge(outside, inside), 300, True
    )
    got = edt_triton.sdf_bytes(
        jnp.asarray(b), 300, asymmetric=True, interpret=True
    )
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("spread", [638])
def test_exact_spread_band_multiple_of_128(spread):
    """band = spread + 2 a multiple of the 128-column tile and beyond the
    u8 row-distance range: the kernel's u16 storage and sentinel padding
    must keep the bytes exact."""
    from chaq_sdfgen.ops import edt_triton

    rng = np.random.default_rng(spread)
    b = rng.random((64, 80)) < 0.02
    inside = oracle.felzenszwalb_edt_2d(oracle.bool_to_indicator(b, True))
    outside = oracle.felzenszwalb_edt_2d(oracle.bool_to_indicator(b, False))
    want = oracle.float_to_byte(
        oracle.signed_merge(outside, inside), spread, False
    )
    got = edt_triton.sdf_bytes(jnp.asarray(b), spread, interpret=True)
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("band,density", [(3, 0.3), (12, 0.05), (40, 0.01), (64, 0.0)])
def test_band_min_ext_early_exit_matches_every_tap(band, density):
    """The XLA core's loop stops once dy^2 reaches the largest value left;
    its result must equal the plain minimum over every tap of the band."""
    rng = np.random.default_rng(band)
    b = rng.random((70, 33)) < density
    g = np.asarray(edt.row_nearest_sq(jnp.asarray(b), band))
    big = edt.big_sentinel(band)
    gp = np.pad(g, ((band, band), (0, 0)), constant_values=big)
    want = np.min(
        [gp[band + k : band + k + 70] + np.float32(k * k) for k in range(-band, band + 1)],
        axis=0,
    )
    got = np.asarray(edt.band_min_columns(jnp.asarray(g), band))
    np.testing.assert_array_equal(got, want)
