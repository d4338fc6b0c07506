"""Jump-flood SDF (single device): accuracy vs the exact EDT and
structural self-consistency; the exact full-range field JFA is measured
against."""

import numpy as np
import pytest

import jax.numpy as jnp

from sdfref import oracle
from chaq_sdfgen.ops import edt, edt_triton, jfa
from chaq_sdfgen.models.sdf_model import (
    exact_distance_field,
    hard_sdf_exact,
    hard_sdf_jfa,
)


def _exact_d(b):
    return oracle.felzenszwalb_edt_2d(oracle.bool_to_indicator(b, True))


def test_jfa_self_consistent_and_never_underestimates():
    rng = np.random.default_rng(0)
    b = rng.random((40, 40)) < 0.1
    b[0, 0] = True
    sy, sx, d2, valid = [np.asarray(v) for v in jfa.jfa_seed_coords(jnp.asarray(b))]
    assert valid.all()
    # recorded seed is a real seed, and d2 is the distance to it
    yy, xx = np.mgrid[0:40, 0:40]
    assert b[sy, sx].all()
    np.testing.assert_array_equal(d2, (yy - sy) ** 2 + (xx - sx) ** 2)
    # JFA candidates are real seeds -> can never be closer than the true EDT
    exact = _exact_d(b) ** 2
    assert (d2 + 1e-3 >= exact).all()


@pytest.mark.parametrize("density", [0.02, 0.2, 0.6])
def test_jfa_matches_exact_overwhelmingly(density):
    rng = np.random.default_rng(1)
    b = rng.random((64, 48)) < density
    if not b.any():
        b[10, 10] = True
    d = np.asarray(jfa.jfa_distance(jnp.asarray(b)))
    exact = _exact_d(b)
    match = np.isclose(d, exact, rtol=0, atol=0)
    assert match.mean() >= 0.999, f"exact-match rate {match.mean()}"
    assert np.max(np.abs(d - exact)) <= 1.0


def test_jfa_single_seed_exact():
    b = np.zeros((33, 47), dtype=bool)
    b[5, 17] = True
    d = np.asarray(jfa.jfa_distance(jnp.asarray(b)))
    yy, xx = np.mgrid[0:33, 0:47]
    want = np.sqrt(((yy - 5) ** 2 + (xx - 17) ** 2).astype(np.float32), dtype=np.float32)
    np.testing.assert_array_equal(d, want)


def test_jfa_no_seeds_saturates():
    b = np.zeros((8, 8), dtype=bool)
    d = np.asarray(jfa.jfa_distance(jnp.asarray(b)))
    assert (d == 32768.0).all()


def test_jfa_pipeline_bytes_close_to_exact():
    rng = np.random.default_rng(2)
    bb = rng.random((56, 56)) < 0.3
    img2ch = np.zeros((56, 56, 2), dtype=np.uint8)
    img2ch[..., 1] = np.where(bb, 255, 0)
    got = np.asarray(hard_sdf_jfa(jnp.asarray(img2ch), spread=12))
    want = np.asarray(hard_sdf_exact(jnp.asarray(img2ch), spread=12, core="xla"))
    diff = np.abs(got.astype(int) - want.astype(int))
    assert (diff == 0).mean() >= 0.999
    assert diff.max() <= 11  # a JFA miss is off by at most ~1px of distance


def test_jfa_batched():
    rng = np.random.default_rng(3)
    b = rng.random((2, 16, 16)) < 0.3
    d = np.asarray(jfa.jfa_distance(jnp.asarray(b)))
    for i in range(2):
        di = np.asarray(jfa.jfa_distance(jnp.asarray(b[i])))
        np.testing.assert_array_equal(d[i], di)


def test_exact_distance_field_matches_bruteforce():
    """The exact full-range field (sdf_model.exact_distance_field) vs a
    brute-force integer reference — no JFA-style misses by construction."""
    rng = np.random.default_rng(44)
    for shape, p in [((96, 80), 0.05), ((200, 130), 0.002)]:
        b = rng.random(shape) < p
        got = np.asarray(
            exact_distance_field(jnp.asarray(b), core="xla")
        )
        ys, xs = np.nonzero(b)
        H, W = shape
        yy, xx = np.mgrid[0:H, 0:W]
        d2ref = np.min(
            (yy[..., None] - ys[None, None]) ** 2
            + (xx[..., None] - xs[None, None]) ** 2,
            axis=-1,
        )
        np.testing.assert_allclose(
            got.astype(np.float64), np.sqrt(d2ref.astype(np.float64)), atol=1e-3
        )


def test_exact_distance_field_no_seeds_and_far_corner():
    b0 = np.zeros((64, 96), bool)
    got = np.asarray(exact_distance_field(jnp.asarray(b0), core="xla"))
    assert (got == 32768.0).all()  # jfa_distance's no-seed value
    b1 = np.zeros((256, 256), bool)
    b1[0, 0] = True
    got = np.asarray(exact_distance_field(jnp.asarray(b1), core="xla"))
    assert abs(got[255, 255] - np.sqrt(2 * 255.0**2)) < 1e-3


def test_exact_distance_field_beats_jfa_on_misses():
    """JFA can miss (overestimate); the exact field never under- or
    over-estimates. On random dense seeds both agree except at JFA's
    rare miss pixels, where exact <= jfa."""
    rng = np.random.default_rng(45)
    b = jnp.asarray(rng.random((128, 128)) < 0.02)
    exact = np.asarray(exact_distance_field(b, core="xla"))
    approx = np.asarray(jfa.jfa_distance(b))
    assert (exact <= approx + 1e-4).all()


def test_exact_distance_field_beyond_4096():
    """Regression: >4096 px used to raise; now the
    saturation tier scales with the image (exact i32 d^2 up to 16384 px
    per side). Tall sparse image straddling the 4096 boundary."""
    assert edt.full_range_sat(4096) == 8191
    assert edt.full_range_sat(8192) == 16383
    assert edt.full_range_sat(16384) == 23170
    assert edt.full_range_sat(16385) is None
    # tier invariants: sat > sqrt(2)*(n-1), sat^2 + (n-1)^2 < 2^31
    for n, sat in ((4096, 8191), (8192, 16383), (16384, 23170)):
        assert sat * sat > 2 * (n - 1) * (n - 1)
        assert sat * sat + (n - 1) * (n - 1) < 2**31

    b = np.zeros((4104, 128), bool)
    b[2, 5] = True
    b[4100, 100] = True
    got = np.asarray(
        exact_distance_field(jnp.asarray(b), core="xla")
    )
    ys, xs = np.nonzero(b)
    yy, xx = np.mgrid[0 : b.shape[0], 0 : b.shape[1]]
    d2ref = np.min(
        (yy[..., None] - ys[None, None]) ** 2
        + (xx[..., None] - xs[None, None]) ** 2,
        axis=-1,
    )
    np.testing.assert_allclose(
        got.astype(np.float64), np.sqrt(d2ref.astype(np.float64)),
        rtol=1e-6, atol=1e-3,
    )


@pytest.mark.parametrize("shape,p", [((96, 80), 0.05), ((70, 200), 0.01), ((33, 129), 0.0)])
def test_exact_distance_field_kernel_matches_xla(shape, p):
    """The GPU kernel's full-range epilogue (interpreted) is bitwise equal
    to the XLA core, no-seed value included."""
    rng = np.random.default_rng(46)
    b = jnp.asarray(rng.random(shape) < p)
    want = np.asarray(exact_distance_field(b, core="xla"))
    got = np.asarray(edt_triton.distance_field(b, sat=8191, interpret=True))
    np.testing.assert_array_equal(got, want)
