"""One band serves many spreads: distances are exact within the band, so
taps beyond spread+2 clamp identically through the byte remap. Covers the
kernel at a bucketed band, the spread sweep (one program for every
spread), and soft fields with traced (annealed) parameters."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from chaq_sdfgen.models.atlas import _sweep, atlas_sdf_spread_sweep
from chaq_sdfgen.models.sdf_model import hard_sdf_exact_from_bool
from chaq_sdfgen.ops import edt_triton, softsdf


@pytest.mark.parametrize("asym", [False, True])
def test_dynamic_spread_matches_static(asym):
    rng = np.random.default_rng(3)
    b = jnp.asarray(rng.random((96, 200)) < 0.3)
    band = 48  # bucket serving spreads up to 46
    for spread in (3, 17, 30, 46):
        want = np.asarray(
            hard_sdf_exact_from_bool(b, spread, asymmetric=asym, core="xla")
        )
        got = np.asarray(
            edt_triton.sdf_bytes(b, spread, asymmetric=asym, band=band, interpret=True)
        )
        assert (got == want).all(), (spread, asym, int((got != want).sum()))


def test_dynamic_spread_batched():
    rng = np.random.default_rng(4)
    imgs = np.zeros((3, 64, 96, 2), np.uint8)
    imgs[..., 1] = np.where(rng.random((3, 64, 96)) < 0.4, 255, 0)
    b = jnp.asarray(imgs[..., 1] > 127)
    sweep = np.asarray(atlas_sdf_spread_sweep(jnp.asarray(imgs), [7, 20]))
    for i, spread in enumerate((7, 20)):
        want = np.asarray(edt_triton.sdf_bytes(b, spread, band=32, interpret=True))
        assert (sweep[i] == want).all()


def test_dynamic_spread_one_compile():
    # a sweep over several spreads is ONE compiled program
    rng = np.random.default_rng(5)
    imgs = jnp.asarray((rng.random((2, 64, 64, 2)) * 255).astype(np.uint8))
    n0 = _sweep._cache_size()
    atlas_sdf_spread_sweep(imgs, [5, 9, 30])
    assert _sweep._cache_size() == n0 + 1
    atlas_sdf_spread_sweep(imgs, [5, 9, 30])
    assert _sweep._cache_size() == n0 + 1
    with pytest.raises(ValueError):
        atlas_sdf_spread_sweep(imgs, [5, 30], band=16)


def test_dynamic_soft_params_match_static():
    rng = np.random.default_rng(6)
    gray = jnp.asarray((rng.random((64, 96)) * 255).astype(np.float32))

    @jax.jit
    def traced(g, tau, t):
        return softsdf.soft_sdf_field(g, 8, tau=tau, temperature=t)

    for tau, t in ((2.0, 1.0), (0.05, 0.02)):
        want = np.asarray(softsdf.soft_sdf_field_scan(gray, 8, tau, t))
        got = np.asarray(traced(gray, jnp.float32(tau), jnp.float32(t)))
        # traced params divide in f32 (vs double-then-round for static
        # floats) — identical for dyadic values, <= 1 ulp otherwise,
        # amplified through exp by at most ~1e-7 relative
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_dynamic_soft_grad_flows_to_gray():
    rng = np.random.default_rng(7)
    gray = jnp.asarray((rng.random((64, 64)) * 255).astype(np.float32))

    def loss(g, t):
        return jnp.sum(softsdf.soft_sdf_field(g, 8, tau=jnp.float32(2.0), temperature=t))

    dg, dt = jax.grad(loss, argnums=(0, 1))(gray, jnp.float32(1.0))
    assert np.isfinite(np.asarray(dg)).all() and np.abs(np.asarray(dg)).sum() > 0
    assert float(dt) == 0.0  # schedule constants: zero cotangent, documented


def test_soft_sdf_field_traced_temperature():
    # public API with a traced annealing schedule: one jit serves all
    # temperatures through the scan cores
    rng = np.random.default_rng(8)
    gray = jnp.asarray((rng.random((48, 64)) * 255).astype(np.float32))

    @jax.jit
    def field(g, t):
        return softsdf.soft_sdf_field(g, 6, tau=2.0, temperature=t)

    a = np.asarray(field(gray, jnp.float32(1.0)))
    b = np.asarray(field(gray, jnp.float32(0.25)))
    want = np.asarray(softsdf.soft_sdf_field_scan(gray, 6, tau=2.0, temperature=1.0))
    np.testing.assert_allclose(a, want, rtol=2e-5, atol=2e-5)
    assert np.abs(a - b).max() > 1e-3  # schedule actually changes the field


def test_atlas_spread_sweep_matches_per_spread():
    from chaq_sdfgen.config import SdfConfig
    from chaq_sdfgen.models.atlas import atlas_sdf

    rng = np.random.default_rng(9)
    imgs = (rng.random((2, 64, 96, 2)) * 255).astype(np.uint8)
    spreads = [5, 14, 30]
    sweep = np.asarray(atlas_sdf_spread_sweep(jnp.asarray(imgs), spreads))
    for i, s in enumerate(spreads):
        want = np.asarray(atlas_sdf(jnp.asarray(imgs), SdfConfig(spread=s)))
        assert (sweep[i] == want).all(), (s, int((sweep[i] != want).sum()))
