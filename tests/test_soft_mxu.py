"""The two-matmul soft cascade (ops/soft_mxu.py) vs the scan cores.

The cascade is plain XLA (einsum) and runs natively on the CPU. Each case
runs it two ways: "mm" calls the cascade with a declared range (static
shift), "gated" goes through soft_sdf_field's runtime range gate (no
declared range, the shift a traced scalar). The reference is the
streaming scan cores (full band, exact soft-min), so these tests bound
BOTH the K-tap truncation and the matmul formulation."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from chaq_sdfgen.ops import soft_mxu, softsdf

TAU, T, EPS = 2.0, 1.0, 1e-6


def _scan(gray, spread, **kw):
    return softsdf.soft_sdf_field_scan(gray, spread, tau=TAU, temperature=T, eps=EPS, **kw)


def _cascade(route, gray, band, test_above=True):
    if route == "mm":
        return soft_mxu.soft_sdf_field_mxu(gray, band, TAU, T, EPS, test_above=test_above)
    return softsdf.soft_sdf_field(
        gray, band - 2, tau=TAU, temperature=T, eps=EPS, test_above=test_above,
        band=band,
    )


@pytest.mark.parametrize("pass2", ["mm", "gated"])
@pytest.mark.parametrize("shape,spread", [((129, 130), 9), ((256, 256), 14)])
def test_mxu_field_matches_composed(shape, spread, pass2):
    rng = np.random.default_rng(3)
    gray = jnp.asarray((rng.random(shape) * 255).astype(np.float32))
    band = spread + 2
    got = _cascade(pass2, gray, band)
    want = _scan(gray, spread)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=2e-3, rtol=0)


@pytest.mark.parametrize("pass2", ["mm", "gated"])
def test_mxu_gradient_matches_composed(pass2):
    rng = np.random.default_rng(5)
    gray = jnp.asarray((rng.random((136, 140)) * 255).astype(np.float32))
    spread = 9
    band = spread + 2
    w = jnp.asarray(rng.standard_normal((136, 140)).astype(np.float32))

    def loss_mxu(g):
        return jnp.sum(w * _cascade(pass2, g, band))

    def loss_ref(g):
        return jnp.sum(w * _scan(g, spread))

    g1 = jax.grad(loss_mxu)(gray)
    g2 = jax.grad(loss_ref)(gray)
    assert np.isfinite(np.asarray(g1)).all()
    scale = float(jnp.max(jnp.abs(g2))) + 1e-12
    # atol 2e-2: pixels right at the sigmoid knee (gray ~ 127.5) have
    # op-order-sensitive analytic gradients (einsum cascade vs streaming
    # scan). Both paths FD-verify to 4e-4 relative at every probe eps —
    # same function — but the loss curvature at the knee is ~100x the
    # gradient, so ULP-level forward differences amplify to ~1.8% on
    # exactly 1 px of 19k (measured; next-worst px is 0.6%).
    np.testing.assert_allclose(
        np.asarray(g1) / scale, np.asarray(g2) / scale, atol=2e-2, rtol=0
    )


@pytest.mark.parametrize("pass2", ["mm", "gated"])
def test_mxu_gradient_vs_finite_difference(pass2):
    rng = np.random.default_rng(11)
    h, w = 136, 140
    gray0 = (rng.random((h, w)) * 255).astype(np.float32)
    weights = rng.standard_normal((h, w)).astype(np.float32)
    band = 11

    def loss(g):
        return jnp.vdot(_cascade(pass2, g, band), jnp.asarray(weights))

    grad = np.asarray(jax.grad(loss)(jnp.asarray(gray0)))
    assert np.isfinite(grad).all()
    f = jax.jit(loss)
    eps = 0.25
    for _ in range(8):
        y, x = rng.integers(0, h), rng.integers(0, w)
        gp = gray0.copy(); gp[y, x] += eps
        gm = gray0.copy(); gm[y, x] -= eps
        fd = (float(f(jnp.asarray(gp))) - float(f(jnp.asarray(gm)))) / (2 * eps)
        assert abs(fd - grad[y, x]) <= 2e-2 + 0.05 * abs(fd), (y, x, fd, grad[y, x])


@pytest.mark.parametrize("pass2", ["mm", "gated"])
def test_mxu_inverted_test_above(pass2):
    rng = np.random.default_rng(7)
    gray = jnp.asarray((rng.random((130, 132)) * 255).astype(np.float32))
    band = 10
    got = _cascade(pass2, gray, band, test_above=False)
    want = _scan(gray, band - 2, test_above=False, band=band)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=2e-3, rtol=0)


def test_mxu_mm_large_band():
    """The cascade has no band-geometry limit: band 140 must work and
    match the scan cores."""
    rng = np.random.default_rng(9)
    gray = jnp.asarray((rng.random((140, 136)) * 255).astype(np.float32))
    band = 140
    got = soft_mxu.soft_sdf_field_mxu(gray, band, TAU, T, EPS)
    want = _scan(gray, band - 2, band=band)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=2e-3, rtol=0)


def test_mxu_vmapped_matches_2d():
    """soft_sdf_field vmaps the cascade over leading axes for batched
    (atlas) inputs — the batched result must equal per-image calls."""
    rng = np.random.default_rng(13)
    gray = jnp.asarray((rng.random((2, 130, 132)) * 255).astype(np.float32))
    band = 10

    def f(g):
        return soft_mxu.soft_sdf_field_mxu(g, band, TAU, T, EPS)

    got = softsdf.soft_sdf_field(gray, band - 2, tau=TAU, temperature=T, eps=EPS,
                                 band=band, gray_range=(0.0, 255.0))
    for i in range(gray.shape[0]):
        np.testing.assert_allclose(
            np.asarray(got[i]), np.asarray(f(gray[i])), atol=1e-5, rtol=0
        )


def test_soft_sdf_field_accepts_gray_range():
    """A declared range takes the cascade with its static shift: bitwise
    the direct cascade call, and within the truncation bound of the
    undeclared (runtime-gated) call."""
    rng = np.random.default_rng(17)
    gray = jnp.asarray((rng.random((64, 66)) * 255).astype(np.float32))
    a = softsdf.soft_sdf_field(gray, 8, tau=TAU, temperature=T, gray_range=(0.0, 255.0))
    b = softsdf.soft_sdf_field(gray, 8, tau=TAU, temperature=T)
    direct = soft_mxu.soft_sdf_field_mxu(gray, 10, TAU, T, 1e-6)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(direct))
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-3, rtol=0)


def test_mxu_gate(monkeypatch):
    gray = jnp.zeros((64, 64), jnp.float32)
    # any platform: the gate depends on the parameters and the range only
    assert soft_mxu.mxu_ok(gray, 10, 2.0, 1.0, (0.0, 255.0))
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert soft_mxu.mxu_ok(gray, 10, 2.0, 1.0, (0.0, 255.0))
    # traced params and a missing range are rejected; batches are fine
    assert not soft_mxu.mxu_ok(gray, 10, jnp.float32(2.0), 1.0, (0.0, 255.0))
    assert not soft_mxu.mxu_ok(gray, 10, 2.0, 1.0, None)
    assert soft_mxu.mxu_ok(gray[None], 10, 2.0, 1.0, (0.0, 255.0))
    # out-of-gamut range (h_max/T too large for the global shift)
    assert not soft_mxu.mxu_ok(gray, 10, 0.1, 1.0, (0.0, 255.0))
    assert soft_mxu._range_stats(10, 0.1, 1.0, (0.0, 255.0)) is None
    with pytest.raises(ValueError):
        soft_mxu.soft_sdf_field_mxu(gray, 10, 0.1, 1.0, EPS, gray_range=(0.0, 255.0))
    # in-gamut: K clamps to band, shift activates for wider ranges
    k, c = soft_mxu._range_stats(10, 2.0, 1.0, (0.0, 255.0))
    assert 1 <= k <= 10 and c >= 0.0


def test_conv_sym_self_adjoint():
    """The custom VJP of conv_rows_sym/conv_cols_sym claims the banded
    Gaussian conv with zero boundary is exactly self-adjoint:
    <conv(x), y> == <x, conv(y)>. Verify the identity directly AND that
    jax.grad through the custom VJP matches the identity's prediction
    (grad of <conv(x), y> wrt x IS conv(y))."""
    rng = np.random.default_rng(11)
    k, temp = 5, 1.3
    x = jnp.asarray(rng.standard_normal((128, 128)).astype(np.float32))
    y = jnp.asarray(rng.standard_normal((128, 128)).astype(np.float32))
    for conv in (soft_mxu.conv_rows_sym, soft_mxu.conv_cols_sym):
        lhs = jnp.vdot(conv(x, k, temp), y)
        rhs = jnp.vdot(x, conv(y, k, temp))
        np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-5)
        g = jax.grad(lambda v: jnp.vdot(conv(v, k, temp), y))(x)
        np.testing.assert_allclose(
            np.asarray(g), np.asarray(conv(y, k, temp)), rtol=1e-5, atol=1e-6
        )


def test_conv_sym_narrow_block_matches_wide():
    """k <= 16 selects 64-wide window blocks (_conv_blk); the values must
    match the 128-wide form to f32 reassociation error."""
    rng = np.random.default_rng(12)
    e = jnp.asarray(rng.standard_normal((128, 256)).astype(np.float32))
    k, temp = 9, 2.0
    assert soft_mxu._conv_blk(k) == 64
    w128 = soft_mxu._band_matrix(k, temp, blk=128)
    got = soft_mxu.conv_rows_sym(e, k, temp)
    want = soft_mxu._conv_rows(e, w128, k)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    got = soft_mxu.conv_cols_sym(e, k, temp)
    want = soft_mxu._conv_cols(e, w128, k)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_mxu_mm_einsum_fallback_still_matches():
    """The cascade at a lower matmul precision stays within the field
    bound of the HIGHEST-precision cascade (the CPU computes every
    precision in full float32, so this checks the plumbing; the card's
    numbers are in chip_smoke.py)."""
    rng = np.random.default_rng(21)
    gray = jnp.asarray((rng.random((256, 200)) * 255).astype(np.float32))
    band = 16
    want = soft_mxu.soft_sdf_field_mxu(gray, band, TAU, T, EPS)
    for prec in ("high", "default"):
        got = soft_mxu.soft_sdf_field_mxu(gray, band, TAU, T, EPS, precision=prec)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=2e-3, rtol=0)


@pytest.mark.parametrize("tau,t", [(1.0, 0.5), (4.0, 1.5), (2.0, 0.5), (8.0, 2.0)])
def test_cascade_matches_scan_over_temperatures(tau, t):
    """The declared-range cascade within the field bound of the scan cores
    wherever its gamut admits the temperatures."""
    rng = np.random.default_rng(int(tau * 10 + t * 100))
    gray = jnp.asarray((rng.random((96, 100)) * 255).astype(np.float32))
    band = 12
    assert soft_mxu.mxu_ok(gray, band, tau, t, (0.0, 255.0))
    got = soft_mxu.soft_sdf_field_mxu(gray, band, tau, t, EPS)
    want = softsdf.soft_sdf_field_scan(gray, band - 2, tau=tau, temperature=t, eps=EPS, band=band)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=2e-3, rtol=0)
