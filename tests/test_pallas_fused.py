"""The runtime-gated soft path (no declared range) vs the scan cores.

soft_sdf_field without a gray_range measures the input's height range and
takes the two-matmul cascade when it fits, the scan cores otherwise; both
branches must agree with the scan-core reference in values and gradients,
and with finite differences.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from chaq_sdfgen.ops import softsdf


def _gated(gray, band, tau, t, eps, test_above=True):
    return softsdf.soft_sdf_field(
        gray, band - 2, tau=tau, temperature=t, eps=eps,
        test_above=test_above, band=band,
    )


def _field_ref(gray, band, tau, t, eps, test_above=True):
    return softsdf.soft_sdf_field_scan(
        jnp.asarray(gray), band - 2, tau=tau, temperature=t, eps=eps,
        test_above=test_above, band=band,
    )


@pytest.mark.parametrize(
    "h,w,band,tau,t",
    [(40, 36, 5, 2.0, 1.0), (130, 150, 17, 1.5, 0.5), (64, 64, 3, 4.0, 1.5)],
)
def test_fused_fwd_matches_composed(h, w, band, tau, t):
    rng = np.random.default_rng(band + h)
    gray = (rng.random((h, w)) * 255).astype(np.float32)
    got = np.asarray(
        _gated(jnp.asarray(gray), band, tau, t, 1e-6, True)
    )
    want = np.asarray(_field_ref(gray, band, tau, t, 1e-6))
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-2)


def test_fused_fwd_inverted_threshold():
    rng = np.random.default_rng(9)
    gray = (rng.random((48, 40)) * 255).astype(np.float32)
    got = np.asarray(
        _gated(jnp.asarray(gray), 5, 2.0, 1.0, 1e-6, False)
    )
    want = np.asarray(_field_ref(gray, 5, 2.0, 1.0, 1e-6, test_above=False))
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-2)


def test_fused_grad_matches_composed():
    rng = np.random.default_rng(3)
    h, w, band, tau, t = 40, 36, 5, 3.0, 1.0
    gray = (rng.random((h, w)) * 255).astype(np.float32)
    ct = rng.standard_normal((h, w)).astype(np.float32)

    def loss_fused(g):
        return jnp.vdot(
            _gated(g, band, tau, t, 1e-6, True),
            jnp.asarray(ct),
        )

    def loss_ref(g):
        return jnp.vdot(_field_ref(g, band, tau, t, 1e-6), jnp.asarray(ct))

    g1 = np.asarray(jax.grad(loss_fused)(jnp.asarray(gray)))
    g2 = np.asarray(jax.grad(loss_ref)(jnp.asarray(gray)))
    assert np.abs(g2).max() > 0
    scale = np.abs(g2).max()
    # pixels where the 1{d2>0} clip mask sits within rounding of flipping
    # legitimately disagree between the two formulations; every outlier
    # must be explained by such a kink within its (y then x) band
    # neighbourhood
    bad = np.abs(g1 - g2) > 2e-2 * scale + 2e-2 * np.abs(g2)
    assert bad.mean() < 0.02, f"{bad.sum()} gradient outliers"
    if bad.any():
        from chaq_sdfgen.ops import threshold
        from chaq_sdfgen.ops.edt import big_sentinel
        big = big_sentinel(band)
        logits = threshold.soft_logits(jnp.asarray(gray), tau=tau)
        kink = np.zeros((h, w), bool)
        for seeds_on in (True, False):
            hh = threshold.soft_log_indicator_from_logits(logits, t, seeds_on, big)
            d2 = np.asarray(softsdf.soft_edt_sq(hh, band, t))
            kink |= np.abs(d2) < 0.1
        for dy in range(-band, band + 1):
            kink |= np.roll(kink, dy, axis=0)
        for dx in range(-band, band + 1):
            kink |= np.roll(kink, dx, axis=1)
        unexplained = bad & ~kink
        assert not unexplained.any(), np.argwhere(unexplained)[:10]
        # and even at kinks the error is bounded by the gradient scale
        assert np.abs(g1[bad] - g2[bad]).max() < 2.0 * scale


def test_fused_grad_finite_difference():
    rng = np.random.default_rng(4)
    h, w, band, tau, t = 24, 20, 4, 4.0, 1.5
    gray = (rng.random((h, w)) * 255).astype(np.float32)
    weights = rng.standard_normal((h, w)).astype(np.float32)

    def loss(g):
        return jnp.vdot(
            _gated(g, band, tau, t, 1e-6, True),
            jnp.asarray(weights),
        )

    grad = np.asarray(jax.grad(loss)(jnp.asarray(gray)))
    f = jax.jit(loss)
    eps = 0.25
    for _ in range(8):
        y, x = rng.integers(0, h), rng.integers(0, w)
        gp = gray.copy(); gp[y, x] += eps
        gm = gray.copy(); gm[y, x] -= eps
        fd = (float(f(jnp.asarray(gp))) - float(f(jnp.asarray(gm)))) / (2 * eps)
        assert abs(fd - grad[y, x]) <= 3e-2 + 0.08 * abs(fd), (y, x, fd, grad[y, x])


def test_fused_grad_fidelity_multiblock():
    """At shapes spanning several 128-row windows of the cascade, its
    gradient must track the scan cores tightly everywhere (near-tied
    soft-min weights must not reroute isolated pixel gradients)."""
    from chaq_sdfgen.ops import softsdf

    rng = np.random.default_rng(7)
    h, w, spread, tau, t = 150, 117, 6, 2.0, 1.0
    band = spread + 2
    gray = jnp.asarray((rng.random((h, w)) * 255).astype(np.float32))
    wv = jnp.asarray(rng.standard_normal((h, w)).astype(np.float32))

    g_f = np.asarray(
        jax.grad(
            lambda g: jnp.vdot(
                _gated(g, band, tau, t, 1e-6, True), wv
            )
        )(gray)
    )
    g_c = np.asarray(
        jax.grad(
            lambda g: jnp.vdot(
                softsdf.soft_sdf_field_scan(g, spread, tau=tau, temperature=t), wv
            )
        )(gray)
    )
    scale = max(np.abs(g_c).max(), 1e-6)
    assert np.abs(g_f - g_c).max() < 1e-2 * scale, np.abs(g_f - g_c).max()
    # forward too
    v_f = np.asarray(_gated(gray, band, tau, t, 1e-6, True))
    v_c = np.asarray(softsdf.soft_sdf_field_scan(gray, spread, tau=tau, temperature=t))
    np.testing.assert_allclose(v_f, v_c, rtol=1e-4, atol=1e-4)
