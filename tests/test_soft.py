"""Soft differentiable path: hard-limit consistency,
custom-VJP correctness vs autodiff, and gradient-vs-finite-difference."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from chaq_sdfgen.ops import softsdf, edt, merge
from chaq_sdfgen.ops.threshold import hard_threshold


def make_gray(rng, h, w):
    g = (rng.random((h, w)) * 255).astype(np.float32)
    return g


def test_band_softmin_matches_bruteforce_logsumexp():
    rng = np.random.default_rng(0)
    g = (rng.random((6, 9)) * 20).astype(np.float32)
    band, t = 3, 0.7
    got = np.asarray(softsdf.band_softmin(jnp.asarray(g), band, t, axis=-1))
    # reference: direct dense computation
    want = np.zeros_like(g)
    for y in range(6):
        for x in range(9):
            zs = []
            for d in range(-band, band + 1):
                xx = x + d
                if 0 <= xx < 9:
                    zs.append(-(d * d + g[y, xx]) / t)
            m = max(zs)
            want[y, x] = -t * (m + np.log(sum(np.exp(z - m) for z in zs)))
    # rtol: device exp/log may be ~1-2 ulp off libm, which shows as
    # isolated ~5e-5 relative deviations vs the float64-ish reference
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_band_softmin_custom_vjp_matches_autodiff():
    rng = np.random.default_rng(1)
    g = jnp.asarray((rng.random((8, 8)) * 10).astype(np.float32))
    band, t = 2, 0.5
    ct = jnp.asarray(rng.standard_normal((8, 8)).astype(np.float32))

    def with_vjp(x):
        return jnp.vdot(softsdf.band_softmin(x, band, t, axis=-2), ct)

    def without_vjp(x):
        xp = jnp.pad(x, ((band, band), (0, 0)), constant_values=softsdf._PAD_HEIGHT)
        return jnp.vdot(softsdf._band_softmin_fwd_impl(xp, band, t, -2), ct)

    g1 = jax.grad(with_vjp)(g)
    g2 = jax.grad(without_vjp)(g)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), rtol=2e-4, atol=1e-4)


def test_soft_converges_to_hard():
    rng = np.random.default_rng(2)
    b = rng.random((24, 20)) < 0.4
    gray = np.where(b, 240.0, 10.0).astype(np.float32)
    spread = 6
    soft = np.asarray(
        softsdf.soft_sdf_field(
            jnp.asarray(gray), spread, tau=0.05, temperature=0.02, eps=1e-8
        )
    )
    d_in, d_out = edt.dual_edt_banded(jnp.asarray(b), spread + 2)
    hard = np.asarray(merge.signed_merge(d_out, d_in))
    # compare where the hard field is within the band (saturation differs);
    # softmin sits below hard min by up to T*log(#equidistant seeds)
    m = np.abs(hard) <= spread
    np.testing.assert_allclose(soft[m], hard[m], rtol=1e-3, atol=0.05)


def test_soft_gradient_vs_finite_difference():
    rng = np.random.default_rng(3)
    h, w = 16, 14
    gray0 = make_gray(rng, h, w)
    weights = rng.standard_normal((h, w)).astype(np.float32)
    spread, tau, temp = 5, 4.0, 1.5

    def loss(g):
        s = softsdf.soft_sdf_field(g, spread, tau=tau, temperature=temp)
        return jnp.vdot(s, jnp.asarray(weights))

    grad = np.asarray(jax.grad(loss)(jnp.asarray(gray0)))
    # central finite differences on a random subset of pixels
    f = jax.jit(loss)
    eps = 0.25
    for _ in range(12):
        y, x = rng.integers(0, h), rng.integers(0, w)
        gp = gray0.copy(); gp[y, x] += eps
        gm = gray0.copy(); gm[y, x] -= eps
        fd = (float(f(jnp.asarray(gp))) - float(f(jnp.asarray(gm)))) / (2 * eps)
        assert abs(fd - grad[y, x]) <= 2e-2 + 0.05 * abs(fd), (y, x, fd, grad[y, x])


def test_soft_bytes_in_range_and_jittable():
    rng = np.random.default_rng(4)
    gray = make_gray(rng, 20, 20)
    out = jax.jit(
        lambda g: softsdf.soft_sdf_bytes(g, 8, asymmetric=False, tau=1.0, temperature=0.5)
    )(jnp.asarray(gray))
    o = np.asarray(out)
    assert o.min() >= 0.0 and o.max() <= 255.0


def test_soft_batched_grad():
    rng = np.random.default_rng(5)
    gray = np.stack([make_gray(rng, 12, 12) for _ in range(3)])

    def loss(g):
        return jnp.sum(softsdf.soft_sdf_field(g, 4, tau=2.0, temperature=1.0) ** 2)

    g = jax.grad(loss)(jnp.asarray(gray))
    assert np.asarray(g).shape == gray.shape
    assert np.isfinite(np.asarray(g)).all()


def test_large_spread_composed_fallback_parity():
    """spread 128 (band 130 > the fused geometry's 112) must still work —
    the reference accepts any -s (openmp/sdfgen.c:174-180). On a dense
    random image every distance is tiny, so the extra taps beyond a
    covering band contribute < e^-27: the spread-128 field must match a
    spread-14 field to tight tolerance."""
    rng = np.random.default_rng(31)
    gray = jnp.asarray(make_gray(rng, 48, 40))
    big = np.asarray(softsdf.soft_sdf_field(gray, 128, tau=2.0, temperature=1.0))
    small = np.asarray(softsdf.soft_sdf_field(gray, 14, tau=2.0, temperature=1.0))
    assert np.isfinite(big).all()
    np.testing.assert_allclose(big, small, rtol=1e-5, atol=1e-5)


def test_large_spread_gradient_vs_finite_difference():
    rng = np.random.default_rng(32)
    h, w = 24, 20
    gray0 = make_gray(rng, h, w)
    weights = rng.standard_normal((h, w)).astype(np.float32)

    def loss(g):
        s = softsdf.soft_sdf_field(g, 128, tau=4.0, temperature=1.5)
        return jnp.vdot(s, jnp.asarray(weights))

    grad = np.asarray(jax.grad(loss)(jnp.asarray(gray0)))
    assert np.isfinite(grad).all()
    f = jax.jit(loss)
    eps = 0.25
    for _ in range(6):
        y, x = rng.integers(0, h), rng.integers(0, w)
        gp = gray0.copy(); gp[y, x] += eps
        gm = gray0.copy(); gm[y, x] -= eps
        fd = (float(f(jnp.asarray(gp))) - float(f(jnp.asarray(gm)))) / (2 * eps)
        assert abs(fd - grad[y, x]) <= 2e-2 + 0.05 * abs(fd), (y, x, fd, grad[y, x])


def test_rt_gate_remat_fallback_grads_equal():
    """The runtime-gated dispatch (softsdf.soft_sdf_field, no declared
    range) remats its scan-core fallback branch so lax.cond's residual
    UNION stays small. jax.checkpoint around the custom-vjp scan cores
    must preserve gradients in both cond regimes — to float32 rounding:
    XLA fuses the recomputed forward inside the conditional differently
    (measured 1-ulp differences on the CPU) — and the public gate must
    give those same gradients."""
    from chaq_sdfgen.ops import soft_mxu

    spread, tau_f, t_f, eps_f = 14, 2.0, 1.0, 1e-6
    band = spread + 2
    limit, k1, k2 = soft_mxu.runtime_gate(band, tau_f, t_f)
    rng = np.random.default_rng(33)
    cases = {
        "in-gamut": (rng.random((128, 128)) * 255).astype(np.float32),
        "out-of-gamut": (rng.random((128, 128)) * 4000 - 2000).astype(np.float32),
    }

    def gated(g, remat):
        labs = jnp.max(jnp.abs(g - 127.5)) / jnp.float32(tau_f)
        h_max = jnp.float32(t_f) * jax.nn.softplus(labs)
        pred = h_max <= jnp.float32(limit)
        shift = jax.lax.stop_gradient(
            jnp.maximum(h_max - jnp.float32(60.0 * t_f), 0.0)
        )
        rt = lambda x: soft_mxu.cascade_field(
            x, tau_f, t_f, eps_f, True, k1, k2, shift
        )
        ad = lambda x: softsdf.soft_sdf_field_scan(x, spread, tau_f, t_f, eps_f)
        if remat:
            ad = jax.checkpoint(ad)
        return jax.lax.cond(pred, rt, ad, g)

    for tag, arr in cases.items():
        g = jnp.asarray(arr)
        g1 = jax.grad(lambda x: jnp.sum(gated(x, False)))(g)
        g2 = jax.grad(lambda x: jnp.sum(gated(x, True)))(g)
        np.testing.assert_allclose(np.asarray(g2), np.asarray(g1), rtol=1e-6, atol=1e-7)
        g3 = jax.grad(
            lambda x: jnp.sum(softsdf.soft_sdf_field(x, spread, tau_f, t_f, eps_f))
        )(g)
        np.testing.assert_allclose(np.asarray(g3), np.asarray(g2), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("spread,tau,t,route", [
    (14, 2.0, 1.0, "cascade"),   # u8 range fits the gate at default taps
    (14, 0.1, 1.0, "scan"),      # h_max/T = 1275: beyond the f32 shift bound
    (1, 2.0, 1.0, "scan"),       # band 3: no tap radius covers the cut
])
def test_runtime_gate_routes(spread, tau, t, route):
    """soft_mxu.runtime_gate decides statically whether a cascade exists;
    with one, the traced range test picks it for u8-range inputs."""
    from chaq_sdfgen.ops import soft_mxu

    band = spread + 2
    gate = soft_mxu.runtime_gate(band, tau, t)
    gray = jnp.asarray(np.linspace(0, 255, 40 * 36, dtype=np.float32).reshape(40, 36))
    labs = float(jnp.max(jnp.abs(gray - 127.5))) / tau
    h_max = t * float(jax.nn.softplus(labs))
    taken = "cascade" if gate is not None and h_max <= gate[0] else "scan"
    assert taken == route
    got = softsdf.soft_sdf_field(gray, spread, tau=tau, temperature=t)
    want = softsdf.soft_sdf_field_scan(gray, spread, tau=tau, temperature=t)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=2e-3, rtol=0)
