"""Differentiable (soft) SDF path — no reference analogue: pixel gradients
flow from the output SDF back to input intensities.

Construction (mirrors the hard pipeline structurally):
  occupancy   o = sigmoid((v - 127.5)/tau)          (soft threshold)
  heights     h_in = -T log o,  h_out = -T log(1-o) (soft indicator)
  soft-min    D = -T log sum exp(-(dx^2+dy^2+h)/T)  (soft parabola envelope)
  distance    d = sqrt(relu(D) + eps)
  merge       s = d_out - relu(d_in - 1)            (the -1 bias, soft)

The 2-D soft-min separates exactly into two 1-D banded passes because
logsumexp distributes over the additive decomposition dx^2 + dy^2 + h —
the same two-pass structure as the hard EDT (and as blockwise softmax in
flash attention, which is also how it shards: the streaming (max, sumexp)
state merges associatively across tiles).

band_softmin carries a custom VJP: the backward pass recomputes the
softmax weights from the saved output instead of storing per-tap
residuals, keeping memory O(n^2) instead of O(n^2 * band).
As (tau, T) -> 0 the whole pipeline converges to the hard EXACT path.
"""

from __future__ import annotations

import functools
import logging

import jax
import jax.numpy as jnp
from jax import lax

from chaq_sdfgen.ops import threshold
from chaq_sdfgen.ops.edt import big_sentinel

log = logging.getLogger(__name__)


_PAD_HEIGHT = 1e30  # sentinel height: exp(-(d^2+1e30)/T) underflows to 0


def band_softmin(g: jnp.ndarray, band: int, temperature: float, axis: int = -2) -> jnp.ndarray:
    """S(p) = -T log sum_{|d| <= band} exp(-(d^2 + g(p+d))/T) along ``axis``.

    Streaming (max, sumexp) accumulation over taps — numerically stable for
    any T. Out-of-range taps contribute exp(-inf) = 0.
    """
    axis = axis % g.ndim
    pad = [(0, 0)] * g.ndim
    pad[axis] = (band, band)
    gp = jnp.pad(g, pad, constant_values=jnp.float32(_PAD_HEIGHT))
    return band_softmin_ext(gp, band, temperature, axis)


def band_softmin_ext(gext: jnp.ndarray, band: int, temperature, axis: int = -2) -> jnp.ndarray:
    """band_softmin on a pre-extended input (``band`` extra entries on each
    side of ``axis`` — boundary sentinels or an exchanged shard halo).
    Output is 2*band shorter along ``axis`` than the input.

    temperature may be a Python float or a traced scalar (annealing
    schedules: one compile serves every value; the schedule gets a zero
    cotangent)."""
    return _band_softmin_ext_p(gext, jnp.asarray(temperature, jnp.float32), band, axis)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3))
def _band_softmin_ext_p(gext, t_arr, band, axis):
    return _band_softmin_fwd_impl(gext, band, t_arr, axis)


def _band_softmin_fwd_impl(gext, band, temperature, axis):
    axis = axis % gext.ndim
    h = gext.shape[axis] - 2 * band
    t = jnp.asarray(temperature, jnp.float32)
    neg_huge = jnp.float32(-3e38)

    def step(carry, k):
        m, s = carry
        dy = (k - band).astype(jnp.float32)
        tap = lax.dynamic_slice_in_dim(gext, k, h, axis=axis)
        z = -(dy * dy + tap) / t
        # online logsumexp with a single exp of a non-positive gap: equal
        # to s*exp(m-m2) + exp(z-m2), but no compiler rewrite of
        # exp(a - b) into exp(a)/exp(b) can meet the pad sentinel's
        # -5e31-scale exponents (0/0 = NaN at small T). exp(neg_huge - z)
        # == 0 handles the init.
        e = jnp.exp(-jnp.abs(m - z))
        s2 = jnp.where(m >= z, s + e, s * e + jnp.float32(1.0))
        return (jnp.maximum(m, z), s2), None

    # derive carries from a slice so their sharding/varying type matches
    # under shard_map (jnp.full would be replicated)
    zeros = lax.slice_in_dim(gext, band, band + h, axis=axis) * jnp.float32(0.0)
    m0 = zeros + neg_huge
    s0 = zeros
    (m, s), _ = lax.scan(step, (m0, s0), jnp.arange(2 * band + 1, dtype=jnp.int32))
    return -t * (m + jnp.log(jnp.maximum(s, jnp.float32(1e-38))))


def _band_softmin_ext_fwd(gext, t_arr, band, axis):
    out = _band_softmin_ext_p(gext, t_arr, band, axis)
    return out, (gext, t_arr, out)


def _band_softmin_ext_bwd(band, axis, res, ct):
    gext, t_arr, out = res
    dt = jnp.zeros((), jnp.float32)  # schedule constant (see band_softmin_ext)
    axis = axis % gext.ndim
    hext = gext.shape[axis]
    t = jnp.asarray(t_arr, jnp.float32)
    # dL/dgext[p] = sum_{j=0..2B} w(p-j+B... ) — out index q = p - j with
    # weight exp((S[q] - (p-q-B... ) : out[q] consumed gext[q+k], k = p-q.
    # Pad out/ct by 2B on both sides so q = p - k is always in range.
    pad = [(0, 0)] * gext.ndim
    pad[axis] = (2 * band, 2 * band)
    outp = jnp.pad(out, pad, constant_values=jnp.float32(-3e38))
    ctp = jnp.pad(ct, pad, constant_values=jnp.float32(0.0))

    def step(acc, k):
        # out[q] with q = p - k  ->  slice of padded arrays starting at 2B - k
        dy = (k - band).astype(jnp.float32)
        start = jnp.int32(2 * band) - k
        s_tap = lax.dynamic_slice_in_dim(outp, start, hext, axis=axis)
        c_tap = lax.dynamic_slice_in_dim(ctp, start, hext, axis=axis)
        w = jnp.exp((s_tap - dy * dy - gext) / t)
        return acc + w * c_tap, None

    acc0 = gext * jnp.float32(0.0)
    acc, _ = lax.scan(step, acc0, jnp.arange(2 * band + 1, dtype=jnp.int32))
    return (acc, dt)


_band_softmin_ext_p.defvjp(_band_softmin_ext_fwd, _band_softmin_ext_bwd)


def soft_edt_sq(heights: jnp.ndarray, band: int, temperature) -> jnp.ndarray:
    """Two-pass separable soft squared-EDT of a height field (..., H, W):
    rows, then columns."""
    s1 = band_softmin(heights, band, temperature, axis=-1)
    return band_softmin(s1, band, temperature, axis=-2)


def soft_sdf_field_scan(
    gray: jnp.ndarray,
    spread: int,
    tau=1.0,
    temperature=0.5,
    eps: float = 1e-6,
    test_above: bool = True,
    band: int | None = None,
) -> jnp.ndarray:
    """The soft field by the streaming scan cores: exact banded soft-min
    for any input range and any (traced) tau/temperature. It serves
    unbounded inputs and is the reference the cascade is tested against."""
    band = band if band is not None else spread + 2
    big = big_sentinel(band)
    logits = threshold.soft_logits(gray, tau=tau, test_above=test_above)
    h_in = threshold.soft_log_indicator_from_logits(logits, temperature, True, big)
    h_out = threshold.soft_log_indicator_from_logits(logits, temperature, False, big)
    d2_in = soft_edt_sq(h_in, band, temperature)
    d2_out = soft_edt_sq(h_out, band, temperature)
    e = jnp.float32(eps)
    d_in = jnp.sqrt(jnp.maximum(d2_in, 0) + e)
    d_out = jnp.sqrt(jnp.maximum(d2_out, 0) + e)
    return d_out - jnp.maximum(d_in - jnp.float32(1.0), jnp.float32(0.0))


def _over_images(fn, gray):
    """Apply a 2-D field function over any leading batch axes."""
    for _ in range(gray.ndim - 2):
        fn = jax.vmap(fn)
    return fn(gray)


def soft_sdf_field(
    gray: jnp.ndarray,
    spread: int,
    tau: float = 1.0,
    temperature: float = 0.5,
    eps: float = 1e-6,
    test_above: bool = True,
    band: int | None = None,
    gray_range: tuple | None = None,
    precision: str = "highest",
) -> jnp.ndarray:
    """Signed soft distance field (float32) from raw gray values (..., H, W).

    Converges to the hard EXACT pipeline's pre-remap signed values as
    (tau, temperature) -> 0. Three routes, all the same banded soft-min
    within the cascade's tap truncation (ops/soft_mxu.py):

    - ``gray_range`` DECLARED (the CLI/atlas u8 path passes (0, 255)) and
      in gamut: the two-matmul cascade with a static shift. The caller
      guarantees the bound; mild overshoot (e.g. SGD pixel updates)
      degrades gracefully, but unbounded trained images must pass None.
    - no declared range, static parameters: a runtime range gate measures
      the input's height range and takes the cascade (with that shift as
      a traced scalar) when it fits, the scan cores otherwise.
    - traced tau/temperature (annealing schedules): the scan cores. The
      schedule is a constant of the step: it gets a zero cotangent.

    ``precision`` names the cascade's matmul precision (soft_mxu.PRECISIONS).
    """
    from chaq_sdfgen.ops import soft_mxu

    band = band if band is not None else spread + 2
    static = isinstance(tau, (int, float)) and isinstance(temperature, (int, float))

    if not static:
        tau, temperature = lax.stop_gradient(tau), lax.stop_gradient(temperature)

    def scan(g):
        return soft_sdf_field_scan(g, spread, tau, temperature, eps, test_above, band)

    if soft_mxu.mxu_ok(gray, band, tau, temperature, gray_range):
        log.debug("soft_sdf_field: cascade, declared range (%s)", gray.shape)
        return _over_images(
            lambda g: soft_mxu.soft_sdf_field_mxu(
                g, band, tau, temperature, eps, test_above, gray_range, precision
            ),
            gray,
        )
    gate = soft_mxu.runtime_gate(band, tau, temperature) if static else None
    if gray_range is not None or gate is None:
        log.debug("soft_sdf_field: scan cores (%s)", gray.shape)
        return scan(gray)

    limit, k1, k2 = gate
    t_f = float(temperature)
    labs = jnp.max(jnp.abs(gray.astype(jnp.float32) - 127.5)) / jnp.float32(tau)
    h_max = jnp.float32(t_f) * jax.nn.softplus(labs)
    shift = jax.lax.stop_gradient(jnp.maximum(h_max - jnp.float32(60.0 * t_f), 0.0))

    def cascade(g):
        return _over_images(
            lambda x: soft_mxu.cascade_field(
                x, float(tau), t_f, float(eps), test_above, k1, k2, shift, precision
            ),
            g,
        )

    # The scan branch is rematerialised: lax.cond's AD keeps the union of
    # both branches' residuals, so without the checkpoint every in-gamut
    # step would also carry (and zero-fill) the scan cores' residuals.
    log.debug("soft_sdf_field: runtime-range gate (%s)", gray.shape)
    return jax.lax.cond(
        h_max <= jnp.float32(limit), cascade, jax.checkpoint(scan), gray
    )


def soft_sdf_bytes(
    gray: jnp.ndarray,
    spread: int,
    asymmetric: bool = False,
    clamp: str = "tanh",
    **kw,
) -> jnp.ndarray:
    """Differentiable remapped output in [0, 255] float32 (the soft analogue
    of the reference's byte image)."""
    from chaq_sdfgen.ops.merge import soft_remap

    s = soft_sdf_field(gray, spread, **kw)
    return soft_remap(s, spread, asymmetric, clamp=clamp)
