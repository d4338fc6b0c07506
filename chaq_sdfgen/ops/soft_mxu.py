"""The soft EDT of a bounded-range input as two cascaded matmuls.

For inputs with a bounded value range (a DECLARED range such as the
CLI/atlas u8 path, or one the runtime gate in ops/softsdf.py measured),
heights are bounded: h <= h_max = T*softplus(max|logit|), so every
pass-1 tap that can contribute more than exp(-_CUT) relative lies within
K = ceil(sqrt(_CUT*T + h_max)) columns, and the exp-sum needs no per-pixel
max shift: with a single GLOBAL shift c = max(0, h_max-60T),

    S1(q) = c - T log sum_k w(k) * exp((c - h(q+k))/T),  w(k)=exp(-k^2/T)

every product stays inside f32 normal range (max term <= e^{c/T}, flushed
taps < exp(-_CUT) relative). That sum is a short convolution; phrased as
overlapping windows contracted with a constant (blk+2K, blk) band matrix
it is one batched matmul.

Pass 2 admits the SAME global shift: the k=0 tap gives S1(q) <= h(q) <=
h_max (a soft-min sits below every term), and the undershoot is bounded by
the Gaussian tap sum (S1 >= -T log(2K+1) > -6T), so S1 is range-bounded
whenever the input is. Pass 1's log and pass 2's exp then cancel, and the
bounded soft EDT is two cascaded band-matrix convolutions of the shifted
occupancy with ONE log at the end. Forward and backward are plain XLA: the
VJP of a convolution against a symmetric constant is the same convolution.

No reference analogue (the soft path has none); ops/softsdf.py holds the
scan cores that serve unbounded inputs and serve as the reference here.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp

from chaq_sdfgen.ops import threshold

_BLK = 128
_CUT = 30.0  # tap-truncation exponent
# beyond this h_max/T the global shift cannot keep the max term
# representable in f32 (e^{c/T} <= e^85)
_HMAX_OVER_T_LIMIT = 140.0
# pass-2 value-bound margin: S1 >= -T log(2K+1) >= -T log 257 > -6T for
# any K <= _BLK (see _range_stats); 6T keeps every pass-2 exponent
# (c2 - S1)/T <= h_max/T - 54 <= 86 inside f32 range
_P2_MARGIN_T = 6.0
_PAD_H = 1e30  # value of dead (fully padded) windows, softsdf._PAD_HEIGHT

PRECISIONS = {
    "highest": jax.lax.Precision.HIGHEST,
    "high": jax.lax.Precision.HIGH,
    "default": jax.lax.Precision.DEFAULT,
}


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _h_max(gray_range, tau, temperature) -> float:
    lo, hi = float(gray_range[0]), float(gray_range[1])
    labs = max(abs(lo - 127.5), abs(hi - 127.5)) / float(tau)
    # stable softplus(labs)
    return float(temperature) * (max(labs, 0.0) + math.log1p(math.exp(-abs(labs))))


def _tap_radius(band, temperature, h_max, margin=0.0):
    """Static tap radius K for heights <= h_max, or None when the window
    construction (K <= _BLK) cannot hold it."""
    k = min(int(math.ceil(math.sqrt(_CUT * temperature + h_max + margin))), int(band))
    return max(k, 1) if k <= _BLK else None


def _range_stats(band, tau, temperature, gray_range, margin=0.0):
    """(K, shift c) for a declared input range; None when out of gamut.

    ``margin`` widens the value bound (in units of the raw height): pass 2
    consumes S1, which can dip below 0 by up to T*log(#taps) (the soft-min
    of nonnegative heights against a Gaussian tap sum), so its tap cutoff
    needs the extra slack."""
    t = float(temperature)
    h_max = _h_max(gray_range, tau, temperature)
    if h_max / t > _HMAX_OVER_T_LIMIT:
        return None
    k = _tap_radius(band, t, h_max, margin)
    if k is None:
        return None
    return k, max(0.0, h_max - 60.0 * t)


def mxu_ok(gray, band, tau, temperature, gray_range) -> bool:
    """Gate for the cascade with a declared range: static params and a
    range within the pass-2 gamut (the stricter of the two passes'
    bounds). Any rank; batched inputs are vmapped by the caller."""
    if gray_range is None or gray.ndim < 2 or gray.shape[-2] < 1:
        return False
    if not (isinstance(tau, (int, float)) and isinstance(temperature, (int, float))):
        return False
    t = float(temperature)
    return (
        _range_stats(band, tau, temperature, gray_range, margin=_P2_MARGIN_T * t)
        is not None
    )


def runtime_gate(band, tau, temperature):
    """Static part of the runtime range gate for inputs WITHOUT a declared
    range: (limit, k1, k2), where the cascade with tap radii (k1, k2) is
    exact to the truncation bound for every input whose measured h_max is
    <= limit; None when no such cascade exists. The tap radius is capped
    at 16, which covers u8 inputs at the default temperatures."""
    t = float(temperature)
    kk = min(16, int(band))
    # k2^2 >= _CUT*T + h_max + 6T and the global-shift bound h_max <= 140 T
    limit = min(_HMAX_OVER_T_LIMIT * t, kk * kk - (_CUT + _P2_MARGIN_T) * t)
    if limit <= 0:
        return None
    return limit, _tap_radius(band, t, limit), _tap_radius(band, t, limit, _P2_MARGIN_T * t)


def _conv_blk(k):
    """Window block width for tap radius k. The contraction depth is
    blk+2k: a 64-wide block keeps it near 96 for k <= 16; wider taps use
    128-wide blocks so that the window overhead stays below 2x."""
    return 64 if k <= 16 else _BLK


def _band_matrix(k, temperature, blk=None):
    """(blk+2K, blk) constant: W[j, q] = exp(-(j-q-K)^2 / T), 0 beyond K."""
    if blk is None:
        blk = _conv_blk(k)
    j = jnp.arange(blk + 2 * k, dtype=jnp.float32)[:, None]
    q = jnp.arange(blk, dtype=jnp.float32)[None, :]
    d = j - q - jnp.float32(k)
    w = jnp.exp(-(d * d) / jnp.float32(temperature))
    return jnp.where(jnp.abs(d) <= k, w, jnp.float32(0.0))


def _conv_rows(e, wmat, k, precision=jax.lax.Precision.HIGHEST):
    """W (*) e along axis 1 (the x stencil): windows built by block
    reshape + neighbour pad-of-slice, contracted as one batched matmul.
    The neighbour blocks are pads of slices, which fuse into the matmul
    operand. Block width comes from wmat (see _conv_blk)."""
    hgt, wid = e.shape
    blk = wmat.shape[1]
    nb = wid // blk
    eb = e.reshape(hgt, nb, blk)
    # block b-1's last k columns, zeros at b=0 (border: exp(-PAD) = 0)
    left = jnp.pad(eb[:, :-1, blk - k :], ((0, 0), (1, 0), (0, 0)))
    # block b+1's first k columns, zeros at b=nb-1
    right = jnp.pad(eb[:, 1:, :k], ((0, 0), (0, 1), (0, 0)))
    win = jnp.concatenate([left, eb, right], axis=2)  # (hgt, nb, blk+2K)
    s = jnp.einsum("hbj,jq->hbq", win, wmat, precision=precision)
    return s.reshape(hgt, wid)


def _conv_cols(e, wmat, k, precision=jax.lax.Precision.HIGHEST):
    """W (*) e along axis 0 (the y stencil) — the pass-2 twin, windows on
    the row-block axis ('bjw,jq->bqw'). Callers' padded heights are
    128-aligned, which both block widths divide."""
    hgt, wid = e.shape
    blk = wmat.shape[1]
    nb = hgt // blk
    eb = e.reshape(nb, blk, wid)
    up = jnp.pad(eb[:-1, blk - k :, :], ((1, 0), (0, 0), (0, 0)))
    dn = jnp.pad(eb[1:, :k, :], ((0, 1), (0, 0), (0, 0)))
    win = jnp.concatenate([up, eb, dn], axis=1)  # (nb, blk+2K, wid)
    s = jnp.einsum("bjw,jq->bqw", win, wmat, precision=precision)
    return s.reshape(hgt, wid)


@functools.partial(jax.custom_vjp, nondiff_argnums=(1, 2, 3))
def conv_rows_sym(e, k, temperature, precision="highest"):
    """Banded Gaussian conv along axis 1 with a self-adjoint VJP.

    w(d) = exp(-d^2/T) is symmetric and the boundary is zero fill, so the
    adjoint of the conv IS the conv: the backward runs the same window
    matmul on the cotangent instead of XLA's mechanical transpose of the
    window build (a deep contraction plus a window-overlap scatter-add).
    No residuals are saved: the conv is linear. wmat is rebuilt from
    (k, T) inside each pass and constant-folds under jit."""
    return _conv_rows(e, _band_matrix(k, temperature), k, PRECISIONS[precision])


def _conv_rows_sym_fwd(e, k, temperature, precision):
    return conv_rows_sym(e, k, temperature, precision), None


def _conv_rows_sym_bwd(k, temperature, precision, _res, ct):
    return (_conv_rows(ct, _band_matrix(k, temperature), k, PRECISIONS[precision]),)


conv_rows_sym.defvjp(_conv_rows_sym_fwd, _conv_rows_sym_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(1, 2, 3))
def conv_cols_sym(e, k, temperature, precision="highest"):
    """Axis-0 twin of conv_rows_sym (see there)."""
    return _conv_cols(e, _band_matrix(k, temperature), k, PRECISIONS[precision])


def _conv_cols_sym_fwd(e, k, temperature, precision):
    return conv_cols_sym(e, k, temperature, precision), None


def _conv_cols_sym_bwd(k, temperature, precision, _res, ct):
    return (_conv_cols(ct, _band_matrix(k, temperature), k, PRECISIONS[precision]),)


conv_cols_sym.defvjp(_conv_cols_sym_fwd, _conv_cols_sym_bwd)


def _safe_neglog(s, temperature, shift, dead_value):
    """shift - T log(s), with fully-dead windows (s sums to exactly 0 —
    padded rows/columns beyond the image) routed to ``dead_value``.
    A subnormal floor (1e-38) would flush back to 0 and log(0) = -inf
    puts +inf into the output; downstream VJPs then turn that into
    inf*0 NaN that contaminates live pixels. Double-where with a
    NORMAL-range floor: the log never sees a non-positive argument on
    either pass of AD. Live windows are safe: the center tap alone
    contributes >= e^-60 ~ 9e-27 >> 1e-30 by the global-shift bound."""
    flo = jnp.float32(1e-30)
    live = s > flo
    s_safe = jnp.where(live, s, jnp.float32(1.0))
    out = jnp.asarray(shift, jnp.float32) - jnp.float32(temperature) * jnp.log(s_safe)
    return jnp.where(live, out, jnp.float32(dead_value))


def shifted_occupancy(gray_p, h, w, tau, temperature, test_above, shift):
    """(e_in, e_out) = exp(shift/T + log sigmoid(+-l)) on the live h x w
    corner of the padded image, 0 elsewhere. With h_in = -T log sigmoid(l)
    exactly, e_in = exp((shift - h_in)/T): no separate heights pass."""
    hp, wl = gray_p.shape
    logits = threshold.soft_logits(gray_p, tau=tau, test_above=test_above)
    ls_in = jax.nn.log_sigmoid(logits)
    ls_out = ls_in - logits  # log sigmoid(-l) = log sigmoid(l) - l, exact
    ct1 = jnp.asarray(shift, jnp.float32) / jnp.float32(temperature)
    live = jnp.logical_and(jnp.arange(wl)[None, :] < w, jnp.arange(hp)[:, None] < h)
    e_in = jnp.where(live, jnp.exp(ct1 + ls_in), jnp.float32(0.0))
    e_out = jnp.where(live, jnp.exp(ct1 + ls_out), jnp.float32(0.0))
    return e_in, e_out


def soft_tail(s_in, s_out, temperature, shift, eps):
    """Pass-2 sums of both fields -> signed soft field: one log per field,
    the smoothed sqrt and the soft merge (ops/merge.soft_signed_merge)."""
    d2_in = _safe_neglog(s_in, temperature, shift, _PAD_H)
    d2_out = _safe_neglog(s_out, temperature, shift, _PAD_H)
    e = jnp.float32(eps)
    d_in = jnp.sqrt(jnp.maximum(d2_in, 0) + e)
    d_out = jnp.sqrt(jnp.maximum(d2_out, 0) + e)
    return d_out - jnp.maximum(d_in - jnp.float32(1.0), jnp.float32(0.0))


def cascade_field(gray, tau, temperature, eps, test_above, k1, k2, shift,
                  precision="highest"):
    """The collapsed two-conv soft field of a 2-D image with static tap
    radii (k1, k2) and a global shift (a Python float or a traced scalar).
    Dead input rows/cols are zero; pass-2 windows over them contribute
    nothing, and dead columns never reach live ones (pass 2 is
    columnwise), so no intermediate masking is needed."""
    t_f = float(temperature)
    h, w = gray.shape
    hp = _round_up(max(h, _BLK), _BLK)
    wl = _round_up(max(w, _BLK), _BLK)
    gray_p = jnp.pad(gray.astype(jnp.float32), ((0, hp - h), (0, wl - w)))
    e_in, e_out = shifted_occupancy(gray_p, h, w, tau, t_f, test_above, shift)
    s_in = conv_cols_sym(conv_rows_sym(e_in, k1, t_f, precision), k2, t_f, precision)
    s_out = conv_cols_sym(conv_rows_sym(e_out, k1, t_f, precision), k2, t_f, precision)
    return soft_tail(s_in, s_out, t_f, shift, eps)[:h, :w]


def soft_sdf_field_mxu(
    gray,
    band,
    tau,
    temperature,
    eps,
    test_above=True,
    gray_range=(0.0, 255.0),
    precision="highest",
):
    """Soft SDF field of a 2-D image as the two-matmul cascade. Same math
    as ops.softsdf.soft_sdf_field_scan within the tap truncation; requires
    static tau/temperature and a declared input range (callers must
    guarantee gray stays inside it — mild overshoot degrades gracefully).
    ``precision`` names the matmul precision (PRECISIONS)."""
    t_f = float(temperature)
    stats = _range_stats(band, tau, temperature, gray_range)
    stats2 = _range_stats(band, tau, temperature, gray_range, margin=_P2_MARGIN_T * t_f)
    if stats is None or stats2 is None:
        raise ValueError(
            f"input range {gray_range} out of the cascade's gamut for "
            f"tau={tau}, T={temperature}; use the scan cores"
        )
    (k1, shift), (k2, _) = stats, stats2
    return cascade_field(
        gray, float(tau), t_f, float(eps), test_above, k1, k2, shift, precision
    )
