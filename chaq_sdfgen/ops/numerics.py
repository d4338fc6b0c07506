"""Numerics helpers for bit-exact parity.

XLA lowers sqrt to a rsqrt-based approximation on some backends (observed:
sqrt(3600) -> 59.999996 on CPU), while the reference uses C's correctly
rounded sqrtf (openmp/df.c:95). ``refined_sqrt`` recovers the correctly
rounded float32 square root for our radicands (exact integers < 2^24) with
one Newton step evaluated in double-float32 — elementwise ops only, no
float64, no lookup tables.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

# keeps the sign, the exponent and the top 11 stored mantissa bits
_HI_MASK = -(1 << 12)


def refined_sqrt(n: jnp.ndarray) -> jnp.ndarray:
    """Correctly rounded float32 sqrt of exactly-representable non-negative
    float32 values (integers < 2^24 in our use).

    s0 = approx sqrt; the residual e = n - s0^2 is computed exactly by
    splitting s0 into high/low 12-bit halves; the final IEEE-correct
    addition s0 + e/(2*s0) rounds the double-float32 result to the nearest
    float32, which is RN(sqrt(n)) for every integer 0 <= n < 2^24 - 1.
    The one exception, n = 2^24 - 1, lies 2^-40 (relative) from a rounding
    tie and rounds up; it is 3 mod 4, so it is not a sum of two squares
    and never a squared distance.

    The split masks the low mantissa bits off s0 (hi) instead of the
    arithmetic Veltkamp split (s0 * 4097 ...): a compiler that contracts
    a multiply and an add into one fused multiply-add (GPU backends do)
    would leave the arithmetic split unrounded and the halves too wide.
    With 12-bit halves every product below is exact, so contraction
    cannot change the result.
    """
    n = n.astype(jnp.float32)
    s0 = jnp.sqrt(n)
    hi = lax.bitcast_convert_type(
        lax.bitcast_convert_type(s0, jnp.int32) & _HI_MASK, jnp.float32
    )
    lo = s0 - hi
    # exact expansion of n - s0*s0
    e = ((n - hi * hi) - (jnp.float32(2.0) * hi) * lo) - lo * lo
    # guard against s0 == 0 (n == 0): correction is 0/0 -> force 0
    denom = jnp.float32(2.0) * s0
    corr = jnp.where(n > 0, e / jnp.where(denom > 0, denom, jnp.float32(1.0)), jnp.float32(0.0))
    return jnp.where(n > 0, s0 + corr, jnp.float32(0.0))
