"""Banded separable exact EDT — a data-parallel reformulation of the
reference's Felzenszwalb–Huttenlocher transform (openmp/df.c:29-136).

The FH lower-envelope scan is sequential with data-dependent stack pops
(df.c:57-79). But the reference's *output* is clamped to [-spread, +spread]
by the byte remap (openmp/sdfgen.c:75-96), so only distances <= spread+1
are observable. That admits a fully data-parallel exact formulation:

  pass 1 (rows, binary seeds): d1(x) = distance to nearest seed in the row
      — two cumulative-max scans (forward/backward), O(n) work, exact.
  pass 2 (columns, banded):    D(y,x) = min_{|dy|<=B} dy^2 + d1^2(y+dy, x)
      — a (2B+1)-tap min-plus stencil.

For any pixel whose true distance d <= B the result is exactly d^2 (the
winning seed's |dy| <= d <= B); for anything farther the result provably
saturates above B^2, which the remap clamps to the same byte as the
reference's unbounded value. With B = spread + 2 (SdfConfig.effective_band)
the output bytes are identical to the OpenMP binary's.

All values are small exact integers in float32 (<= (B+1)^2 + B^2 << 2^24),
so min/add order cannot change results. This module is the XLA core, run
on the CPU and wherever ``ops/dispatch.py`` keeps no kernel; the GPU
kernel for pass 2 is ``ops/edt_triton.py``.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

# pass-2 taps evaluated per loop step of the XLA core: one fused
# min-chain reads the accumulator once for this many taps each way
TAPS_PER_STEP = 8

# full-range distance reported where the image has no seed at all
NO_SEED = 32768.0


def big_sentinel(band: int) -> float:
    """Finite stand-in for +inf: guaranteed to stay above band^2 through
    pass 2 and to clamp identically to the reference's INFINITY
    (openmp/sdfgen.c:70) after the byte remap."""
    return float((band + 1) ** 2)


def row_nearest(seeds: jnp.ndarray, sat: int) -> jnp.ndarray:
    """Pass 1: per-row distance (int32) to the nearest seed along the last
    axis, clipped at ``sat`` (rows with no seed read ``sat``).

    Equivalent to the FH row pass (df.c:130, do_sqrt=false) on a {0, inf}
    indicator: for binary heights the lower envelope's value at q is simply
    (q - nearest_seed)^2. Two cummax scans replace the sequential envelope.
    """
    idx = lax.broadcasted_iota(jnp.int32, seeds.shape, seeds.ndim - 1)
    none = jnp.int32(-(1 << 30))
    # forward: index of the nearest seed at or before q
    fwd = lax.cummax(jnp.where(seeds, idx, none), axis=seeds.ndim - 1)
    # backward: minus the index of the nearest seed at or after q
    bwd = lax.cummax(jnp.where(seeds, -idx, none), axis=seeds.ndim - 1, reverse=True)
    d = jnp.minimum(idx - fwd, -(idx + bwd))
    return jnp.minimum(d, jnp.int32(sat))


def row_nearest_sq(seeds: jnp.ndarray, band: int) -> jnp.ndarray:
    """Pass 1 squared, as float32 (..., H, W), saturating at
    big_sentinel(band): rows with no seed within the band cannot win a
    within-band minimum."""
    d = row_nearest(seeds, band + 1)  # clip before squaring: exact in f32
    return (d * d).astype(jnp.float32)


def band_min_columns(g: jnp.ndarray, band: int) -> jnp.ndarray:
    """Pass 2: D(y, x) = min_{|dy| <= band} dy^2 + g(y+dy, x) along the
    second-to-last axis. g: (..., H, W). Out-of-image taps read the big
    sentinel (non-periodic boundary)."""
    big = big_sentinel(band)
    pad = [(0, 0)] * (g.ndim - 2) + [(band, band), (0, 0)]
    gp = jnp.pad(g, pad, constant_values=jnp.asarray(big, g.dtype))
    return band_min_ext(gp, band)


def band_min_ext(gext: jnp.ndarray, band: int) -> jnp.ndarray:
    """band_min_columns on a pre-extended input: gext carries ``band`` extra
    rows on each side (boundary sentinel rows, or a halo exchanged from
    neighbouring shards — parallel/halo.py). (..., H+2B, W) -> (..., H, W).

    The banded lower-envelope evaluation (df.c:82-96) as a min-plus
    stencil: a while loop whose every step is one fused chain of
    2 * TAPS_PER_STEP shifted adds and mins, so the accumulator makes one
    round trip through memory per TAPS_PER_STEP taps and the program size
    does not grow with the band. The loop stops once dy^2 reaches the
    largest value left in the accumulator: no farther row can lower any
    pixel, so the result is the same as running every tap.
    """
    h = gext.shape[-2] - 2 * band
    axis = gext.ndim - 2
    n_steps = -(-band // TAPS_PER_STEP)

    def rows(start):
        return lax.dynamic_slice_in_dim(gext, start, h, axis=axis)

    def cond(carry):
        step, _, top = carry
        k = step * TAPS_PER_STEP + 1
        return jnp.logical_and(step < n_steps, (k * k).astype(top.dtype) < top)

    def body(carry):
        step, acc, _ = carry
        for j in range(TAPS_PER_STEP):
            # taps past the band repeat tap ``band``: min is idempotent
            k = jnp.minimum(step * TAPS_PER_STEP + 1 + j, band)
            pair = jnp.minimum(rows(band - k), rows(band + k))
            acc = jnp.minimum(acc, pair + (k * k).astype(acc.dtype))
        return step + 1, acc, jnp.max(acc)

    # the carry starts from a slice (not jnp.full) so its sharding and
    # varying type match under shard_map
    acc0 = lax.slice_in_dim(gext, band, band + h, axis=axis)
    _, acc, _ = lax.while_loop(cond, body, (jnp.int32(0), acc0, jnp.max(acc0)))
    return acc


def edt_sq_banded(seeds: jnp.ndarray, band: int) -> jnp.ndarray:
    """Exact squared EDT of a binary seed set, valid (exact) wherever the
    true distance <= band; saturates > band^2 elsewhere. (..., H, W) bool ->
    float32."""
    return band_min_columns(row_nearest_sq(seeds, band), band)


def edt_banded(seeds: jnp.ndarray, band: int) -> jnp.ndarray:
    """sqrt of edt_sq_banded — matches the reference's pass-2 sqrtf
    (df.c:95, do_sqrt=true). XLA's sqrt is not correctly rounded on all
    backends; numerics.refined_sqrt recovers the IEEE result for our
    exact-integer radicands.

    Reference quirk reproduced: dist_transform_1d returns single-cell rows
    untouched (df.c:32-36), so for single-row images the second pass never
    applies sqrt — the 'distance' stays squared. Same for 1x1.
    """
    from chaq_sdfgen.ops.numerics import refined_sqrt

    sq = edt_sq_banded(seeds, band)
    if seeds.shape[-2] <= 1:
        return sq
    return refined_sqrt(sq)


def dual_edt_banded(b: jnp.ndarray, band: int):
    """The reference computes two fields concurrently (omp sections,
    openmp/sdfgen.c:277-289): distance to the inside set (seeds = b) and to
    the outside set (seeds = ~b). XLA schedules both in one program.

    Returns (inside_dist, outside_dist) float32, already sqrt'ed.
    """
    d_in = edt_banded(b, band)
    d_out = edt_banded(jnp.logical_not(b), band)
    return d_in, d_out


def full_range_sat(n: int) -> int | None:
    """Row-distance saturation for the full-range exact field of an image
    whose longest side is n, or None when int32 squares would overflow.

    Requirements: (a) sat^2 > 2 (n-1)^2, so a row with no seed can never
    beat a real candidate; (b) sat^2 + (n-1)^2 < 2^31, so squares
    accumulate exactly in int32; (c) sat <= 65535, so row distances fit
    16 bits. One value per size class keeps compiled programs shared."""
    if n <= 4096:
        return 8191
    if n <= 8192:
        return 16383
    if n <= 16384:
        return 23170
    return None


def exact_distance(seeds: jnp.ndarray) -> jnp.ndarray:
    """(..., H, W) bool -> float32 EXACT distance to the nearest True pixel
    over the whole image (NO_SEED where there is none). Images up to 16384
    px per side; callers hand larger ones to JFA (``full_range_sat``)."""
    from chaq_sdfgen.ops.numerics import refined_sqrt

    h, w = seeds.shape[-2:]
    sat = full_range_sat(max(h, w))
    if sat is None:
        raise ValueError(f"image {h}x{w} exceeds the exact field's 16384 px limit")
    band = max(h - 1, 1)
    d = row_nearest(seeds, sat)
    g = d * d
    pad = [(0, 0)] * (g.ndim - 2) + [(band, band), (0, 0)]
    gp = jnp.pad(g, pad, constant_values=jnp.int32(sat * sat))
    d2 = band_min_ext(gp, band)
    dist = refined_sqrt(d2.astype(jnp.float32))
    return jnp.where(d2 >= sat * sat, jnp.float32(NO_SEED), dist)
