"""OpenCL-kernel-parity SDF ("brute" mode) — a data-parallel O(n^2 s)
reformulation of the reference's O(n^2 s^2) per-pixel search.

The reference kernel (opencl/sdf.cl:79-191, search_triangle) probes, per
pixel, rings u = 1..spread: the four axis offsets (±u,0),(0,±u), then the
off-diagonal pairs (±u,±v),(±v,±u) for 1 <= v < u with u²+v² <= spread².
Its candidate set is therefore every in-image offset with dx²+dy² <= spread²
EXCEPT exact diagonals |dx| == |dy| — a quirk this module reproduces for
byte parity. The early exits there only affect which equal-distance
candidate wins, never the distance, so a candidate-set minimum is
value-equivalent.

Instead of per-pixel window scans, the search is factored per row. For each row and each pixel we precompute the distances to the
nearest and second-nearest seed on each side (1st is enough except when it
sits exactly |dx| == |dy| and must be skipped). Pass 2 then scans
dy = -s..s once, giving O(n^2 s) vectorized work instead of O(n^2 s^2)
scalar probes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from chaq_sdfgen.ops.merge import opencl_sign_and_remap
from chaq_sdfgen.ops.numerics import refined_sqrt


def row_seed_distances(seeds: jnp.ndarray, sentinel: int):
    """Per-pixel distances (int32) to the nearest (L1/R1) and second-nearest
    (L2/R2) seed at-or-left / at-or-right in the row (last axis). Distances
    are clipped at ``sentinel``; missing seeds read as ``sentinel``.

    Gather-free: the inter-seed gap is packed into the cummax carry's low bits
    (pack = pos * G + min(gap, sent), G a power of two > sent), so the
    same segment-carry that finds the nearest seed also delivers that
    seed's distance to ITS previous seed; L2 = L1 + carried gap."""
    ndim = seeds.ndim
    axis = ndim - 1
    w = seeds.shape[-1]
    idx = lax.broadcasted_iota(jnp.int32, seeds.shape, axis)
    none = jnp.int32(-(1 << 30))
    sent = jnp.int32(sentinel)
    gbits = max(int(sentinel).bit_length(), 1)
    g = jnp.int32(1 << gbits)
    gmask = jnp.int32((1 << gbits) - 1)
    pad = [(0, 0)] * ndim
    pad[axis] = (1, 0)

    fwd = lax.cummax(jnp.where(seeds, idx, none), axis=axis)
    l1 = jnp.minimum(idx - fwd, sent)
    # gap at a seed p: p - (nearest seed at or before p-1)
    fwd_prev = lax.slice_in_dim(
        jnp.pad(fwd, pad, constant_values=none), 0, w, axis=axis
    )
    gap_l = jnp.minimum(idx - fwd_prev, sent)
    pack_l = jnp.where(seeds, idx * g + gap_l, none)
    carried_l = lax.cummax(pack_l, axis=axis)
    l2 = jnp.minimum(l1 + jnp.bitwise_and(carried_l, gmask), sent)
    l2 = jnp.where(carried_l == none, sent, l2)

    # mirrored: nearest seed at or after i carries its gap to the NEXT seed
    bwd = lax.cummax(jnp.where(seeds, -idx, none), axis=axis, reverse=True)
    r1 = jnp.minimum(-(idx + bwd), sent)
    pad_r = [(0, 0)] * ndim
    pad_r[axis] = (0, 1)
    bwd_next = lax.slice_in_dim(
        jnp.pad(bwd, pad_r, constant_values=none), 1, w + 1, axis=axis
    )
    gap_r = jnp.minimum(-idx - bwd_next, sent)  # (next pos) - idx at seeds
    pack_r = jnp.where(seeds, (-idx) * g + gap_r, none)
    carried_r = lax.cummax(pack_r, axis=axis, reverse=True)
    r2 = jnp.minimum(r1 + jnp.bitwise_and(carried_r, gmask), sent)
    r2 = jnp.where(carried_r == none, sent, r2)
    return l1, l2, r1, r2


def triangle_nearest_d2(b: jnp.ndarray, spread: int) -> jnp.ndarray:
    """Per-pixel min squared distance to an opposite-valued pixel over the
    triangle candidate set (|dx| != |dy| quirk included); values > spread²
    mean 'not found' (the reference's ±INFINITY fallback, sdf.cl:213-214).
    b: (..., H, W) bool."""
    sentinel = spread + 1
    h = b.shape[-2]
    axis_y = b.ndim - 2
    big = jnp.int32(2 * sentinel * sentinel + 1)

    # seed-set distances for both polarities; each output pixel selects the
    # opposite set (sdf.cl:201: candidates differ in value from this_val).
    rows_true = row_seed_distances(b, sentinel)
    rows_false = row_seed_distances(jnp.logical_not(b), sentinel)
    # choose per-pixel row data of the OPPOSITE polarity... but the rows we
    # tap belong to y+dy, while the polarity is that of the *center* pixel.
    # So keep both stacks and select after the dy scan.

    def scan_field(rows):
        l1, l2, r1, r2 = rows
        pad = [(0, 0)] * (b.ndim - 2) + [(spread, spread), (0, 0)]
        sent = jnp.int32(sentinel)
        l1p = jnp.pad(l1, pad, constant_values=sent)
        l2p = jnp.pad(l2, pad, constant_values=sent)
        r1p = jnp.pad(r1, pad, constant_values=sent)
        r2p = jnp.pad(r2, pad, constant_values=sent)

        def step(acc, k):
            dy = k - jnp.int32(spread)
            a = jnp.abs(dy)
            sl = lambda arr: lax.dynamic_slice_in_dim(arr, k, h, axis=axis_y)
            tl1, tl2, tr1, tr2 = sl(l1p), sl(l2p), sl(r1p), sl(r2p)
            # skip candidates on the exact diagonal |dx| == |dy| (quirk)
            cl = jnp.where(tl1 == a, tl2, tl1)
            cr = jnp.where(tr1 == a, tr2, tr1)
            dx = jnp.minimum(cl, cr)
            d2 = dx * dx + dy * dy
            return jnp.minimum(acc, d2), None

        acc0 = jnp.full(b.shape, big, dtype=jnp.int32)
        acc, _ = lax.scan(step, acc0, jnp.arange(2 * spread + 1, dtype=jnp.int32))
        return acc

    d2_to_true = scan_field(rows_true)
    d2_to_false = scan_field(rows_false)
    return jnp.where(b, d2_to_false, d2_to_true)


@functools.partial(jax.jit, static_argnames=("spread", "asymmetric", "invert"))
def brute_sdf_bytes(
    b: jnp.ndarray,
    spread: int,
    asymmetric: bool = False,
    invert: bool = False,
) -> jnp.ndarray:
    """Thresholded bool grid -> uint8 SDF with the OpenCL kernel's exact
    byte semantics (opencl/sdf.cl:193-224): truncated search, ±INF fallback,
    decider = invert ^ value, -1 inside bias, clamped remap."""
    d2 = triangle_nearest_d2(b, spread)
    found = d2 <= jnp.int32(spread * spread)
    d = refined_sqrt(d2.astype(jnp.float32))
    return opencl_sign_and_remap(
        d, found, b, spread, asymmetric, invert, big=float(2 * spread + 4)
    )
