"""Jump-flood (JFA) nearest-seed propagation — the scale-out algorithm.

No reference analogue (SURVEY.md §7 item 5): the
reference's exact EDT is O(n^2) sequential-per-row and the OpenCL search is
O(n^2 s^2); JFA gives O(n^2 log n) fully-parallel work with unclamped
full-range distances, and its per-pass 9-tap stencil shards cleanly across
a device mesh (halo = stride rows, see parallel/).

State per pixel: nearest-seed coordinates (sy, sx) + validity. Each pass
with stride k pulls candidates from the 8 neighbours at offset ±k and keeps
the closest. Strides halve from the next power of two down to 1; the
optional extra stride-1 prepass ("1+JFA", Rong & Tan 2007) removes most of
plain JFA's rare misses. JFA can still overestimate on adversarial
patterns; hard-parity paths use ops/edt.py instead.

All arithmetic is int32 (exact); distances convert to float only at the end
via the correctly-rounded refined_sqrt.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from chaq_sdfgen.ops.numerics import refined_sqrt

_INVALID_D2 = 1 << 30  # a Python int: no device array is made at import


def _shift2d(arr: jnp.ndarray, dy: int, dx: int, fill):
    """Shift a (..., H, W) array so out[y, x] = arr[y+dy, x+dx], filling
    out-of-range with ``fill``. Static offsets -> pad+slice, which fuses."""
    nd = arr.ndim
    pad = [(0, 0)] * nd
    pad[nd - 2] = (max(-dy, 0), max(dy, 0))
    pad[nd - 1] = (max(-dx, 0), max(dx, 0))
    p = jnp.pad(arr, pad, constant_values=fill)
    sl = [slice(None)] * nd
    sl[nd - 2] = slice(max(dy, 0), max(dy, 0) + arr.shape[nd - 2])
    sl[nd - 1] = slice(max(dx, 0), max(dx, 0) + arr.shape[nd - 1])
    return p[tuple(sl)]


def _strides(h: int, w: int, plus_one: bool):
    n = max(h, w)
    k = 1
    while k < n:
        k <<= 1
    k >>= 1
    out = [1] if (plus_one and n > 1) else []
    while k >= 1:
        out.append(k)
        k >>= 1
    return out or [1]


def jfa_seed_coords(seeds: jnp.ndarray, plus_one: bool = True):
    """seeds: (..., H, W) bool. Returns (sy, sx, d2, valid): per-pixel
    nearest-seed coordinates (int32), squared distance (int32, _INVALID_D2
    where no seed was found), and validity mask.

    The state is ONE packed int32 per pixel — (sy << xbits) | sx, -1 when
    no seed — plus the running d2: candidate validity and coordinates
    unpack with a shift/mask, so each pass reads 8 shifted views of one
    array instead of three (the passes are bound by device-memory traffic)."""
    shape = seeds.shape
    nd = seeds.ndim
    h, w = shape[-2], shape[-1]
    yy = lax.broadcasted_iota(jnp.int32, shape, nd - 2)
    xx = lax.broadcasted_iota(jnp.int32, shape, nd - 1)
    xbits = max((w - 1).bit_length(), 1)
    mask = jnp.int32((1 << xbits) - 1)
    none = jnp.int32(-1)

    p = jnp.where(seeds, (yy << xbits) | xx, none)
    d2 = jnp.where(seeds, jnp.int32(0), _INVALID_D2)

    for k in _strides(h, w, plus_one):
        # synchronous (textbook) JFA: all 8 neighbour candidates read the
        # state as of the START of this stride — the same schedule the
        # sharded version gets from its once-per-stride halo exchange, so
        # single-chip and sharded results are bitwise identical
        sp = p
        # recompute the running best distance from the packed state
        # instead of carrying it across passes: d2 == dist(p) is an exact
        # invariant (the two always update together), and dropping the
        # carry saves a 2x(H*W*4)-byte round trip through device memory per
        # stride, for ~5 elementwise ops to rebuild
        sy0 = sp >> xbits
        sx0 = sp & mask
        d2 = jnp.where(
            sp >= 0, (yy - sy0) ** 2 + (xx - sx0) ** 2, _INVALID_D2
        )
        for dy in (-k, 0, k):
            for dx in (-k, 0, k):
                if dy == 0 and dx == 0:
                    continue
                cp = _shift2d(sp, dy, dx, none)
                csy = cp >> xbits  # arithmetic: -1 stays -1 (guarded below)
                csx = cp & mask
                cd2 = (yy - csy) ** 2 + (xx - csx) ** 2
                cd2 = jnp.where(cp >= 0, cd2, _INVALID_D2)
                take = cd2 < d2
                p = jnp.where(take, cp, p)
                d2 = jnp.minimum(d2, cd2)
    valid = p >= 0
    sy = jnp.where(valid, p >> xbits, jnp.int32(0))
    sx = jnp.where(valid, p & mask, jnp.int32(0))
    return sy, sx, d2, valid


@functools.partial(jax.jit, static_argnames=("plus_one",))
def jfa_distance(seeds: jnp.ndarray, plus_one: bool = True) -> jnp.ndarray:
    """Full-range distance-to-nearest-seed field (float32). Pixels with no
    reachable seed read sqrt(2^30) = 32768.0 — far above any byte clamp,
    matching the reference's INFINITY behaviour after the remap."""
    _, _, d2, _ = jfa_seed_coords(seeds, plus_one=plus_one)
    return refined_sqrt(d2.astype(jnp.float32))
