"""Halo exchange for banded column passes (inside shard_map).

The reference assumes shared memory (openmp/df.c reads any row freely);
across devices, pass 2 needs each shard's top/bottom ``band`` rows from its
mesh neighbours. Halos travel by lax.ppermute (NCCL on GPUs); when the band
exceeds one shard's height, further neighbours send theirs directly (the
general case for small shards / large spreads). Edge shards read the
boundary sentinel instead (non-periodic image)."""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def exchange_row_halo(g: jnp.ndarray, band: int, axis_name: str, fill: float) -> jnp.ndarray:
    """g: (..., H_local, W) inside shard_map, sharded over ``axis_name``.
    Returns (..., H_local + 2*band, W) with neighbour halos attached.

    Rows are SLICED BEFORE the collective so exactly ``band`` rows travel
    per direction (not whole blocks): the source shard at offset j
    contributes only the rows of its block that fall inside the halo
    window, shipped with a direct offset-j ppermute. ppermute delivers
    zeros to edge shards outside the permutation; an axis_index mask
    rewrites those to ``fill``."""
    n = lax.axis_size(axis_name)
    i = lax.axis_index(axis_name)
    yax = g.ndim - 2
    h_local = g.shape[yax]
    fillv = jnp.asarray(fill, g.dtype)
    hops = -(-band // h_local)  # ceil

    def take_rows(x, start, size):
        return lax.slice_in_dim(x, start, start + size, axis=yax)

    # halo above = rows [start - band, start): shard i-j contributes its
    # last min(band - (j-1)*H, H) rows; farthest shard first
    up_parts = []
    for j in range(hops, 0, -1):
        take = min(band - (j - 1) * h_local, h_local)
        sl = take_rows(g, h_local - take, take)
        if n > 1:
            recv = lax.ppermute(sl, axis_name, [(s, s + j) for s in range(n - j)])
            blk = jnp.where(i >= j, recv, fillv)
        else:
            blk = jnp.full_like(sl, fillv)
        up_parts.append(blk)

    # halo below = rows [end, end + band): shard i+j contributes its first
    # min(band - (j-1)*H, H) rows; nearest shard first
    down_parts = []
    for j in range(1, hops + 1):
        take = min(band - (j - 1) * h_local, h_local)
        sl = take_rows(g, 0, take)
        if n > 1:
            recv = lax.ppermute(sl, axis_name, [(s + j, s) for s in range(n - j)])
            blk = jnp.where(i < n - j, recv, fillv)
        else:
            blk = jnp.full_like(sl, fillv)
        down_parts.append(blk)
    return jnp.concatenate(up_parts + [g] + down_parts, axis=yax)


def fetch_col_slab(g: jnp.ndarray, offset: int, axis_name: str, fill) -> jnp.ndarray:
    """Column twin of fetch_row_slab for 2-D ('y','x') tile meshes: g is
    (..., H, W_local) sharded over ``axis_name`` along its LAST axis; out
    column x holds global column (x_global - offset). Implemented on the
    transpose (shard-local) so the slab logic exists once; the payload
    between devices is the same <= W_local columns."""
    gt = jnp.swapaxes(g, -1, -2)
    slab = fetch_row_slab(gt, offset, axis_name, fill)
    return jnp.swapaxes(slab, -1, -2)


def fetch_row_slab(g: jnp.ndarray, offset: int, axis_name: str, fill) -> jnp.ndarray:
    """Same-shape slab shifted ``offset`` rows in GLOBAL coordinates: out
    row y holds global row (y_global - offset), or ``fill`` beyond the
    image. offset may be any positive/negative stride (JFA's ±k taps).

    Ships at most H_local rows per call (split across the <= 2 source
    shards the slab straddles) with direct offset ppermutes — the
    information-theoretic minimum for a full-block shifted read, vs. the
    |offset| rows a contiguous halo would carry.

    Beyond-image rows are marked WITHOUT a coordinate mask: the data is
    shipped as (g - fill), so ppermute's zero-delivery to edge shards IS
    the fill marker and one add restores values — every delivered row is
    a real image row (H divides into shards exactly), so no other
    invalid source exists. Saves ~3 elementwise passes per slab vs an
    explicit global-row validity mask (the JFA inner loop calls this
    twice per stride). Intended for integer/packed states: ``fill`` must
    round-trip ``g - fill + fill`` exactly (large float sentinels like
    1e30 would destroy the data — use exchange_row_halo for those)."""
    n = lax.axis_size(axis_name)
    yax = g.ndim - 2
    h_local = g.shape[yax]
    fillv = jnp.asarray(fill, g.dtype)
    k = int(offset)
    if k == 0:
        return g
    if abs(k) >= n * h_local:
        return jnp.full_like(g, fillv)  # entire slab beyond the image

    gs = g - fillv

    def take_rows(x, start, size):
        return lax.slice_in_dim(x, start, start + size, axis=yax)

    q, r = divmod(abs(k), h_local)
    sgn = 1 if k > 0 else -1  # k>0: read from ABOVE (sources at i-q, i-q-1)

    def perm_from(j):
        """the permuted slice from shard i - sgn*j (zeros -> fill at edge
        shards outside the permutation)."""
        if j == 0:
            return lambda sl: sl
        if n == 1:
            return lambda sl: jnp.zeros_like(sl)
        if sgn > 0:
            pairs = [(s, s + j) for s in range(n - j)]
        else:
            pairs = [(s + j, s) for s in range(n - j)]
        return lambda sl: lax.ppermute(sl, axis_name, pairs)

    if r == 0:
        slab = perm_from(q)(gs)
    else:
        # out rows [r, H) <- source shard i-sgn*q rows [0, H-r) (k>0);
        # out rows [0, r) <- shard i-sgn*(q+1) rows [H-r, H)
        if sgn > 0:
            near = perm_from(q)(take_rows(gs, 0, h_local - r))
            far = perm_from(q + 1)(take_rows(gs, h_local - r, r))
            slab = jnp.concatenate([far, near], axis=yax)
        else:
            near = perm_from(q)(take_rows(gs, r, h_local - r))
            far = perm_from(q + 1)(take_rows(gs, 0, r))
            slab = jnp.concatenate([near, far], axis=yax)
    return slab + fillv
