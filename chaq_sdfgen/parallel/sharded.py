"""Sharded SDF pipelines: shard_map over a ('data', 'y') mesh.

Layout (SURVEY.md §5 long-context plan, tier (a)+(b)):
- rows stay whole per shard -> pass 1 (row scans) is communication-free,
  exactly like the omp-for row axis (openmp/df.c:113-117);
- pass 2 (banded column stencil) attaches a band-row halo exchanged with
  the neighbouring devices (parallel/halo.py, lax.ppermute), then runs the
  same core as the single-device path — so sharded results are bitwise
  identical to single-device results;
- the batch axis is pure data parallelism.

Every shard-local core here is plain XLA. Gradients flow through
ppermute/shard_map (the gradient all-reduce over 'data' is inserted by XLA
when the loss contracts over that axis).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from chaq_sdfgen.ops import edt, merge, softsdf, threshold
from chaq_sdfgen.ops.numerics import refined_sqrt
from chaq_sdfgen.parallel.halo import exchange_row_halo, fetch_row_slab


def _spec(y_axis: str, batch_axis: Optional[str]):
    return P(y_axis, None) if batch_axis is None else P(batch_axis, y_axis, None)


def _local_hard_bytes(b_blk, spread, asymmetric, band, y_axis):
    """Per-shard hard EXACT pipeline with halo'd pass 2 (the XLA core)."""
    big = edt.big_sentinel(band)

    def field(seeds):
        g = edt.row_nearest_sq(seeds, band)
        gext = exchange_row_halo(g, band, y_axis, big)
        sq = edt.band_min_ext(gext, band)
        # (the reference's single-row no-sqrt quirk can't arise here: a
        # 1-row image is not shardable over 'y' — use the single-device path)
        return refined_sqrt(sq)

    d_in = field(b_blk)
    d_out = field(jnp.logical_not(b_blk))
    vals = merge.signed_merge(d_out, d_in)
    return merge.remap_to_byte(vals, spread, asymmetric)


def sharded_hard_sdf_bytes(
    b: jnp.ndarray,
    spread: int,
    mesh: Mesh,
    asymmetric: bool = False,
    band: Optional[int] = None,
    y_axis: str = "y",
    batch_axis: Optional[str] = None,
) -> jnp.ndarray:
    """Hard EXACT pipeline over a mesh. b: bool (H, W) or (N, H, W) with H
    divisible by the 'y' mesh axis. Bitwise identical to the single-device
    path (same exact-integer arithmetic)."""
    band = band if band is not None else spread + 2

    def fn(blk):
        return _local_hard_bytes(blk, spread, asymmetric, band, y_axis)

    spec = _spec(y_axis, batch_axis)
    return jax.shard_map(fn, mesh=mesh, in_specs=(spec,), out_specs=spec)(b)


def sharded_jfa_distance(
    seeds: jnp.ndarray,
    mesh: Mesh,
    plus_one: bool = True,
    y_axis: str = "y",
    x_axis: Optional[str] = None,
) -> jnp.ndarray:
    """Jump-flood distance field over a row-sharded mesh (the cross-tile
    nearest-seed reduction): every stride-k pass exchanges a k-row halo of
    the packed seed state with the neighbouring devices — multi-hop when k
    exceeds a shard — so the propagation sees exactly the same candidates
    as the single-device loop. Bitwise equal to ops.jfa.jfa_distance.
    seeds: (H, W) bool, H divisible by the mesh.

    x_axis: optional second mesh axis sharding image COLUMNS — the 2-D
    per-device tile decomposition (reference analogue: the kernel's own
    width x height NDRange, opencl/main.cpp:798). Each stride fetches
    the three dy row-slabs over 'y' and shifts them over 'x' per dx tap
    (fetch_col_slab); corner candidates route through both exchanges, so
    diagonal-neighbour data arrives in two hops. Candidate order matches
    the single-chip loop exactly -> bitwise equal."""
    from chaq_sdfgen.ops import jfa as jfa_ops

    if x_axis is not None:
        return _sharded_jfa_distance_2d(seeds, mesh, plus_one, y_axis, x_axis)
    h, w = seeds.shape
    n = dict(zip(mesh.axis_names, mesh.devices.shape))[y_axis]
    h_local = h // n
    strides = jfa_ops._strides(h, w, plus_one)
    invalid = jfa_ops._INVALID_D2

    def local(seeds_blk):
        i = jax.lax.axis_index(y_axis)
        yy = (
            jax.lax.broadcasted_iota(jnp.int32, seeds_blk.shape, 0)
            + i.astype(jnp.int32) * jnp.int32(h_local)
        )
        xx = jax.lax.broadcasted_iota(jnp.int32, seeds_blk.shape, 1)
        # packed state (sy << xbits | sx, -1 = no seed) as in
        # jfa_seed_coords: ONE halo'd array per stride instead of three
        xbits = max((w - 1).bit_length(), 1)
        mask = jnp.int32((1 << xbits) - 1)
        none = jnp.int32(-1)
        p = jnp.where(seeds_blk, (yy << xbits) | xx, none)

        d2 = jnp.where(seeds_blk, jnp.int32(0), invalid)
        n_sh = jax.lax.axis_size(y_axis)
        row = jax.lax.broadcasted_iota(jnp.int32, seeds_blk.shape, 0)

        def perm_rows(rows_arr, j, sgn):
            """receive ``rows_arr`` from shard i - sgn*j; zero-delivery at
            edge shards maps to the -1 marker via the +-1 trick."""
            if j == 0 or n_sh == 1:
                return (
                    rows_arr
                    if j == 0
                    else jnp.full_like(rows_arr, jnp.int32(-1))
                )
            if sgn > 0:
                pairs = [(s, s + j) for s in range(n_sh - j)]
            else:
                pairs = [(s + j, s) for s in range(n_sh - j)]
            return jax.lax.ppermute(rows_arr + 1, y_axis, pairs) - 1

        def dy_candidate(sp, k, sgn):
            """Returns cp(dx) for the dy = -sgn*k tap (out[y] = p_glob at
            global row y - sgn*k) of the stride-start state ``sp``, built
            so every dx-variant stays a FUSED expression: the local part
            is a pad+slice of sp, the remote part is the (small) received
            row band behind a lazily-padded where — no shared
            materialized slab (the single-device loop fuses all eight
            candidate reads into the update chain; materialized slabs
            would add a round trip through memory per candidate)."""
            q, r = divmod(k, h_local)
            if k >= n_sh * h_local:
                return lambda dx: jnp.full_like(sp, none)
            if n_sh == 1:
                # exact reduction: with no neighbour, the received band is
                # the -1 fill, and where(row < r, fill, shift2d(sp, -sgn*r))
                # IS shift2d's own out-of-range fill — the single-chip
                # expression. Skipping the rem/pad/where constructs here
                # removes ~40% of the 1-dev runtime (XLA materializes the
                # padded constant bands inside the stride loop otherwise).
                return lambda dx: jfa_ops._shift2d(sp, -sgn * r, dx, none)
            if r == 0 or q >= 1:
                # the slab is (mostly) remote: one materialized exchange,
                # dx-shifts read it fused (only the 3 largest strides)
                slab = fetch_row_slab(sp, sgn * k, y_axis, -1)
                return lambda dx: jfa_ops._shift2d(slab, 0, dx, none)
            # q == 0: local pad+slice + a k-row band from the neighbour
            if sgn > 0:
                rec = perm_rows(
                    jax.lax.slice_in_dim(sp, h_local - r, h_local, axis=0), 1, 1
                )
                recp = jnp.pad(rec, ((0, h_local - r), (0, 0)), constant_values=none)
                cond = row < jnp.int32(r)
            else:
                rec = perm_rows(jax.lax.slice_in_dim(sp, 0, r, axis=0), 1, -1)
                recp = jnp.pad(rec, ((h_local - r, 0), (0, 0)), constant_values=none)
                cond = row >= jnp.int32(h_local - r)

            def cp(dx, sp=sp, recp=recp, cond=cond, dyl=-sgn * r):
                loc = jfa_ops._shift2d(sp, dyl, dx, none)
                rem = jfa_ops._shift2d(recp, 0, dx, none) if dx != 0 else recp
                return jnp.where(cond, rem, loc)

            return cp

        for k in strides:
            # all eight candidates read the stride-START state (textbook
            # synchronous JFA — bitwise equal to single-chip)
            sp = p
            # rebuild the running best distance from the packed state
            # (exact invariant d2 == dist(p), see ops/jfa.py) — only p
            # crosses passes/halos, halving the carried state
            sy0 = sp >> xbits
            sx0 = sp & mask
            d2 = jnp.where(sp >= 0, (yy - sy0) ** 2 + (xx - sx0) ** 2, invalid)
            up = dy_candidate(sp, k, 1)
            dn = dy_candidate(sp, k, -1)
            cands = [
                up,
                lambda dx, sp=sp: jfa_ops._shift2d(sp, 0, dx, none),
                dn,
            ]
            for si, cf in enumerate(cands):
                for dx in (-k, 0, k):
                    if si == 1 and dx == 0:
                        continue  # (0, 0) is the pixel itself (as single-chip)
                    cp = cf(dx)
                    csy = cp >> xbits
                    csx = cp & mask
                    cd2 = (yy - csy) ** 2 + (xx - csx) ** 2
                    cd2 = jnp.where(cp >= 0, cd2, invalid)
                    take = cd2 < d2
                    p = jnp.where(take, cp, p)
                    d2 = jnp.minimum(d2, cd2)
        return refined_sqrt(d2.astype(jnp.float32))

    spec = P(y_axis, None)
    return jax.shard_map(local, mesh=mesh, in_specs=(spec,), out_specs=spec)(seeds)


def _sharded_jfa_distance_2d(seeds, mesh, plus_one, y_axis, x_axis):
    from chaq_sdfgen.ops import jfa as jfa_ops
    from chaq_sdfgen.parallel.halo import fetch_col_slab, fetch_row_slab

    h, w = seeds.shape
    axes = dict(zip(mesh.axis_names, mesh.devices.shape))
    h_loc = h // axes[y_axis]
    w_loc = w // axes[x_axis]
    strides = jfa_ops._strides(h, w, plus_one)
    invalid = jfa_ops._INVALID_D2
    xbits = max((w - 1).bit_length(), 1)
    mask = jnp.int32((1 << xbits) - 1)
    none = jnp.int32(-1)

    def local(blk):
        iy = jax.lax.axis_index(y_axis).astype(jnp.int32)
        ix = jax.lax.axis_index(x_axis).astype(jnp.int32)
        yy = (
            jax.lax.broadcasted_iota(jnp.int32, blk.shape, 0)
            + iy * jnp.int32(h_loc)
        )
        xx = (
            jax.lax.broadcasted_iota(jnp.int32, blk.shape, 1)
            + ix * jnp.int32(w_loc)
        )
        p = jnp.where(blk, (yy << xbits) | xx, none)
        for k in strides:
            sp = p
            sy0 = sp >> xbits
            sx0 = sp & mask
            d2 = jnp.where(sp >= 0, (yy - sy0) ** 2 + (xx - sx0) ** 2, invalid)
            # dy slab: out[y] = p_glob[y + dy] -> fetch offset -dy
            for dy in (-k, 0, k):
                slab = sp if dy == 0 else fetch_row_slab(sp, -dy, y_axis, none)
                for dx in (-k, 0, k):
                    if dy == 0 and dx == 0:
                        continue
                    cp = (
                        slab
                        if dx == 0
                        else fetch_col_slab(slab, -dx, x_axis, none)
                    )
                    csy = cp >> xbits
                    csx = cp & mask
                    cd2 = (yy - csy) ** 2 + (xx - csx) ** 2
                    cd2 = jnp.where(cp >= 0, cd2, invalid)
                    take = cd2 < d2
                    p = jnp.where(take, cp, p)
                    d2 = jnp.minimum(d2, cd2)
        return refined_sqrt(d2.astype(jnp.float32))

    spec = P(y_axis, x_axis)
    return jax.shard_map(local, mesh=mesh, in_specs=(spec,), out_specs=spec)(seeds)


def _local_soft_mm(gray_blk, band, tau, temperature, eps, test_above,
                   gray_range, y_axis, w_real, precision):
    """Shard-local two-matmul cascade (ops/soft_mxu.py) for the sharded
    tier: the row conv is row-local, and the column conv needs only K2
    rows of the pass-1 SUM per direction — the smallest halo of any soft
    split (zero fill = the dead-window value on image edges)."""
    from chaq_sdfgen.ops import soft_mxu as SM

    t_f = float(temperature)
    k1, shift = SM._range_stats(band, tau, temperature, gray_range)
    k2, _ = SM._range_stats(
        band, tau, temperature, gray_range, margin=SM._P2_MARGIN_T * t_f
    )
    h, w = gray_blk.shape
    wl = SM._round_up(max(w, SM._BLK), SM._BLK)
    gray_p = jnp.pad(gray_blk.astype(jnp.float32), ((0, 0), (0, wl - w)))
    e_in, e_out = SM.shifted_occupancy(
        gray_p, h, w, tau, t_f, test_above, shift
    )

    def pass2_sum(ev):
        s1 = SM.conv_rows_sym(ev, k1, t_f, precision)  # rows never cross shards
        s1x = exchange_row_halo(s1, k2, y_axis, 0.0)  # (h + 2*k2, wl)
        hx = s1x.shape[0]
        hp2 = SM._round_up(hx, SM._BLK)
        s1x = jnp.pad(s1x, ((0, hp2 - hx), (0, 0)))
        return SM.conv_cols_sym(s1x, k2, t_f, precision)[k2 : k2 + h]

    out = SM.soft_tail(pass2_sum(e_in), pass2_sum(e_out), t_f, shift, eps)
    return out[:, :w_real]


def sharded_soft_sdf_field(
    gray: jnp.ndarray,
    spread: int,
    mesh: Mesh,
    tau: float = 1.0,
    temperature: float = 0.5,
    eps: float = 1e-6,
    test_above: bool = True,
    band: Optional[int] = None,
    y_axis: str = "y",
    batch_axis: Optional[str] = None,
    gray_range: Optional[tuple] = None,
    precision: str = "highest",
) -> jnp.ndarray:
    """Sharded differentiable soft SDF (parallel analogue of
    ops.softsdf.soft_sdf_field). Pass 1 local; pass 2 halo'd; fully
    differentiable (ppermute has a transpose rule).

    gray_range: declared (lo, hi) input bound (see ops.softsdf). When in
    the cascade's gamut, the shard-local pipeline is the two-matmul
    cascade with a K2-row pass-1-sum halo; otherwise the scan cores with a
    band-row halo."""
    from chaq_sdfgen.ops import soft_mxu as SM

    band = band if band is not None else spread + 2
    spec = _spec(y_axis, batch_axis)

    if SM.mxu_ok(gray, band, tau, temperature, gray_range):
        w_real = gray.shape[-1]

        def local(gray_blk):
            return _local_soft_mm(
                gray_blk, band, tau, temperature, eps, test_above,
                gray_range, y_axis, w_real, precision,
            )

        fn = local if batch_axis is None else jax.vmap(local)
        return jax.shard_map(fn, mesh=mesh, in_specs=(spec,), out_specs=spec)(gray)

    big = edt.big_sentinel(band)

    def local_scan(gray_blk):
        logits = threshold.soft_logits(gray_blk, tau=tau, test_above=test_above)
        h_in = threshold.soft_log_indicator_from_logits(logits, temperature, True, big)
        h_out = threshold.soft_log_indicator_from_logits(logits, temperature, False, big)

        def field(hh):
            s1 = softsdf.band_softmin(hh, band, temperature, axis=-1)
            s1ext = exchange_row_halo(s1, band, y_axis, softsdf._PAD_HEIGHT)
            return softsdf.band_softmin_ext(s1ext, band, temperature, axis=-2)

        d2_in = field(h_in)
        d2_out = field(h_out)
        e = jnp.float32(eps)
        d_in = jnp.sqrt(jnp.maximum(d2_in, 0) + e)
        d_out = jnp.sqrt(jnp.maximum(d2_out, 0) + e)
        return d_out - jnp.maximum(d_in - jnp.float32(1.0), jnp.float32(0.0))

    return jax.shard_map(local_scan, mesh=mesh, in_specs=(spec,), out_specs=spec)(gray)
