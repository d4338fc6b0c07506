"""Batched glyph-atlas SDF generation.

The reference processes one image per process invocation; atlas generation
is the production-scale batch path: a (N, H, W, 2) stack of glyph images
sharded over a ('data', 'y') mesh — batch over 'data', rows over 'y'
(halo exchange) — producing (N, H, W) uint8
SDF bitmaps with the same byte-exact semantics as the single-image CLI.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from chaq_sdfgen.config import SdfConfig
from chaq_sdfgen.ops import dispatch, edt, merge, threshold
from chaq_sdfgen.parallel.distributed import check_mesh
from chaq_sdfgen.parallel.sharded import sharded_hard_sdf_bytes


def atlas_sdf(
    images: jnp.ndarray,
    config: SdfConfig = SdfConfig(),
    mesh: Optional[Mesh] = None,
    sharding=None,
) -> jnp.ndarray:
    """(N, H, W, 2) uint8 -> (N, H, W) uint8 SDF bitmaps.

    With a mesh: shards the batch over 'data' and rows over 'y', placing
    inputs with NamedSharding so XLA keeps every stage device-local except
    the pass-2 halo exchange. Without a mesh: one batched program on the
    images' device, with the core ops/dispatch.py picks for it.

    sharding: alternatively a config.ShardingConfig — the mesh is built
    from it (mesh and sharding are mutually exclusive)."""
    images = jnp.asarray(images)
    if sharding is not None:
        if mesh is not None:
            raise ValueError("pass either mesh or sharding, not both")
        mesh = sharding.build_mesh()
    if images.ndim != 4 or images.shape[-1] != 2:
        raise ValueError(f"expected (N, H, W, 2) gray+alpha stack, got {images.shape}")
    b = threshold.hard_threshold(
        images, channel=config.channel_offset, test_above=not config.invert
    )
    if mesh is None:
        from chaq_sdfgen.models.sdf_model import hard_sdf_exact_from_bool

        return hard_sdf_exact_from_bool(
            b, config.spread, asymmetric=config.asymmetric,
            band=config.effective_band,
            core=dispatch.core("exact", dispatch.platform_of(images)),
        )
    n, h, _ = b.shape
    check_mesh(mesh, n, h)
    return _atlas_sharded(b, config, mesh)


def _atlas_sharded(b, config, mesh):
    axes = dict(zip(mesh.axis_names, mesh.devices.shape))
    spec = P("data", "y", None) if "data" in axes else P("y", None)
    b = jax.device_put(b, NamedSharding(mesh, spec))
    return sharded_hard_sdf_bytes(
        b,
        config.spread,
        mesh,
        asymmetric=config.asymmetric,
        band=config.effective_band,
        batch_axis="data" if "data" in axes else None,
    )


def atlas_sdf_spread_sweep(
    images: jnp.ndarray,
    spreads,
    config: SdfConfig = SdfConfig(),
    band: Optional[int] = None,
) -> jnp.ndarray:
    """(N, H, W, 2) uint8 + a list of spreads -> (len(spreads), N, H, W)
    uint8: the same atlas at multiple falloff ranges (mip-style levels,
    training curricula). One dual EDT at a band >= max(spreads) + 2 serves
    every spread (the distances are exact within the band), so the sweep
    compiles once and each level is only a remap; byte-identical to
    running atlas_sdf per spread."""
    images = jnp.asarray(images)
    if images.ndim != 4 or images.shape[-1] != 2:
        raise ValueError(f"expected (N, H, W, 2) gray+alpha stack, got {images.shape}")
    spreads = tuple(int(s) for s in spreads)
    band = band if band is not None else max(spreads) + 2
    if band < max(spreads) + 2:
        raise ValueError(f"band {band} < max(spreads) + 2 = {max(spreads) + 2}")
    return _sweep(images, spreads, band, config.channel_offset,
                  not config.invert, config.asymmetric)


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5))
def _sweep(images, spreads, band, channel, test_above, asymmetric):
    b = threshold.hard_threshold(images, channel=channel, test_above=test_above)
    d_in, d_out = edt.dual_edt_banded(b, band)
    vals = merge.signed_merge(d_out, d_in)
    return jnp.stack([merge.remap_to_byte(vals, s, asymmetric) for s in spreads])
