"""SDF generator pipelines — the framework's "model" layer.

Mirrors the reference's main() pipelines (openmp/sdfgen.c:122-352,
opencl/main.cpp:358-855) as pure jittable functions over device arrays:

  hard_sdf_exact  — OpenMP-binary semantics, byte-identical (Algorithm.EXACT)
  hard_sdf_brute  — OpenCL-kernel semantics, byte-identical (Algorithm.BRUTE)
  hard_sdf_jfa    — jump-flood variant (Algorithm.JFA)
  soft_sdf        — differentiable path (models/ soft model)

`SDFGenerator` wraps them behind SdfConfig with jit caching.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from chaq_sdfgen.config import Algorithm, SdfConfig
from chaq_sdfgen.ops import dispatch, edt, merge, threshold


@functools.partial(
    jax.jit,
    static_argnames=("spread", "asymmetric", "channel", "test_above", "band", "core"),
)
def hard_sdf_exact(
    img2ch: jnp.ndarray,
    spread: int,
    asymmetric: bool = False,
    channel: int = 1,
    test_above: bool = True,
    band: Optional[int] = None,
    core: Optional[str] = None,
) -> jnp.ndarray:
    """Full OpenMP-binary pipeline on device: (H, W, 2) uint8 -> (H, W) uint8.

    Byte-identical to chaq_sdfgen (openmp/sdfgen.c main): threshold (-n via
    test_above), dual banded-exact EDT, biased signed merge, clamped remap.
    ``core`` is ``dispatch.XLA`` or ``dispatch.TRITON``; None asks
    ops/dispatch.py for the default backend's core.
    """
    b = threshold.hard_threshold(img2ch, channel=channel, test_above=test_above)
    return hard_sdf_exact_from_bool(
        b, spread, asymmetric=asymmetric, band=band, core=core
    )


@functools.partial(jax.jit, static_argnames=("spread", "asymmetric", "band", "core"))
def hard_sdf_exact_from_bool(
    b: jnp.ndarray,
    spread: int,
    asymmetric: bool = False,
    band: Optional[int] = None,
    core: Optional[str] = None,
) -> jnp.ndarray:
    """EXACT pipeline from a thresholded bool grid (..., H, W) -> uint8."""
    band = band if band is not None else spread + 2
    if core is None:
        core = dispatch.core("exact")
    # one-row images take the reference's no-sqrt quirk (edt.edt_banded),
    # which only the XLA core reproduces
    if core == dispatch.TRITON and b.shape[-2] >= 2:
        from chaq_sdfgen.ops import edt_triton

        return edt_triton.sdf_bytes(b, spread, asymmetric, band)
    d_in, d_out = edt.dual_edt_banded(b, band)
    vals = merge.signed_merge(d_out, d_in)
    return merge.remap_to_byte(vals, spread, asymmetric)


def hard_sdf_brute(
    img2ch: jnp.ndarray,
    spread: int,
    asymmetric: bool = False,
    use_luminance: bool = False,
    invert: bool = False,
) -> jnp.ndarray:
    """Full OpenCL-kernel pipeline (opencl/sdf.cl:193-224), byte-identical:
    threshold always > 127, triangle candidate set (diagonal-exclusion quirk
    included), invert flips the sign decider."""
    from chaq_sdfgen.ops import brute

    channel = 0 if use_luminance else 1
    b = threshold.hard_threshold(img2ch, channel=channel, test_above=True)
    return brute.brute_sdf_bytes(b, spread, asymmetric=asymmetric, invert=invert)


def hard_sdf_jfa(
    img2ch: jnp.ndarray,
    spread: int,
    asymmetric: bool = False,
    channel: int = 1,
    test_above: bool = True,
    plus_one: bool = True,
) -> jnp.ndarray:
    """Jump-flood pipeline: unclamped full-range nearest-seed distances
    (no band), merged/remapped like the OpenMP binary. O(n^2 log n)."""
    from chaq_sdfgen.ops import jfa

    b = threshold.hard_threshold(img2ch, channel=channel, test_above=test_above)
    d_in = jfa.jfa_distance(b, plus_one=plus_one)
    d_out = jfa.jfa_distance(jnp.logical_not(b), plus_one=plus_one)
    vals = merge.signed_merge(d_out, d_in)
    return merge.remap_to_byte(vals, spread, asymmetric)


def exact_distance_field(seeds: jnp.ndarray, core: Optional[str] = None) -> jnp.ndarray:
    """(..., H, W) bool -> float32 EXACT distance to the nearest True pixel
    over the whole image (edt.NO_SEED where none exists). Images longer
    than 16384 px per side go to JFA, whose int32 state does not overflow
    there."""
    from chaq_sdfgen.ops import jfa

    h, w = seeds.shape[-2:]
    sat = edt.full_range_sat(max(h, w))
    if sat is None:
        fn = jfa.jfa_distance
        for _ in range(seeds.ndim - 2):
            fn = jax.vmap(fn)
        return fn(seeds)
    if core is None:
        core = dispatch.core("exact_full", dispatch.platform_of(seeds))
    if core == dispatch.TRITON:
        from chaq_sdfgen.ops import edt_triton

        return edt_triton.distance_field(seeds, sat)
    return edt.exact_distance(seeds)


def signed_distance_field_exact(b: jnp.ndarray, core: Optional[str] = None) -> jnp.ndarray:
    """Signed EXACT full-range distance field (f32, no spread clamp, no
    byte remap): positive outside the shape, -(d-1) inside (the OpenMP
    merge bias, openmp/sdfgen.c:98-106). The exact counterpart of the
    jfa-based field: same semantics, no approximation misses."""
    d_in = exact_distance_field(b, core)
    d_out = exact_distance_field(jnp.logical_not(b), core)
    return merge.signed_merge(d_out, d_in)


class SDFGenerator:
    """Config-driven facade with per-shape jit caching.

    The counterpart of the reference CLI binaries: construct once with an
    SdfConfig, call .generate(image_2ch) for uint8 SDF bitmaps.

    soft: optional SoftConfig — generate() runs the differentiable
    pipeline instead and returns the clamped soft byte map (truncated to
    uint8 like the hard remap, openmp/sdfgen.c:94); generate_field()
    exposes the raw float32 signed field.

    sharding: optional ShardingConfig — pipelines run over the described
    device mesh (sharded_hard_sdf_bytes / sharded_soft_sdf_field /
    sharded_jfa; config/flag layer per SURVEY §5). The mesh is built once
    at construction."""

    def __init__(
        self,
        config: SdfConfig = SdfConfig(),
        soft=None,
        sharding=None,
    ):
        if sharding is not None and soft is None and config.algorithm == Algorithm.BRUTE:
            raise ValueError("BRUTE has no sharded pipeline; run it unsharded")
        self.config = config
        self.soft = soft
        self.sharding = sharding
        self._mesh = sharding.build_mesh() if sharding is not None else None
        self._jitted = {}

    def compiled(self, img2ch):
        """The jitted pipeline for this input's shape and platform."""
        img2ch = jnp.asarray(img2ch)
        platform = dispatch.platform_of(img2ch)
        key = (self.config, self.soft, img2ch.shape, platform)
        fn = self._jitted.get(key)
        if fn is None:
            fn = jax.jit(self._pipeline_fn(platform))
            self._jitted[key] = fn
        return fn

    def generate(self, img2ch) -> jnp.ndarray:
        img2ch = jnp.asarray(img2ch)
        return self.compiled(img2ch)(img2ch)

    def generate_field(self, img2ch) -> jnp.ndarray:
        """Raw float32 signed soft field (pre-remap) — the differentiable
        product. Requires a SoftConfig."""
        if self.soft is None:
            raise ValueError("generate_field needs SDFGenerator(soft=SoftConfig())")
        img2ch = jnp.asarray(img2ch)
        key = ("field", self.config, self.soft, img2ch.shape, dispatch.platform_of(img2ch))
        fn = self._jitted.get(key)
        if fn is None:
            fn = jax.jit(self._soft_field_fn())
            self._jitted[key] = fn
        return fn(img2ch)

    def _soft_field_fn(self):
        """(H, W, 2) u8-range image -> float32 signed soft field, routed
        through the sharded pipeline when a ShardingConfig is present."""
        cfg, soft, sh = self.config, self.soft, self.sharding

        def field(img2ch):
            gray = img2ch[..., cfg.channel_offset].astype(jnp.float32)
            kw = dict(
                tau=soft.tau,
                temperature=soft.temperature,
                eps=soft.eps,
                test_above=not cfg.invert,
                band=cfg.effective_band,
                gray_range=soft.gray_range,
                precision=soft.precision,
            )
            if self._mesh is not None:
                from chaq_sdfgen.parallel.sharded import sharded_soft_sdf_field

                return sharded_soft_sdf_field(
                    gray, cfg.spread, self._mesh,
                    y_axis=sh.y_axis,
                    batch_axis=sh.data_axis if gray.ndim > 2 else None,
                    **kw,
                )
            from chaq_sdfgen.ops import softsdf

            return softsdf.soft_sdf_field(gray, cfg.spread, **kw)

        return field

    def _soft_pipeline_fn(self):
        cfg, soft = self.config, self.soft
        field = self._soft_field_fn()

        def pipeline(img2ch):
            from chaq_sdfgen.ops.merge import soft_remap

            s = field(img2ch)
            v = soft_remap(s, cfg.spread, cfg.asymmetric, clamp=soft.clamp)
            # truncating u8 cast, matching the hard remap (sdfgen.c:94)
            return jnp.clip(v, 0.0, 255.0).astype(jnp.uint8)

        return pipeline

    def _pipeline_fn(self, platform: Optional[str] = None):
        """The raw (unjitted) pipeline for the current config.

        ``platform`` is where the computation will actually run (the
        input's committed device — may differ from the default backend
        when the CLI's --platform/--device route to another backend);
        ops/dispatch.py picks the core for it."""
        cfg = self.config
        if self.soft is not None:
            return self._soft_pipeline_fn()
        if self._mesh is not None:
            return self._sharded_pipeline_fn()
        if cfg.algorithm == Algorithm.EXACT:
            return functools.partial(
                hard_sdf_exact,
                spread=cfg.spread,
                asymmetric=cfg.asymmetric,
                channel=cfg.channel_offset,
                test_above=not cfg.invert,
                band=cfg.effective_band,
                core=dispatch.core("exact", platform),
            )
        if cfg.algorithm == Algorithm.BRUTE:
            return functools.partial(
                hard_sdf_brute,
                spread=cfg.spread,
                asymmetric=cfg.asymmetric,
                use_luminance=(cfg.channel_offset == 0),
                invert=cfg.invert,
            )
        if cfg.algorithm == Algorithm.JFA:
            return functools.partial(
                hard_sdf_jfa,
                spread=cfg.spread,
                asymmetric=cfg.asymmetric,
                channel=cfg.channel_offset,
                test_above=not cfg.invert,
                plus_one=cfg.jfa_plus_one,
            )
        raise ValueError(f"unknown algorithm {cfg.algorithm}")  # pragma: no cover

    def _sharded_pipeline_fn(self):
        """Hard pipelines over the ShardingConfig's mesh (scale-out of the
        reference's single-device decompositions, SURVEY §2.4)."""
        cfg, sh, mesh = self.config, self.sharding, self._mesh

        def pipeline(img2ch):
            from chaq_sdfgen.parallel import sharded as S

            b = threshold.hard_threshold(
                img2ch, channel=cfg.channel_offset, test_above=not cfg.invert
            )
            if cfg.algorithm == Algorithm.EXACT:
                return S.sharded_hard_sdf_bytes(
                    b, cfg.spread, mesh, asymmetric=cfg.asymmetric,
                    band=cfg.effective_band, y_axis=sh.y_axis,
                    batch_axis=sh.data_axis if b.ndim > 2 else None,
                )
            if cfg.algorithm == Algorithm.JFA:
                d_in = S.sharded_jfa_distance(
                    b, mesh, plus_one=cfg.jfa_plus_one, y_axis=sh.y_axis,
                    x_axis=sh.x_axis,
                )
                d_out = S.sharded_jfa_distance(
                    jnp.logical_not(b), mesh, plus_one=cfg.jfa_plus_one,
                    y_axis=sh.y_axis, x_axis=sh.x_axis,
                )
                vals = merge.signed_merge(d_out, d_in)
                return merge.remap_to_byte(vals, cfg.spread, cfg.asymmetric)
            raise ValueError(f"no sharded pipeline for {cfg.algorithm}")

        return pipeline
