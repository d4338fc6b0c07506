"""Timings of the public entry points on one NVIDIA GPU — prints ONE JSON line.

    python3 bench.py

Rows (seeded inputs from sdfref/samples.py, timed with
utils/profiling.time_compiled: best of 5 runs, each waited for on the
device, after a compiling warm-up):

  hard_4k_s64 / hard_4k_s1024  SDFGenerator, EXACT, one 4096² image
  soft_4k_fwd_bwd              soft_sdf_field (declared u8 range) value+grad
  atlas_8x1k                   atlas_sdf on 8 x 1024² glyphs

A parity guard runs first: the reference's documented ``-s 100 -al`` on
the seeded 200² sample must equal the FH oracle byte for byte, or no
numbers are reported. Without a GPU the script exits 1 and reports
nothing. The benchmark's cells and their bounds are not defined here yet.
"""

import json
import subprocess
import sys

import numpy as np


def main() -> int:
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (JAX found {dev.platform})", file=sys.stderr)
        return 1

    from chaq_sdfgen.config import Channel, SdfConfig
    from chaq_sdfgen.models.atlas import atlas_sdf
    from chaq_sdfgen.models.sdf_model import SDFGenerator
    from chaq_sdfgen.ops import softsdf
    from chaq_sdfgen.utils.cache import enable_compile_cache
    from chaq_sdfgen.utils.profiling import time_compiled
    from sdfref import oracle
    from sdfref.samples import glyph_image

    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()

    sample = glyph_image(20260, (200, 200))
    gen = SDFGenerator(SdfConfig(spread=100, asymmetric=True, channel=Channel.LUMINANCE))
    got = np.asarray(gen.generate(sample))
    if not (got == oracle.sdf_pipeline_openmp(sample, 100, True, channel=0)).all():
        print("bench: parity guard failed; no numbers reported", file=sys.stderr)
        return 1

    img = jnp.asarray(glyph_image(7, (4096, 4096)))
    rows = {}
    for spread in (64, 1024):
        gen = SDFGenerator(SdfConfig(spread=spread))
        rows[f"hard_4k_s{spread}_ms"] = time_compiled(gen.compiled(img), img) * 1e3

    gray = img[..., 1].astype(jnp.float32)
    w = jnp.asarray(np.random.default_rng(1).standard_normal(gray.shape), jnp.float32)
    vg = jax.jit(jax.value_and_grad(lambda g, wt: jnp.vdot(
        softsdf.soft_sdf_field(g, 64, tau=2.0, temperature=1.0, gray_range=(0.0, 255.0)),
        wt)))
    rows["soft_4k_fwd_bwd_ms"] = time_compiled(vg, gray, w) * 1e3

    glyphs = jnp.asarray(np.stack([glyph_image(100 + i, (1024, 1024)) for i in range(8)]))
    at = jax.jit(lambda x: atlas_sdf(x, SdfConfig(spread=64)))
    rows["atlas_8x1k_ms"] = time_compiled(at, glyphs) * 1e3

    print(json.dumps({
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
        "rows": rows,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
