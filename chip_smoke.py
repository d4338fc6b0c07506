#!/usr/bin/env python3
"""Run the system's main path once on an NVIDIA GPU and check it.

    python3 chip_smoke.py           # one card: every phase below
    python3 chip_smoke.py --four    # four cards: the sharded paths only

One card, through the entry points a user calls, on seeded inputs:

- the CLI's hard EXACT conversion (``cli.main``) of a 4096² image at
  ``-s 64`` and ``-s 1024``, and the reference's documented ``-s 100 -al``;
  BRUTE and JFA through the CLI at 4096²;
- ``atlas_sdf`` on 8 x 1024² and ``atlas_sdf_spread_sweep`` at 4096²;
- the declared-range ``soft_sdf_field`` that ``--soft`` runs, at 4096²;
- a few ``SoftSDFModel`` training steps on a 2 x 2048² batch.

Each result is compared with a plain reference (tolerances and their
precision are stated where they are checked):

- hard EXACT paths are byte-exact against scipy's exact EDT on the host
  (integer d² from the nearest-seed indices, float32 sqrt, then
  ``sdfref.oracle.signed_merge`` and ``float_to_byte``), and against the
  FH transcription ``sdfref.oracle.sdf_pipeline_openmp`` at 256²; BRUTE
  is byte-exact against the OpenCL oracle on windows of the 4096² run;
  JFA equals EXACT on more than 99.5% of pixels (its misses);
- the GPU kernel of ops/edt_triton.py is byte-equal to the XLA core, and
  both are timed; ``numerics.refined_sqrt`` is checked on all 2^24
  integer radicands;
- soft fields: the matmul cascade at Precision.HIGHEST against the scan
  cores, field atol 2e-3 and gradient atol 2e-2 of the gradient's scale
  (the CPU tests' bounds).

Every phase prints its compile time, ``memory_analysis()``, the core it
ran, its largest errors and its wall times (with the card's name). Any
failed check exits non-zero; the last line of a passing run is one JSON
object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

FIELD_ATOL = 2e-3  # soft field, absolute, float32 (tests/test_soft_mxu.py)
GRAD_ATOL = 2e-2  # soft gradient, absolute over max |grad| (same source)


class CheckFailed(AssertionError):
    """A smoke-test result disagreed with its reference."""


def check(ok, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def gpu_name() -> str:
    """Card name and power limit, as nvidia-smi reports them."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


class Report:
    """Prints one line per measurement, each timing labelled with the card."""

    def __init__(self, card: str):
        self.card = card

    def line(self, phase: str, **kv) -> None:
        body = " ".join(f"{k}={v}" for k, v in kv.items())
        print(f"[{phase}] {body}", flush=True)

    def compiled(self, phase: str, fn, *args):
        """AOT-compile ``fn`` for ``args``; print compile time and memory."""
        import jax

        t0 = time.perf_counter()
        c = jax.jit(fn).lower(*args).compile()
        ma = c.memory_analysis()
        mem = (
            "n/a" if ma is None else
            f"args={ma.argument_size_in_bytes} out={ma.output_size_in_bytes} "
            f"temp={ma.temp_size_in_bytes} code={ma.generated_code_size_in_bytes}"
        )
        self.line(phase, compile_s=f"{time.perf_counter() - t0:.3f}", memory=f"[{mem}]")
        return c

    def timed(self, phase: str, label: str, fn, *args, n: int = 5) -> float:
        """Best and median of ``n`` runs of a compiled function, each waited
        for with block_until_ready (after one warm-up run)."""
        import jax

        jax.block_until_ready(fn(*args))
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*args))
            ts.append(time.perf_counter() - t0)
        best, med = min(ts) * 1e3, float(np.median(ts)) * 1e3
        self.line(phase, **{f"{label}_ms_best": f"{best:.3f}",
                            f"{label}_ms_median": f"{med:.3f}"}, card=f"'{self.card}'")
        return best


# --- references on the host --------------------------------------------------


def nearest_distance(seeds: np.ndarray) -> np.ndarray:
    """float32 exact distance to the nearest True pixel (inf where none):
    integer d² from scipy's nearest-seed indices, then float32 sqrt."""
    from scipy import ndimage

    if not seeds.any():
        return np.full(seeds.shape, np.inf, np.float32)
    _, (iy, ix) = ndimage.distance_transform_edt(~seeds, return_indices=True)
    yy, xx = np.indices(seeds.shape)
    d2 = (iy - yy).astype(np.int64) ** 2 + (ix - xx).astype(np.int64) ** 2
    return np.sqrt(d2.astype(np.float32))


def reference_fields(b: np.ndarray):
    """(merged signed field, inside distance) of the OpenMP pipeline."""
    from sdfref import oracle

    inside = nearest_distance(b)
    return oracle.signed_merge(nearest_distance(~b), inside), inside


def reference_bytes(merged: np.ndarray, spread: int, asymmetric: bool) -> np.ndarray:
    from sdfref import oracle

    return oracle.float_to_byte(merged, spread, asymmetric)


def byte_diff(got: np.ndarray, want: np.ndarray) -> int:
    return int(np.abs(got.astype(np.int32) - want.astype(np.int32)).max())


# --- phases ---------------------------------------------------------------------


def phase_refined_sqrt(rep: Report, bits: int = 24) -> None:
    """numerics.refined_sqrt on the card against numpy's correctly rounded
    float32 sqrt, for every integer radicand below 2**bits. The only one
    allowed to differ is 2**24 - 1, the documented near-tie that is never
    a squared distance (see numerics.refined_sqrt)."""
    import jax.numpy as jnp

    from chaq_sdfgen.ops.numerics import refined_sqrt

    n = np.arange(1 << bits, dtype=np.float32)
    c = rep.compiled("refined_sqrt", refined_sqrt, jnp.asarray(n))
    got = np.asarray(c(jnp.asarray(n)))
    bad = np.nonzero(got != np.sqrt(n))[0]
    rep.line("refined_sqrt", radicands=n.size, mismatches=bad.size,
             mismatch_radicands=[int(i) for i in bad[:8]])
    check(set(bad.tolist()) <= {(1 << 24) - 1},
          f"refined_sqrt differs from IEEE sqrt at {bad.size} radicands")


def _write_png(path: str, img2ch: np.ndarray) -> None:
    from chaq_sdfgen.utils import sdfio_native

    data = sdfio_native.encode_gray_alpha_png(img2ch)
    check(data is not None, "native PNG encoder failed")
    with open(path, "wb") as f:
        f.write(data)


def _read_png(path: str) -> np.ndarray:
    from chaq_sdfgen.utils import sdfio_native

    with open(path, "rb") as f:
        out = sdfio_native.decode_gray_alpha(f.read())
    check(out is not None, f"native PNG decoder failed on {path}")
    return out[..., 0]


def run_cli(rep: Report, phase: str, workdir: str, img2ch: np.ndarray, flags) -> np.ndarray:
    """Write ``img2ch`` as a PNG, convert it in-process with ``cli.main``,
    and return the output bytes; prints the wall time of the whole
    conversion (decode, device, encode) and of the compiled pipeline."""
    import jax
    import jax.numpy as jnp

    from chaq_sdfgen import cli
    from chaq_sdfgen.config import Algorithm, Channel, SdfConfig
    from chaq_sdfgen.models.sdf_model import SDFGenerator

    src, dst = os.path.join(workdir, "in.png"), os.path.join(workdir, "out.png")
    _write_png(src, img2ch)
    argv = ["-i", src, "-o", dst] + list(flags)
    args = cli.build_parser().parse_args(argv)
    cfg = SdfConfig(
        spread=args.spread, asymmetric=args.asymmetric,
        channel=Channel.LUMINANCE if args.luminance else Channel.ALPHA,
        invert=args.invert, algorithm=Algorithm(args.algorithm),
    )
    x = jnp.asarray(img2ch)
    c = rep.compiled(phase, SDFGenerator(cfg)._pipeline_fn(jax.default_backend()), x)
    t0 = time.perf_counter()
    rc = cli.main(argv)
    wall = (time.perf_counter() - t0) * 1e3
    check(rc == 0, f"cli.main({' '.join(argv)}) returned {rc}")
    rep.line(phase, cli_wall_ms=f"{wall:.1f}", card=f"'{rep.card}'")
    rep.timed(phase, "pipeline", c, x)
    return _read_png(dst)


def phase_cli_exact(rep: Report, workdir: str, size: int = 4096,
                    spreads=(64, 1024), oracle_size: int = 256) -> dict:
    """Hard EXACT through the CLI, byte-exact against scipy at ``size`` and
    against the FH transcription at ``oracle_size``; the reference's
    documented ``-s 100 -al`` at 200²."""
    from chaq_sdfgen.ops import dispatch
    from sdfref import oracle
    from sdfref.samples import glyph_image

    rep.line("cli_exact", core=dispatch.core("exact"))
    img = glyph_image(7, (size, size))
    merged, _ = reference_fields(img[..., 1] > 127)
    for s in spreads:
        got = run_cli(rep, f"cli_exact_s{s}", workdir, img, ["-s", str(s)])
        want = reference_bytes(merged, s, False)
        d = byte_diff(got, want)
        rep.line(f"cli_exact_s{s}", shape=got.shape, max_byte_diff_vs_scipy=d)
        check(got.shape == want.shape and d == 0, f"-s {s}: bytes differ from scipy")
    small = glyph_image(8, (oracle_size, oracle_size))
    got = run_cli(rep, "cli_exact_fh", workdir, small, ["-s", "64"])
    d = byte_diff(got, oracle.sdf_pipeline_openmp(small, spread=64))
    rep.line("cli_exact_fh", shape=got.shape, max_byte_diff_vs_fh=d)
    check(d == 0, "bytes differ from the FH transcription")
    doc = glyph_image(20260, (200, 200))
    got = run_cli(rep, "cli_readme", workdir, doc, ["-s", "100", "-al"])
    d = byte_diff(got, oracle.sdf_pipeline_openmp(doc, 100, True, channel=0))
    rep.line("cli_readme", flags="'-s 100 -al'", max_byte_diff_vs_fh=d)
    check(d == 0, "-s 100 -al differs from the FH transcription")
    return {"image": img, "merged": merged}


def phase_kernel_vs_xla(rep: Report, img: np.ndarray, spreads=(64, 1024),
                        interpret: bool = False) -> None:
    """The GPU kernel against the XLA core at the same shape: byte-equal,
    both timed end to end (threshold to bytes)."""
    import jax.numpy as jnp

    from chaq_sdfgen.models.sdf_model import exact_distance_field, hard_sdf_exact
    from chaq_sdfgen.ops import edt_triton

    x = jnp.asarray(img)
    for s in spreads:
        outs = {}
        for core in ("xla", "triton"):
            def fn(a, core=core, s=s):
                if core == "triton" and interpret:
                    return edt_triton.sdf_bytes(a[..., 1] > 127, s, interpret=True)
                return hard_sdf_exact(a, s, core=core)

            c = rep.compiled(f"hard_{core}_s{s}", fn, x)
            outs[core] = np.asarray(c(x))
            rep.timed(f"hard_{core}_s{s}", core, c, x)
        d = byte_diff(outs["triton"], outs["xla"])
        rep.line(f"hard_s{s}", max_byte_diff_kernel_vs_xla=d)
        check(d == 0, f"-s {s}: kernel bytes differ from the XLA core")
    b = x[..., 1] > 127
    fields = {}
    for core in ("xla", "triton"):
        def ef(a, core=core):
            if core == "triton" and interpret:
                return edt_triton.distance_field(a, 8191, interpret=True)
            return exact_distance_field(a, core)

        c = rep.compiled(f"exact_field_{core}", ef, b)
        fields[core] = np.asarray(c(b))
        rep.timed(f"exact_field_{core}", core, c, b)
    want = nearest_distance(np.asarray(b))
    for core, got in fields.items():
        err = float(np.abs(got - want).max())
        rep.line(f"exact_field_{core}", max_abs_err_vs_scipy=err)
        check(err == 0.0, f"exact field ({core}) differs from scipy")


def brute_window_reference(img2ch: np.ndarray, spread: int, y0: int, x0: int,
                           n: int) -> np.ndarray:
    """The OpenCL oracle's bytes on the n x n window at (y0, x0): a pixel's
    result depends only on pixels within ``spread`` of it, so the oracle
    runs on the window plus a ``spread`` margin (clipped at the image
    border, where the oracle skips out-of-image probes as the device
    does)."""
    from sdfref import oracle

    h, w = img2ch.shape[:2]
    ys, xs = max(y0 - spread, 0), max(x0 - spread, 0)
    ye, xe = min(y0 + n + spread, h), min(x0 + n + spread, w)
    ref = oracle.sdf_pipeline_opencl(img2ch[ys:ye, xs:xe], spread=spread)
    return ref[y0 - ys : y0 - ys + n, x0 - xs : x0 - xs + n]


def phase_brute_jfa(rep: Report, workdir: str, img: np.ndarray, merged: np.ndarray,
                    spread: int = 64, window: int = 64) -> None:
    """BRUTE and JFA through the CLI on the full image. BRUTE is byte-exact
    against the OpenCL oracle on three windows (a corner, the centre and a
    shape edge); JFA's bytes equal EXACT's on all but its rare misses."""
    from chaq_sdfgen.ops import dispatch

    rep.line("cli_brute", core=dispatch.core("brute"))
    got = run_cli(rep, f"cli_brute_s{spread}", workdir, img,
                  ["-s", str(spread), "--algorithm", "brute"])
    b = img[..., 1] > 127
    edge = np.argwhere(b[1:, :] != b[:-1, :])
    h, w = b.shape
    corners = [(0, 0), ((h - window) // 2, (w - window) // 2)]
    if len(edge):
        ey, ex = edge[len(edge) // 2]
        corners.append((min(max(ey - window // 2, 0), h - window),
                        min(max(ex - window // 2, 0), w - window)))
    d = 0
    for y0, x0 in corners:
        want = brute_window_reference(img, spread, y0, x0, window)
        d = max(d, byte_diff(got[y0 : y0 + window, x0 : x0 + window], want))
    rep.line(f"cli_brute_s{spread}", windows=corners, window=window,
             max_byte_diff_vs_opencl_oracle=d)
    check(d == 0, "BRUTE differs from the OpenCL oracle")
    exact = reference_bytes(merged, spread, False)
    rep.line("cli_jfa", core=dispatch.core("jfa"))
    got = run_cli(rep, f"cli_jfa_s{spread}", workdir, img,
                  ["-s", str(spread), "--algorithm", "jfa"])
    same = float((got == exact).mean())
    rep.line(f"cli_jfa_s{spread}", share_equal_to_exact=f"{same:.6f}",
             max_byte_diff=byte_diff(got, exact))
    check(same > 0.995, "JFA too far from EXACT")


def phase_atlas(rep: Report, batch: int = 8, size: int = 1024,
                sweep_size: int = 4096, spreads=(16, 64, 256)) -> None:
    """atlas_sdf on a batch and the spread sweep on one large image, both
    byte-exact against scipy."""
    import jax.numpy as jnp

    from chaq_sdfgen.config import SdfConfig
    from chaq_sdfgen.models.atlas import atlas_sdf, atlas_sdf_spread_sweep
    from chaq_sdfgen.ops import dispatch
    from sdfref.samples import glyph_image

    imgs = np.stack([glyph_image(100 + i, (size, size)) for i in range(batch)])
    x = jnp.asarray(imgs)
    cfg = SdfConfig(spread=64)
    rep.line("atlas", core=dispatch.core("exact"), batch=batch, size=size)
    c = rep.compiled("atlas", lambda a: atlas_sdf(a, cfg), x)
    got = np.asarray(c(x))
    rep.timed("atlas", "atlas", c, x)
    d = max(byte_diff(got[i], reference_bytes(reference_fields(imgs[i, ..., 1] > 127)[0], 64, False))
            for i in range(batch))
    rep.line("atlas", max_byte_diff_vs_scipy=d)
    check(d == 0, "atlas_sdf differs from scipy")

    big = glyph_image(11, (sweep_size, sweep_size))[None]
    xb = jnp.asarray(big)
    rep.line("sweep", core="xla", spreads=list(spreads))
    t0 = time.perf_counter()
    got = np.asarray(atlas_sdf_spread_sweep(xb, spreads))
    rep.line("sweep", first_call_ms=f"{(time.perf_counter() - t0) * 1e3:.1f}")
    rep.timed("sweep", "sweep", lambda a: atlas_sdf_spread_sweep(a, spreads), xb, n=3)
    merged, _ = reference_fields(big[0, ..., 1] > 127)
    d = max(byte_diff(got[i, 0], reference_bytes(merged, s, False))
            for i, s in enumerate(spreads))
    rep.line("sweep", max_byte_diff_vs_scipy=d)
    check(d == 0, "spread sweep differs from scipy")


def phase_soft(rep: Report, size: int = 4096, spread: int = 64) -> None:
    """The declared-range soft field (tau=2, T=1, gray_range=(0, 255)): the
    cascade at HIGHEST against the scan cores, values and gradients; and
    what the lower matmul precisions give."""
    import jax
    import jax.numpy as jnp

    from chaq_sdfgen.ops import softsdf
    from sdfref.samples import glyph_image

    tau, t = 2.0, 1.0
    img = glyph_image(12, (size, size))
    g = jnp.asarray(img[..., 1].astype(np.float32))
    w = jnp.asarray(np.random.default_rng(13).standard_normal((size, size)).astype(np.float32))

    def cascade(x, prec="highest"):
        return softsdf.soft_sdf_field(x, spread, tau=tau, temperature=t,
                                      gray_range=(0.0, 255.0), precision=prec)

    def scan(x):
        return softsdf.soft_sdf_field_scan(x, spread, tau=tau, temperature=t)

    rep.line("soft", core="xla", route="cascade (declared range)", reference="scan cores")
    vals, grads = {}, {}
    for name, f in (("cascade", cascade), ("scan", scan)):
        c = rep.compiled(f"soft_{name}_fwd", f, g)
        vals[name] = np.asarray(c(g))
        rep.timed(f"soft_{name}_fwd", name, c, g, n=3)
        # the weights are an argument: a closed-over array would be baked
        # into the program as a constant
        vg = rep.compiled(f"soft_{name}_fwd_bwd",
                          jax.value_and_grad(lambda x, wt, f=f: jnp.vdot(f(x), wt)), g, w)
        grads[name] = np.asarray(vg(g, w)[1])
        rep.timed(f"soft_{name}_fwd_bwd", name, vg, g, w, n=3)
    ferr = float(np.abs(vals["cascade"] - vals["scan"]).max())
    scale = float(np.abs(grads["scan"]).max())
    gerr = float(np.abs(grads["cascade"] - grads["scan"]).max()) / scale
    rep.line("soft", field_max_abs_err=ferr, field_atol=FIELD_ATOL,
             grad_max_err_over_scale=gerr, grad_atol=GRAD_ATOL,
             finite=bool(np.isfinite(vals["cascade"]).all()))
    check(np.isfinite(vals["cascade"]).all() and np.isfinite(grads["cascade"]).all(),
          "soft field or gradient not finite")
    check(ferr <= FIELD_ATOL, f"soft field error {ferr} > {FIELD_ATOL}")
    check(gerr <= GRAD_ATOL, f"soft gradient error {gerr} > {GRAD_ATOL} of scale")
    # what the lower precisions give here (reported, not checked: they
    # trade the field bound for speed)
    lower = {}
    for prec in ("high", "default"):
        text = jax.jit(lambda x, p=prec: cascade(x, p)).lower(g).compile().as_text()
        rep.line(f"soft_precision_{prec}", compiled_dot_settings=sorted(set(re.findall(
            r'"operand_precision":\[[^\]]*\]|operand_precision=\{[^}]*\}'
            r'|"algorithm":"\w+"|algorithm=\w+', text))))
        lower[prec] = np.asarray(jax.jit(lambda x, p=prec: cascade(x, p))(g))
        rep.timed(f"soft_precision_{prec}", prec,
                  jax.jit(lambda x, p=prec: cascade(x, p)), g, n=3)
        rep.line(f"soft_precision_{prec}",
                 field_max_abs_err_vs_highest=float(np.abs(lower[prec] - vals["cascade"]).max()),
                 field_max_abs_err_vs_scan=float(np.abs(lower[prec] - vals["scan"]).max()),
                 bitwise_equal_to_highest=bool((lower[prec] == vals["cascade"]).all()))
    rep.line("soft_precision", high_bitwise_equal_to_default=bool(
        (lower["high"] == lower["default"]).all()))


def _train_inputs(batch: int, size: int, seed: int):
    import jax.numpy as jnp

    from chaq_sdfgen.ops import edt, merge
    from sdfref.samples import glyph_image

    imgs = np.stack([glyph_image(seed + i, (size, size)) for i in range(batch)])
    img2ch = imgs.astype(np.float32)
    b = jnp.asarray(imgs[..., 1] > 127)
    d_in, d_out = edt.dual_edt_banded(b, 18)
    target = merge.signed_merge(d_out, d_in)
    return jnp.asarray(img2ch), target


def phase_train(rep: Report, batch: int = 2, size: int = 2048, steps: int = 5) -> list:
    """A few SoftSDFModel training steps: finite, falling loss."""
    import jax

    from chaq_sdfgen.config import SoftConfig
    from chaq_sdfgen.models.soft_model import SoftSDFModel, create_train_state, make_train_step

    x, target = _train_inputs(batch, size, 30)
    model = SoftSDFModel(spread=16, soft=SoftConfig(tau=20.0, temperature=1.0))
    params, opt_state, tx = create_train_state(model, x, lr=5e-2)
    step = rep.compiled("train", make_train_step(model, tx), params, opt_state, x, target)
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        params, opt_state, loss = step(params, opt_state, x, target)
        losses.append(float(loss))
    jax.block_until_ready(params)
    ms = (time.perf_counter() - t0) * 1e3 / steps
    rep.line("train", batch=batch, size=size, losses=[f"{v:.6f}" for v in losses],
             step_ms_mean=f"{ms:.2f}", card=f"'{rep.card}'")
    check(np.isfinite(losses).all(), "non-finite training loss")
    check(losses[-1] < losses[0], "training loss did not fall")
    return losses


# --- four cards -------------------------------------------------------------------


def _shard_devices(arr) -> list:
    return sorted({str(s.device) for s in arr.addressable_shards})


def phase_four(rep: Report, workdir: str, size: int = 4096, atlas_size: int = 1024,
               train_size: int = 2048) -> None:
    """The sharded paths against one card: CLI --shard-y 4 and atlas_sdf on
    a ('data','y') mesh bitwise; the soft train step on a (2, 2) mesh
    within the soft bounds of the unsharded step."""
    import jax
    import jax.numpy as jnp

    from chaq_sdfgen import cli
    from chaq_sdfgen.config import SdfConfig, ShardingConfig, SoftConfig
    from chaq_sdfgen.models.atlas import atlas_sdf
    from chaq_sdfgen.models.sdf_model import SDFGenerator
    from chaq_sdfgen.models.soft_model import SoftSDFModel, create_train_state, make_train_step
    from chaq_sdfgen.parallel.mesh import make_mesh
    from sdfref.samples import glyph_image

    one = jax.devices()[0]
    img = glyph_image(7, (size, size))
    src, dst = os.path.join(workdir, "in.png"), os.path.join(workdir, "out.png")
    _write_png(src, img)
    check(cli.main(["-i", src, "-o", dst, "-s", "64", "--shard-y", "4"]) == 0, "sharded CLI failed")
    got = _read_png(dst)
    want = np.asarray(SDFGenerator(SdfConfig(spread=64)).generate(jax.device_put(img, one)))
    gen = SDFGenerator(SdfConfig(spread=64),
                       sharding=ShardingConfig(mesh_shape=(4,), axis_names=("y",)))
    out = gen.generate(img)
    rep.line("four_cli_shard_y", shard_devices=_shard_devices(out),
             max_byte_diff_vs_one_card=byte_diff(got, want))
    check(byte_diff(got, want) == 0 and byte_diff(np.asarray(out), want) == 0,
          "--shard-y 4 differs from one card")
    check(len(_shard_devices(out)) == 4, "shards not spread over four cards")
    rep.timed("four_cli_shard_y", "sharded_pipeline", gen.compiled(img), jnp.asarray(img))

    imgs = np.stack([glyph_image(100 + i, (atlas_size, atlas_size)) for i in range(8)])
    mesh = make_mesh((2, 2), ("data", "y"))
    out = atlas_sdf(jnp.asarray(imgs), SdfConfig(spread=64), mesh=mesh)
    want = np.asarray(atlas_sdf(jax.device_put(imgs, one), SdfConfig(spread=64)))
    d = byte_diff(np.asarray(out), want)
    rep.line("four_atlas", mesh="(data=2, y=2)", shard_devices=_shard_devices(out),
             max_byte_diff_vs_one_card=d)
    check(d == 0 and len(_shard_devices(out)) == 4, "sharded atlas differs from one card")

    x, target = _train_inputs(2, train_size, 30)
    soft = SoftConfig(tau=20.0, temperature=1.0)
    results = {}
    for name, model in (
        ("one", SoftSDFModel(spread=16, soft=soft)),
        ("mesh", SoftSDFModel(spread=16, soft=soft, mesh=mesh, batch_axis="data")),
    ):
        xs, ts = (jax.device_put(x, one), jax.device_put(target, one)) if name == "one" else (x, target)
        params, opt_state, tx = create_train_state(model, xs, lr=5e-2)

        def loss_fn(p, a, tgt, model=model):
            return jnp.mean((model.apply(p, a) - tgt) ** 2)

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, xs, ts)
        step = jax.jit(make_train_step(model, tx))
        _, _, step_loss = step(params, opt_state, xs, ts)
        check(np.isfinite(float(step_loss)), f"{name}: non-finite train-step loss")
        results[name] = (float(loss), grads)
        if name == "mesh":
            pred = jax.jit(model.apply)(params, xs)
            rep.line("four_train", shard_devices=_shard_devices(pred))
            check(len(_shard_devices(pred)) == 4, "train step not spread over four cards")
    (l1, g1), (l4, g4) = results["one"], results["mesh"]
    g1 = {k: np.asarray(v) for k, v in g1.items()}
    g4 = {k: np.asarray(v) for k, v in g4.items()}
    gerr = max(
        float(np.abs(g4[k] - g1[k]).max()) / max(float(np.abs(g1[k]).max()), 1e-12)
        for k in g1
    )
    rep.line("four_train", loss_one=l1, loss_mesh=l4, grad_max_err_over_scale=gerr,
             grad_atol=GRAD_ATOL)
    check(abs(l4 - l1) <= 1e-3 * abs(l1) + FIELD_ATOL, "sharded loss differs")
    check(gerr <= GRAD_ATOL, "sharded gradients differ")


# --- driver -----------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded paths, on four cards")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devs[0].platform}); nothing run",
              file=sys.stderr)
        return 1
    want_count = 4 if args.four else 1
    if len(devs) < want_count:
        print(f"chip_smoke: needs {want_count} GPUs, found {len(devs)}", file=sys.stderr)
        return 1

    from chaq_sdfgen.utils import sdfio_native
    from chaq_sdfgen.utils.cache import enable_compile_cache

    try:
        so = sdfio_native.build()
    except sdfio_native.BuildError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    print(f"native codec: {so}")
    print(f"compile cache: {enable_compile_cache()}")
    card = gpu_name()
    print(card)
    rep = Report(card)
    rep.line("device", platform=devs[0].platform, kind=f"'{devs[0].device_kind}'",
             count=len(devs), jax=jax.__version__)

    with tempfile.TemporaryDirectory() as work:
        if args.four:
            phase_four(rep, work)
        else:
            phase_refined_sqrt(rep)
            ref = phase_cli_exact(rep, work)
            phase_kernel_vs_xla(rep, ref["image"])
            phase_brute_jfa(rep, work, ref["image"], ref["merged"])
            phase_atlas(rep)
            phase_soft(rep)
            phase_train(rep)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
