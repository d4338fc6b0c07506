"""CLI — the union of both reference binaries' flag sets (reference L5).

Short flags mirror chaq_sdfgen (openmp/sdfgen.c:32-49): -i/-o/-s/-q/-f,
-a/-l/-n (combinable in the C version; argparse accepts -al etc. via
standard short-option clustering). Long options mirror
chaq_sdfgen_opencl (opencl/main.cpp:362-444): --list-devices,
--log-level, --time, plus this package's extensions: --algorithm (exact/
brute/jfa), --soft / --soft-tau / --soft-temperature / --soft-field /
--soft-prec / --gray-range (differentiable pipeline), --shard-y
(ShardingConfig device-mesh runs).

Usage:  python -m chaq_sdfgen -i in.png -o out.png -s 100 -al
"""

from __future__ import annotations

import argparse
import logging
import sys
import time
from typing import Optional

import numpy as np

log = logging.getLogger("chaq_sdfgen")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="chaq_sdfgen",
        description="Signed-distance-field generator "
        "(capabilities of chaquator/chaq-sdfgen, built on JAX).",
    )
    p.add_argument("-i", "--input", help="input file; '-' reads stdin")
    p.add_argument("-o", "--output", help="output file; '-' writes stdout")
    p.add_argument("-s", "--spread", type=int, default=64,
                   help="spread radius in pixels (default: 64)")
    p.add_argument("-q", "--quality", type=int, default=100,
                   help="jpg quality 1-100 (default: 100)")
    p.add_argument("-f", "--filetype", default=None,
                   help="force output filetype: png, bmp, tga, jpg "
                        "(default: deduced from output filename, png fallback)")
    p.add_argument("-a", "--asymmetric", action="store_true",
                   help="asymmetric spread (unsigned distance transform)")
    p.add_argument("-l", "--luminance", action="store_true",
                   help="test pixels by luminance instead of alpha")
    p.add_argument("-n", "--invert", action="store_true",
                   help="invert the threshold test")
    p.add_argument("--algorithm", choices=["exact", "brute", "jfa"], default="exact",
                   help="distance core: exact (OpenMP-binary parity), brute "
                        "(OpenCL-kernel parity), jfa (jump flood)")
    p.add_argument("--list-platforms", action="store_true",
                   help="list available backends (opencl/main.cpp --list-platforms analogue)")
    p.add_argument("--platform", default=None,
                   help="select backend platform by case-insensitive name "
                        "substring (opencl/main.cpp --platform analogue)")
    p.add_argument("--list-devices", action="store_true",
                   help="list accelerator devices and exit")
    p.add_argument("--device", default=None,
                   help="select device by index or kind substring "
                        "(opencl/main.cpp --device analogue)")
    p.add_argument("--two-channel", action="store_true",
                   help="write gray+alpha output like the OpenCL binary "
                        "(opencl/main.cpp:166-199); default is 1-channel like "
                        "the OpenMP binary")
    p.add_argument("--log-level", default="critical",
                   choices=["trace", "debug", "info", "warn", "err", "critical", "off"],
                   help="log level (default: critical)")
    p.add_argument("--time", action="store_true", dest="time_kernel",
                   help="print kernel timing (like the OpenCL --time flag): "
                        "the best of 5 further runs of the compiled "
                        "pipeline, each waited for on the device")
    p.add_argument("--soft", action="store_true",
                   help="differentiable soft pipeline: sigmoid threshold + "
                        "soft-min EDT (no reference "
                        "analogue). Output is the clamped soft byte map; "
                        "--soft-field additionally dumps the raw float "
                        "signed field")
    p.add_argument("--soft-tau", type=float, default=1.0,
                   help="soft threshold temperature in pixel units "
                        "(default: 1.0)")
    p.add_argument("--soft-temperature", type=float, default=0.5,
                   help="soft-min temperature T in squared-pixel units "
                        "(default: 0.5)")
    p.add_argument("--soft-eps", type=float, default=1e-6,
                   help="sqrt smoothing epsilon (default: 1e-6)")
    p.add_argument("--soft-clamp", default="hard",
                   choices=["hard", "tanh", "none"],
                   help="output clamping of the soft remap (default: hard)")
    p.add_argument("--soft-field", default=None, metavar="FILE.npy",
                   help="with --soft: also save the raw float32 signed "
                        "field as .npy")
    p.add_argument("--soft-prec", default="highest",
                   choices=("highest", "high"),
                   help="matmul precision of the soft path's cascade "
                        "(jax.lax.Precision; default: highest, full "
                        "float32). Lower precisions trade field accuracy "
                        "for speed")
    p.add_argument("--gray-range", nargs=2, type=float, default=(0.0, 255.0),
                   metavar=("LO", "HI"),
                   help="declared input-value bound for the soft path "
                        "(default: 0 255 — always valid for u8 images; "
                        "selects the matmul cascade). Pass e.g. "
                        "'--gray-range -1e9 1e9' to force the scan cores")
    p.add_argument("--shard-y", type=int, default=1, metavar="N",
                   help="shard image rows over N mesh devices "
                        "(ShardingConfig; 1 = unsharded)")
    p.add_argument("--no-jit-cache", action="store_true", help=argparse.SUPPRESS)
    return p


_LEVELS = {
    "trace": logging.DEBUG,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "err": logging.ERROR,
    "critical": logging.CRITICAL,
    "off": logging.CRITICAL + 10,
}


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=_LEVELS[args.log_level], stream=sys.stderr,
                        format="[%(levelname)s] %(message)s")

    import jax

    def platforms():
        """Available backend platforms: the default backend plus the
        always-present CPU host backend (the counterpart of the CL
        platform list, opencl/main.cpp:452-476)."""
        seen = []
        for d in jax.devices():
            if d.platform not in seen:
                seen.append(d.platform)
        if "cpu" not in seen:
            seen.append("cpu")
        return seen

    if args.list_platforms:
        for i, pname in enumerate(platforms()):
            print(f"{i}: {pname}")
        return 0

    # platform select by case-insensitive name substring, first match —
    # mirrors opencl/main.cpp:493-538
    platform = None
    if args.platform is not None:
        matches = [n for n in platforms() if args.platform.lower() in n.lower()]
        if not matches:
            print("Platform specified not found.", file=sys.stderr)
            return 1
        platform = matches[0]
        log.info("selected platform %s", platform)

    if args.list_devices:
        for d in jax.devices(platform) if platform else jax.devices():
            print(f"{d.id}: {d.device_kind} ({d.platform})")
        return 0

    device = None
    if platform is not None:
        device = jax.devices(platform)[0]
    if args.device is not None:
        devs = jax.devices(platform) if platform else jax.devices()
        if args.device.isdigit():
            idx = int(args.device)
            if idx >= len(devs):
                print(f"No device with index {idx}.", file=sys.stderr)
                return 1
            device = devs[idx]
        else:
            matches = [d for d in devs if args.device.lower() in d.device_kind.lower()]
            if not matches:
                print(f"No device matching {args.device!r}.", file=sys.stderr)
                return 1
            device = matches[0]

    # validation mirrors openmp/sdfgen.c:229-244
    if not args.quality or args.quality > 100:
        print("Invalid value given for jpeg quality. Must be between 1-100", file=sys.stderr)
        return 1
    if args.spread < 1:
        print("Invalid value given for spread. Must be a positive integer.", file=sys.stderr)
        return 1
    if args.input is None:
        print("No input file specified.", file=sys.stderr)
        return 1
    if args.output is None:
        print("No output file specified.", file=sys.stderr)
        return 1
    if args.shard_y > 1 and args.algorithm == "brute" and not args.soft:
        print("--algorithm brute has no sharded pipeline; drop --shard-y.",
              file=sys.stderr)
        return 1
    if args.soft_field is not None and not args.soft:
        print("--soft-field requires --soft.", file=sys.stderr)
        return 1

    from chaq_sdfgen.utils.cache import enable_compile_cache

    enable_compile_cache()

    from chaq_sdfgen.config import (
        Algorithm, Channel, SdfConfig, ShardingConfig, SoftConfig,
    )
    from chaq_sdfgen.models.sdf_model import SDFGenerator
    from chaq_sdfgen.utils import imageio as iio

    # Host image decode overlapped with device-backend bring-up, mirroring
    # the reference's std::async(open_image) alongside OpenCL setup
    # (opencl/main.cpp:604, 729-738). stdin cannot be read from a worker
    # thread safely; keep it synchronous.
    import concurrent.futures

    try:
        if args.input == "-":
            img2ch = iio.load_gray_alpha(args.input)
            jax.devices()
        else:
            with concurrent.futures.ThreadPoolExecutor(max_workers=1) as ex:
                fut = ex.submit(iio.load_gray_alpha, args.input)
                jax.devices()  # force backend initialization concurrently
                img2ch = fut.result()
    except Exception as e:
        print(f"Input file could not be opened. ({e})", file=sys.stderr)
        return 1
    log.info("loaded %s: %dx%d", args.input, img2ch.shape[1], img2ch.shape[0])

    cfg = SdfConfig(
        spread=args.spread,
        asymmetric=args.asymmetric,
        channel=Channel.LUMINANCE if args.luminance else Channel.ALPHA,
        invert=args.invert,
        algorithm=Algorithm(args.algorithm),
    )
    soft_cfg = None
    if args.soft:
        soft_cfg = SoftConfig(
            tau=args.soft_tau,
            temperature=args.soft_temperature,
            eps=args.soft_eps,
            clamp=args.soft_clamp,
            gray_range=tuple(args.gray_range),
            precision=args.soft_prec,
        )
    shard_cfg = None
    if args.shard_y > 1:
        shard_cfg = ShardingConfig(mesh_shape=(args.shard_y,), axis_names=("y",))
        n_dev = len(jax.devices(platform) if platform else jax.devices())
        if args.shard_y > n_dev:
            print(f"--shard-y needs {args.shard_y} devices, have {n_dev}.",
                  file=sys.stderr)
            return 1
    gen = SDFGenerator(cfg, soft=soft_cfg, sharding=shard_cfg)

    if device is not None:
        img2ch = jax.device_put(jax.numpy.asarray(img2ch), device)
    t0 = time.perf_counter()
    out = np.asarray(jax.block_until_ready(gen.generate(img2ch)))
    dt = time.perf_counter() - t0
    if args.soft_field is not None:
        np.save(args.soft_field, np.asarray(gen.generate_field(img2ch)))
        log.info("saved raw soft field to %s", args.soft_field)
    if args.time_kernel:
        # the compiled pipeline alone, waited for on the device — the
        # counterpart of the reference's kernel-event profiling
        from chaq_sdfgen.utils.profiling import time_compiled

        x = jax.numpy.asarray(img2ch)
        kt = time_compiled(gen.compiled(x), x)
        print(f"Kernel timing: {kt:.3f} sec", file=sys.stderr)
    log.info("sdf computed in %.3fs (%s)", dt, cfg.algorithm.value)

    try:
        if args.two_channel:
            iio.write_gray_alpha(out, args.output, filetype=args.filetype, quality=args.quality)
        else:
            iio.write_gray(out, args.output, filetype=args.filetype, quality=args.quality)
    except ValueError as e:
        print(f"Invalid filetype specified. ({e})", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
