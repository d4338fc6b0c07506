"""The one place that decides which core runs each algorithm.

The choice depends only on the platform of the array the core will run on
(``platform_of``):

- ``"gpu"``: the hand-written kernel where one is kept (``KERNELS``),
  otherwise the XLA core. Kernels are always compiled for the card; no
  path runs the Pallas interpreter because of the platform.
- ``"cpu"``: the XLA core.
- any other platform: ``UnsupportedPlatform``.

Tests that want a kernel's arithmetic on the CPU call the kernel module
in interpret mode themselves.
"""

from __future__ import annotations

import jax

XLA = "xla"
TRITON = "triton"

# algorithm -> the kernel that serves it on the GPU; the full-range exact
# field runs the banded kernel with band = H
KERNELS = {"exact": TRITON, "exact_full": TRITON}

ALGORITHMS = ("exact", "exact_full", "brute", "jfa", "soft")


class UnsupportedPlatform(ValueError):
    """The array lives on a platform this package has no core for."""


def platform_of(x=None) -> str:
    """Platform of the device an array is committed to; the default
    backend for host arrays, tracers and uncommitted arrays."""
    if x is not None:
        try:
            devs = x.devices()
        except (AttributeError, jax.errors.ConcretizationTypeError):
            devs = None
        if devs:
            return next(iter(devs)).platform
    return jax.default_backend()


def core(algorithm: str, platform: str | None = None) -> str:
    """``TRITON`` or ``XLA``: the core that runs ``algorithm`` on
    ``platform`` (default: the default backend)."""
    if algorithm not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    platform = platform or jax.default_backend()
    if platform == "gpu":
        return KERNELS.get(algorithm, XLA)
    if platform == "cpu":
        return XLA
    raise UnsupportedPlatform(
        f"no core for platform {platform!r}: this package runs on 'gpu' "
        f"(NVIDIA) and 'cpu'"
    )
