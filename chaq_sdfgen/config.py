"""Frozen configuration for the SDF framework.

One config object encodes the union of both reference binaries' flag sets
(openmp/sdfgen.c:139-244 and opencl/main.cpp:362-444) plus this package's
extensions (algorithm choice, soft mode, sharding).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


class Algorithm(str, enum.Enum):
    """Which distance-transform core to run.

    - EXACT: banded separable exact EDT — a data-parallel reformulation of
      the OpenMP binary's Felzenszwalb–Huttenlocher transform (openmp/df.c).
      Byte-identical to the reference after the clamped remap.
    - BRUTE: truncated spread-radius search reproducing the OpenCL kernel's
      semantics (opencl/sdf.cl:79-224) including its triangle-search
      candidate set.
    - JFA: jump-flooding nearest-seed propagation, O(n^2 log n); the
      scale-out algorithm (unclamped full-range distances).
    """

    EXACT = "exact"
    BRUTE = "brute"
    JFA = "jfa"


class Channel(str, enum.Enum):
    """Which channel the threshold tests (openmp/sdfgen.c:264, -l flag)."""

    ALPHA = "alpha"          # default: byte offset 1 of the gray+alpha pair
    LUMINANCE = "luminance"  # -l flag: byte offset 0


@dataclasses.dataclass(frozen=True)
class SdfConfig:
    """Configuration mirroring the reference defaults: spread 64, alpha
    channel, symmetric, not inverted (openmp/sdfgen.c:128-133)."""

    spread: int = 64
    asymmetric: bool = False
    channel: Channel = Channel.ALPHA
    invert: bool = False
    algorithm: Algorithm = Algorithm.EXACT
    # OpenCL-parity detail: the OpenMP binary implements -n by flipping the
    # threshold test itself (sdfgen.c:58-59); the OpenCL kernel flips the sign
    # decider (sdf.cl:208). Visually identical; byte-level both are supported:
    # Algorithm.BRUTE uses the decider rule, others the threshold rule.
    jfa_plus_one: bool = True  # run the extra +1 pass (1+JFA accuracy fix)
    band: Optional[int] = None  # banded-EDT half-width; default spread + 2

    def __post_init__(self):
        if self.spread < 1:
            raise ValueError("spread must be a positive integer")
        if isinstance(self.channel, str):
            object.__setattr__(self, "channel", Channel(self.channel))
        if isinstance(self.algorithm, str):
            object.__setattr__(self, "algorithm", Algorithm(self.algorithm))

    @property
    def channel_offset(self) -> int:
        return 0 if self.channel == Channel.LUMINANCE else 1

    @property
    def effective_band(self) -> int:
        """Half-width of the exact band. band >= spread + 2 guarantees that
        every distance that survives the clamped remap (including the -1
        inside bias, openmp/sdfgen.c:103) is computed exactly; anything
        farther saturates above the clamp."""
        return self.band if self.band is not None else self.spread + 2


@dataclasses.dataclass(frozen=True)
class SoftConfig:
    """Differentiable-path configuration (no reference analogue). The hard
    threshold img > 127 becomes sigmoid((img-127.5)/tau) and the hard min
    over parabolas becomes a -T*logsumexp soft-min.

    gray_range: declared (lo, hi) bound on the tested pixel values. CLI /
    atlas inputs are u8 so (0, 255) is always valid there and selects the
    two-matmul cascade (ops/soft_mxu.py); pass None for unbounded
    (trained-image) inputs, which the runtime range gate routes
    (ops/softsdf.py).

    precision: matmul precision of the cascade, a jax.lax.Precision name
    ("highest", "high" or "default")."""

    tau: float = 1.0          # threshold temperature (pixel units)
    temperature: float = 0.5  # soft-min temperature T (squared-pixel units)
    eps: float = 1e-6         # sqrt smoothing epsilon
    clamp: str = "hard"       # "hard" | "tanh" | "none" — output clamping
    gray_range: Optional[Tuple[float, float]] = (0.0, 255.0)
    precision: str = "highest"


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    """Device-mesh layout. The image grid is sharded over rows ('y'); the
    batch dimension over 'data'. Pass 1 runs along x with full rows
    resident per shard (zero communication); pass 2 exchanges a band-sized
    row halo between neighbouring devices (SURVEY.md §2.4)."""

    mesh_shape: Tuple[int, ...] = (1,)
    axis_names: Tuple[str, ...] = ("y",)
    data_axis: Optional[str] = None  # name of the batch axis, if any

    def __post_init__(self):
        if len(self.mesh_shape) != len(self.axis_names):
            raise ValueError(
                f"mesh_shape {self.mesh_shape} and axis_names "
                f"{self.axis_names} must have equal length"
            )
        if self.data_axis is not None and self.data_axis not in self.axis_names:
            raise ValueError(
                f"data_axis {self.data_axis!r} not in axis_names {self.axis_names}"
            )

    @property
    def y_axis(self) -> str:
        """The row-sharding axis: the first non-data axis (every pipeline
        shards image rows; 'y' by convention)."""
        for n in self.axis_names:
            if n != self.data_axis:
                return n
        raise ValueError("ShardingConfig has no image axis")

    @property
    def x_axis(self) -> Optional[str]:
        """The column-sharding axis of a 2-D tile mesh (JFA only): the
        second non-data axis if present and its extent exceeds 1."""
        img_axes = [n for n in self.axis_names if n != self.data_axis]
        if len(img_axes) >= 2:
            ext = dict(zip(self.axis_names, self.mesh_shape))[img_axes[1]]
            if ext > 1:
                return img_axes[1]
        return None

    def build_mesh(self):
        """Materialize the jax.sharding.Mesh this config describes (the
        consumer entry point: SDFGenerator / atlas_sdf / CLI --shard-*)."""
        from chaq_sdfgen.parallel import mesh as meshlib

        return meshlib.make_mesh(self.mesh_shape, self.axis_names)
