"""Device-mesh helpers (SURVEY.md §2.4: the reference is single-process
shared-memory; this package scales over an explicit mesh).

Conventions: axis 'y' shards image rows (the omp-for axis of
openmp/df.c:113-117 generalized across devices; pass 1 stays local because
rows are kept whole per shard, pass 2 exchanges a band halo with its neighbours);
axis 'data' shards the batch (multi-host DCN tier)."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Tuple[str, ...] = ("y",),
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a mesh over the given (or all) devices. Default: 1-D 'y' mesh
    over every device."""
    devices = list(devices if devices is not None else jax.devices())
    if shape is None:
        shape = (len(devices),)
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh shape {shape} needs {n} devices, have {len(devices)}")
    arr = np.array(devices[:n]).reshape(shape)
    return Mesh(arr, axis_names)


def row_sharding(mesh: Mesh, y_axis: str = "y", batch_axis: Optional[str] = None):
    """NamedSharding for (..., H, W) image arrays: rows over ``y_axis``,
    optional leading batch over ``batch_axis``, W replicated."""
    if batch_axis is None:
        return NamedSharding(mesh, P(y_axis, None))
    return NamedSharding(mesh, P(batch_axis, y_axis, None))
