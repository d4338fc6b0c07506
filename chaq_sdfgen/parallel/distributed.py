"""Multi-host (DCN tier) initialization and failure detection.

The reference is single-process (SURVEY.md §2.4); this module provides the
pod-slice entry points: jax.distributed bring-up, a global ('host', 'y')
mesh, and the startup mesh-size sanity checks the reference lacks
(SURVEY.md §5 'failure detection')."""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh

log = logging.getLogger("chaq_sdfgen")


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Bring up jax.distributed for a multi-host slice. No-op when running
    single-process (the common single-host case)."""
    if num_processes is None or num_processes <= 1:
        log.debug("distributed: single process, skipping initialize")
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    log.info(
        "distributed: process %d/%d, %d local / %d global devices",
        jax.process_index(),
        jax.process_count(),
        jax.local_device_count(),
        jax.device_count(),
    )


def global_mesh(y_per_host: Optional[int] = None, data_axis: bool = True) -> Mesh:
    """Global ('data', 'y') mesh across all hosts: batch over hosts (DCN),
    rows over the devices within each host. Falls back to a 1-host
    layout transparently."""
    devices = np.array(jax.devices())
    hosts = jax.process_count()
    per_host = len(devices) // hosts if hosts else len(devices)
    if y_per_host is None:
        y_per_host = per_host
    if per_host % y_per_host != 0:
        raise ValueError(
            f"y_per_host={y_per_host} does not divide devices/host={per_host}"
        )
    data = len(devices) // y_per_host
    arr = devices.reshape(data, y_per_host)
    return Mesh(arr, ("data", "y"))


def check_mesh(mesh: Mesh, batch: int, height: int) -> None:
    """Startup sanity checks (the reference exits with raw errors,
    openmp/sdfgen.c:24-30; we fail fast with actionable messages)."""
    axes = dict(zip(mesh.axis_names, mesh.devices.shape))
    if "data" in axes and batch % axes["data"] != 0:
        raise ValueError(
            f"batch {batch} not divisible by data-axis size {axes['data']}"
        )
    if "y" in axes and height % axes["y"] != 0:
        raise ValueError(
            f"image height {height} not divisible by y-axis size {axes['y']}"
        )
