"""Parallel layer: device-mesh helpers, shard_map pipelines with halo
exchange between devices, and multi-host initialization."""
