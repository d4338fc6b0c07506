"""Compute ops: threshold/indicator, banded exact EDT, min-plus stencils,
brute (OpenCL-parity) search, jump-flood, soft-min EDT, merge/remap, the
GPU kernel for the EDT's pass 2, and the module that picks a core per
platform (dispatch.py)."""
