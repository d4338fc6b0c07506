"""chaq_sdfgen — differentiable signed-distance-field framework on JAX.

A from-scratch JAX/XLA/Pallas re-design of chaquator/chaq-sdfgen's
capabilities (see SURVEY.md): exact banded EDT (OpenMP-binary parity),
truncated spread-radius search (OpenCL-kernel parity), jump-flood scale-out,
a differentiable soft path, and sharding over a device mesh.
"""

from chaq_sdfgen.config import Algorithm, Channel, SdfConfig, ShardingConfig, SoftConfig
from chaq_sdfgen.models.sdf_model import (
    SDFGenerator,
    hard_sdf_brute,
    hard_sdf_exact,
    hard_sdf_exact_from_bool,
    hard_sdf_jfa,
)

__version__ = "0.1.0"

__all__ = [
    "Algorithm",
    "Channel",
    "SdfConfig",
    "ShardingConfig",
    "SoftConfig",
    "SDFGenerator",
    "hard_sdf_exact",
    "hard_sdf_exact_from_bool",
    "hard_sdf_brute",
    "hard_sdf_jfa",
    "__version__",
]
