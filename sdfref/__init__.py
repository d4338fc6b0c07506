"""sdfref — pure-NumPy oracle for the reference chaq-sdfgen semantics.

This package is the *test oracle* for the framework: a direct, slow,
obviously-correct transcription of the reference's OpenMP pipeline
(openmp/sdfgen.c, openmp/df.c in the reference) and of the OpenCL kernel
semantics (opencl/sdf.cl). It is NOT part of the production path.
"""

from sdfref.oracle import (
    felzenszwalb_edt_1d,
    felzenszwalb_edt_2d,
    img_to_bool,
    bool_to_indicator,
    signed_merge,
    float_to_byte,
    sdf_pipeline_openmp,
    sdf_pipeline_opencl,
)

__all__ = [
    "felzenszwalb_edt_1d",
    "felzenszwalb_edt_2d",
    "img_to_bool",
    "bool_to_indicator",
    "signed_merge",
    "float_to_byte",
    "sdf_pipeline_openmp",
    "sdf_pipeline_opencl",
]
