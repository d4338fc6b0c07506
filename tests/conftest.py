"""Test configuration: a virtual 8-device CPU platform and a seeded sample.

Multi-device sharding logic (shard_map + halo exchange) is validated on a
virtual 8-device CPU mesh, per SURVEY.md §4. Kernels for the GPU run here
only when a test passes ``interpret=True``.

Note: pytest plugin autoload (jaxtyping) imports jax before this conftest
runs, so JAX_PLATFORMS env would be ignored; jax.config still works because
no backend has been initialized yet.

Tests that need an NVIDIA GPU carry the ``gpu`` marker and take the
``gpu_device`` fixture, which skips them when no card is present. On a
card, ``python -m pytest tests/ -m gpu`` runs them (and leaves the
platform to JAX).
"""

import types

import jax
import numpy as np
import pytest

jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

from chaq_sdfgen.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


def pytest_configure(config):
    """Every run but ``-m gpu`` uses the virtual 8-device CPU platform; the
    backend does not exist yet at this point, so the settings take."""
    if config.getoption("markexpr") != "gpu":
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 8)


def needs_devices(n: int) -> None:
    """Skip on backends with fewer than n devices."""
    have = len(jax.devices())
    if have < n:
        pytest.skip(f"needs {n} devices, have {have}")


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when this process has none (decided here,
    at run time, never while test modules are imported)."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs an NVIDIA GPU")
    return devs[0]


SAMPLE_SEED = 20260


@pytest.fixture(scope="session")
def sample(tmp_path_factory):
    """The seeded sample as the reference's README runs it
    (``-s 100 -al``, reference README.md:8): a gray+alpha PNG written by
    the native encoder, and its golden output from the NumPy oracle
    (sdfref/oracle.py, the FH transcription), also written as a PNG."""
    from chaq_sdfgen.utils import sdfio_native
    from sdfref import oracle
    from sdfref.samples import glyph_image

    img = glyph_image(SAMPLE_SEED, (200, 200))
    golden = oracle.sdf_pipeline_openmp(
        img, spread=100, asymmetric=True, channel=0, test_above=True
    )
    d = tmp_path_factory.mktemp("sample")
    inp, out = d / "sample_input.png", d / "sample_output.png"
    inp.write_bytes(sdfio_native.encode_gray_alpha_png(img))
    out.write_bytes(sdfio_native.encode_gray(golden, "png"))
    return types.SimpleNamespace(
        input=str(inp), output=str(out), image=img, golden=golden
    )


@pytest.fixture(scope="session")
def sample_input_2ch(sample):
    from sdfref.oracle import load_image_gray_alpha

    return load_image_gray_alpha(sample.input)


@pytest.fixture(scope="session")
def sample_golden(sample):
    from PIL import Image

    return np.asarray(Image.open(sample.output))
