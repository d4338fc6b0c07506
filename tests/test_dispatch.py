"""ops/dispatch.py picks each algorithm's core by platform; the compile
cache helper; the flax-free soft model; and the GPU kernel compiled on a
card (skipped without one)."""

import os
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chaq_sdfgen.ops import dispatch

PKG = pathlib.Path(__file__).resolve().parents[1] / "chaq_sdfgen"


@pytest.mark.parametrize("algorithm,want", [
    ("exact", dispatch.TRITON),
    ("exact_full", dispatch.TRITON),
    ("brute", dispatch.XLA),
    ("jfa", dispatch.XLA),
    ("soft", dispatch.XLA),
])
def test_gpu_cores(algorithm, want):
    assert dispatch.core(algorithm, "gpu") == want


@pytest.mark.parametrize("algorithm", dispatch.ALGORITHMS)
def test_cpu_takes_xla_core(algorithm):
    assert dispatch.core(algorithm, "cpu") == dispatch.XLA
    assert dispatch.core(algorithm) == dispatch.XLA  # the tests' backend


@pytest.mark.parametrize("platform", ["METAL", "rocm", "neuron"])
def test_unknown_platform_raises(platform):
    with pytest.raises(dispatch.UnsupportedPlatform):
        dispatch.core("exact", platform)


def test_unknown_algorithm_raises():
    with pytest.raises(ValueError):
        dispatch.core("fh", "cpu")


def test_platform_of():
    assert dispatch.platform_of(jnp.ones(3)) == "cpu"
    assert dispatch.platform_of(np.ones(3)) == jax.default_backend()
    assert dispatch.platform_of() == jax.default_backend()
    dev = jax.devices()[1]
    assert dispatch.platform_of(jax.device_put(jnp.ones(3), dev)) == dev.platform


def test_gpu_core_never_interprets(monkeypatch):
    """On the GPU the kernel is called compiled: nothing passes interpret."""
    from chaq_sdfgen.models import sdf_model
    from chaq_sdfgen.ops import edt_triton

    calls = []

    def fake(b, spread, asymmetric=False, band=None, interpret=False):
        calls.append(interpret)
        return jnp.zeros(b.shape, jnp.uint8)

    monkeypatch.setattr(edt_triton, "sdf_bytes", fake)
    b = jnp.zeros((13, 29), bool)  # a shape no other test traces
    sdf_model.hard_sdf_exact_from_bool(b, 3, core=dispatch.TRITON)
    assert calls == [False]


def test_no_platform_checks_or_interpreter_outside_dispatch():
    """One module decides the platform; no package code turns on the
    interpreter, and Pallas is imported only for its Triton backend."""
    for path in PKG.rglob("*.py"):
        src = path.read_text()
        assert "interpret=True" not in src, path
        backends = re.findall(r"from jax\.experimental\.pallas import (\w+)", src)
        assert set(backends) <= {"triton"}, (path, backends)
        if path.name != "dispatch.py":
            assert "default_backend" not in src, path


@pytest.mark.parametrize("env", [None, "given"])
def test_compile_cache_dir(monkeypatch, tmp_path, env):
    from chaq_sdfgen.utils import cache

    calls = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append((k, v)))
    if env is None:
        monkeypatch.delenv(cache.ENV, raising=False)
        assert cache.enable_compile_cache() == cache.DEFAULT_DIR
        assert calls == [("jax_compilation_cache_dir", cache.DEFAULT_DIR)]
        assert cache.DEFAULT_DIR == os.path.join(
            str(PKG.parent), ".jax_cache"
        )
    else:
        monkeypatch.setenv(cache.ENV, str(tmp_path))
        assert cache.enable_compile_cache() == str(tmp_path)
        assert calls == []  # JAX reads the variable itself


def test_soft_model_params_are_a_plain_dict():
    from chaq_sdfgen.config import SoftConfig
    from chaq_sdfgen.models.soft_model import SoftSDFModel

    model = SoftSDFModel(spread=4, soft=SoftConfig(tau=3.0))
    params = model.init(jax.random.key(0), None)
    assert sorted(params) == ["channel_mix", "log_tau", "threshold_bias"]
    np.testing.assert_allclose(float(jnp.exp(params["log_tau"])), 3.0, rtol=1e-6)
    img = jnp.asarray(np.random.default_rng(0).random((16, 16, 2)) * 255, jnp.float32)
    out = model.apply(params, img)
    assert out.shape == (16, 16) and bool(jnp.isfinite(out).all())
    grads = jax.grad(lambda p: jnp.sum(model.apply(p, img) ** 2))(params)
    assert set(grads) == set(params)
    assert all(bool(jnp.isfinite(g).all()) for g in grads.values())


@pytest.mark.gpu
@pytest.mark.parametrize("spread", [5, 300])
def test_kernel_compiled_on_gpu_matches_xla(gpu_device, spread):
    """The kernel as compiled for the card, against the XLA core."""
    from chaq_sdfgen.models.sdf_model import hard_sdf_exact_from_bool

    rng = np.random.default_rng(spread)
    b = jax.device_put(jnp.asarray(rng.random((100, 300)) < 0.05), gpu_device)
    got = hard_sdf_exact_from_bool(b, spread, core=dispatch.TRITON)
    want = hard_sdf_exact_from_bool(b, spread, core=dispatch.XLA)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
