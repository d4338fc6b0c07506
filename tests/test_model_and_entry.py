"""SoftSDFModel training + driver entry points (dryrun_multichip runs the
full sharded train step on the 8-device CPU mesh)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp


def test_soft_model_train_step_reduces_loss():
    from chaq_sdfgen.config import SoftConfig
    from chaq_sdfgen.models.soft_model import (
        SoftSDFModel,
        create_train_state,
        make_train_step,
    )
    from chaq_sdfgen.ops import edt, merge

    rng = np.random.default_rng(0)
    # continuous gray values so threshold gradients are non-degenerate
    gray = (rng.random((2, 24, 24)) * 255).astype(np.float32)
    # shape signal in the alpha channel (the reference's default test
    # channel and the model's initial channel_mix preference)
    img2ch = np.stack([np.full_like(gray, 255.0), gray], axis=-1)
    b = gray > 127
    # target: the hard signed field
    d_in, d_out = edt.dual_edt_banded(jnp.asarray(b), 8)
    target = merge.signed_merge(d_out, d_in)

    model = SoftSDFModel(spread=6, soft=SoftConfig(tau=20.0, temperature=1.0))
    params, opt_state, tx = create_train_state(model, jnp.asarray(img2ch), lr=5e-2)
    step = jax.jit(make_train_step(model, tx))
    losses = []
    for _ in range(5):
        params, opt_state, loss = step(params, opt_state, jnp.asarray(img2ch), target)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_entry_compiles_single_chip():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    lowered = jax.jit(fn).lower(*args)
    compiled = lowered.compile()
    assert compiled is not None


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_multichip(n):
    from conftest import needs_devices

    needs_devices(n)
    import __graft_entry__ as ge

    ge.dryrun_multichip(n)


@pytest.mark.slow
def test_dryrun_multichip_after_backend_preinit():
    """A caller may run entry() (initializing a 1-device backend) before
    dryrun_multichip in the SAME process. XLA_FLAGS force-count and jax_num_cpu_devices are ignored
    once a client exists, so dryrun must tear backends down and re-init
    as an n-device CPU mesh (jax.extend.backend.clear_backends path)."""
    import os
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    code = (
        "import jax, jax.numpy as jnp\n"
        "jnp.ones(4).sum()\n"  # force 1-device backend init (no force flags)
        "assert len(jax.devices()) < 8, 'precondition: backend must start small'\n"
        "import __graft_entry__ as g\n"
        "g.dryrun_multichip(8)\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        capture_output=True, text=True, timeout=540,
    )
    assert r.returncode == 0, f"stdout={r.stdout}\nstderr={r.stderr}"
    assert "dryrun_multichip(8)" in r.stdout


def test_sharding_config_validation_and_mesh():
    import pytest as _pytest

    from chaq_sdfgen.config import ShardingConfig

    with _pytest.raises(ValueError):
        ShardingConfig(mesh_shape=(2, 2), axis_names=("y",))
    with _pytest.raises(TypeError):  # the halo is always lax.ppermute
        ShardingConfig(halo_impl="ppermute")
    with _pytest.raises(ValueError):
        ShardingConfig(data_axis="data")
    sc = ShardingConfig(mesh_shape=(2, 2), axis_names=("data", "y"),
                        data_axis="data")
    assert sc.y_axis == "y" and sc.x_axis is None
    sc2 = ShardingConfig(mesh_shape=(2, 4), axis_names=("y", "x"))
    assert sc2.y_axis == "y" and sc2.x_axis == "x"


def test_generator_sharded_exact_matches_unsharded():
    import jax

    if len(jax.devices()) < 4:
        import pytest as _pytest

        _pytest.skip("needs 4 devices")
    import numpy as np

    from chaq_sdfgen.config import SdfConfig, ShardingConfig
    from chaq_sdfgen.models.sdf_model import SDFGenerator

    rng = np.random.default_rng(0)
    img = np.zeros((64, 48, 2), np.uint8)
    img[..., 1] = np.where(rng.random((64, 48)) < 0.3, 255, 0)
    cfg = SdfConfig(spread=9)
    want = np.asarray(SDFGenerator(cfg).generate(img))
    sc = ShardingConfig(mesh_shape=(4,), axis_names=("y",))
    got = np.asarray(SDFGenerator(cfg, sharding=sc).generate(img))
    np.testing.assert_array_equal(got, want)


def test_generator_sharded_soft_field():
    import jax

    if len(jax.devices()) < 2:
        import pytest as _pytest

        _pytest.skip("needs 2 devices")
    import numpy as np

    from chaq_sdfgen.config import SdfConfig, ShardingConfig, SoftConfig
    from chaq_sdfgen.models.sdf_model import SDFGenerator

    img = np.zeros((32, 32, 2), np.uint8)
    img[10:22, 10:22, 1] = 255
    cfg = SdfConfig(spread=6)
    soft = SoftConfig()
    want = np.asarray(SDFGenerator(cfg, soft=soft).generate_field(img))
    sc = ShardingConfig(mesh_shape=(2,), axis_names=("y",))
    got = np.asarray(
        SDFGenerator(cfg, soft=soft, sharding=sc).generate_field(img)
    )
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
