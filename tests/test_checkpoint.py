"""Checkpoint/resume round-trip (orbax) and intermediate grid dumps."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from chaq_sdfgen.config import SoftConfig
from chaq_sdfgen.models import checkpoint as ckpt
from chaq_sdfgen.models.soft_model import SoftSDFModel, create_train_state, make_train_step


def test_train_state_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    gray = (rng.random((2, 16, 16)) * 255).astype(np.float32)
    img2ch = np.stack([np.full_like(gray, 255.0), gray], axis=-1)
    target = jnp.asarray(rng.standard_normal((2, 16, 16)).astype(np.float32))

    model = SoftSDFModel(spread=4, soft=SoftConfig(tau=20.0, temperature=1.0))
    params, opt_state, tx = create_train_state(model, jnp.asarray(img2ch), lr=1e-2)
    step = jax.jit(make_train_step(model, tx))
    params, opt_state, loss1 = step(params, opt_state, jnp.asarray(img2ch), target)

    path = str(tmp_path / "ckpt")
    ckpt.save_train_state(path, params, opt_state, step=1)
    p2, o2, s2 = ckpt.restore_train_state(path, like_params=params, like_opt=opt_state)
    assert s2 == 1
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(p2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # resumed training continues identically
    _, _, loss_resumed = step(p2, o2, jnp.asarray(img2ch), target)
    _, _, loss_orig = step(params, opt_state, jnp.asarray(img2ch), target)
    np.testing.assert_allclose(float(loss_resumed), float(loss_orig), rtol=1e-6)


def test_dump_grid(tmp_path):
    arr = np.arange(12.0).reshape(3, 4)
    fp = ckpt.dump_grid(str(tmp_path / "grids"), "edt_inside", arr)
    np.testing.assert_array_equal(np.load(fp), arr)


def test_train_state_restore_without_template(tmp_path):
    """No-template restore: leaves come back as device arrays with the
    stored dtypes/values and resumed training matches the templated path."""
    rng = np.random.default_rng(1)
    gray = (rng.random((2, 16, 16)) * 255).astype(np.float32)
    img2ch = np.stack([np.full_like(gray, 255.0), gray], axis=-1)
    target = jnp.asarray(rng.standard_normal((2, 16, 16)).astype(np.float32))

    model = SoftSDFModel(spread=4, soft=SoftConfig(tau=20.0, temperature=1.0))
    params, opt_state, tx = create_train_state(model, jnp.asarray(img2ch), lr=1e-2)
    step = jax.jit(make_train_step(model, tx))
    params, opt_state, _ = step(params, opt_state, jnp.asarray(img2ch), target)

    path = str(tmp_path / "ckpt_nt")
    ckpt.save_train_state(path, params, opt_state, step=7)
    p2, o2, s2 = ckpt.restore_train_state(path)
    assert s2 == 7
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(p2)):
        assert isinstance(b, jax.Array)
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the restored state drives a train step exactly like the original
    _, _, loss_resumed = step(p2, o2, jnp.asarray(img2ch), target)
    _, _, loss_orig = step(params, opt_state, jnp.asarray(img2ch), target)
    np.testing.assert_allclose(float(loss_resumed), float(loss_orig), rtol=1e-6)


def test_restore_rejects_non_train_state(tmp_path):
    import orbax.checkpoint as ocp

    path = str(tmp_path / "bogus")
    ocp.PyTreeCheckpointer().save(path, {"something": np.zeros(3)})
    with pytest.raises(ValueError):
        ckpt.restore_train_state(path)
