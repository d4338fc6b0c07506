"""Batched atlas pipeline + distributed helpers (config 5 logic on the
virtual CPU mesh)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from chaq_sdfgen.config import SdfConfig
from chaq_sdfgen.models.atlas import atlas_sdf
from chaq_sdfgen.models.sdf_model import hard_sdf_exact
from chaq_sdfgen.parallel import mesh as meshlib
from chaq_sdfgen.parallel.distributed import check_mesh, global_mesh


from conftest import needs_devices

def _stack(rng, n, h, w):
    imgs = np.zeros((n, h, w, 2), dtype=np.uint8)
    imgs[..., 1] = np.where(rng.random((n, h, w)) < 0.4, 255, 0)
    imgs[..., 0] = 128
    return imgs


def test_atlas_sharded_matches_single_chip():
    rng = np.random.default_rng(0)
    imgs = _stack(rng, 4, 32, 24)
    cfg = SdfConfig(spread=6)
    needs_devices(8)
    mesh = meshlib.make_mesh((2, 4), ("data", "y"))
    got = np.asarray(atlas_sdf(jnp.asarray(imgs), cfg, mesh))
    for i in range(4):
        want = np.asarray(hard_sdf_exact(jnp.asarray(imgs[i]), spread=6, core="xla"))
        np.testing.assert_array_equal(got[i], want)


def test_atlas_single_chip_batched():
    rng = np.random.default_rng(1)
    imgs = _stack(rng, 2, 16, 16)
    got = np.asarray(atlas_sdf(jnp.asarray(imgs), SdfConfig(spread=4)))
    assert got.shape == (2, 16, 16)


def test_atlas_rejects_bad_shapes():
    with pytest.raises(ValueError):
        atlas_sdf(jnp.zeros((4, 8, 8)), SdfConfig())


def test_check_mesh_errors():
    needs_devices(8)
    mesh = meshlib.make_mesh((2, 4), ("data", "y"))
    check_mesh(mesh, batch=4, height=32)
    with pytest.raises(ValueError):
        check_mesh(mesh, batch=3, height=32)
    with pytest.raises(ValueError):
        check_mesh(mesh, batch=4, height=30)


def test_two_process_dcn_atlas_bitwise():
    """Real jax.distributed bring-up: 2 processes x 4 virtual CPU devices,
    global ('data', 'y') mesh, one sharded atlas step, every process's
    addressable shards bitwise-equal to the single-process reference
    (exercises distributed.initialize / global_mesh multi-process paths)."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    # workers get their platform and device count fixed at spawn
    env["PYTHONPATH"] = root
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    worker = os.path.join(root, "tests", "dcn_worker.py")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), "2", str(port)],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
            env=env,
        )
        for pid in range(2)
    ]
    outs = []
    for pid, p in enumerate(procs):
        try:
            out, errout = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((pid, p.returncode, out, errout))
    for pid, rc, out, errout in outs:
        assert rc == 0, f"worker {pid} rc={rc}\nstdout:\n{out}\nstderr:\n{errout}"
        assert f"DCN_OK p{pid}" in out, (out, errout)


def test_global_mesh_single_host():
    needs_devices(8)
    m = global_mesh(y_per_host=4)
    assert dict(zip(m.axis_names, m.devices.shape)) == {"data": 2, "y": 4}
    m2 = global_mesh()
    assert m2.devices.size == len(jax.devices())


def test_atlas_sharding_config():
    """atlas_sdf accepts a ShardingConfig in place of a prebuilt mesh
    (the config layer drives the parallel tier)."""
    from chaq_sdfgen.config import ShardingConfig

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    rng = np.random.default_rng(3)
    imgs = (rng.random((4, 32, 24, 2)) * 255).astype(np.uint8)
    sc = ShardingConfig(
        mesh_shape=(2, 4), axis_names=("data", "y"), data_axis="data"
    )
    got = np.asarray(atlas_sdf(jnp.asarray(imgs), SdfConfig(spread=6), sharding=sc))
    want = np.asarray(atlas_sdf(jnp.asarray(imgs), SdfConfig(spread=6)))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        atlas_sdf(jnp.asarray(imgs), SdfConfig(), mesh=sc.build_mesh(), sharding=sc)
