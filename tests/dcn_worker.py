"""Worker process for the 2-process DCN (multi-host) test harness.

Run as:  python tests/dcn_worker.py <process_id> <num_processes> <port>

Each process brings up jax.distributed against a local coordinator with 4
virtual CPU devices (SURVEY.md §4: "multi-host collectives get a
fake-backend test"), builds the global ('data', 'y') mesh, runs one
batched atlas step sharded batch-over-processes / rows-over-devices, and
checks its addressable output shards bitwise against the single-process
reference.
"""

import os
import sys

pid = int(sys.argv[1])
nproc = int(sys.argv[2])
port = sys.argv[3]

# platform/device-count env (JAX_PLATFORMS=cpu, XLA_FLAGS
# --xla_force_host_platform_device_count=4) is set by the spawner
assert os.environ.get("JAX_PLATFORMS") == "cpu", "spawn with JAX_PLATFORMS=cpu"

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from chaq_sdfgen.config import SdfConfig  # noqa: E402
from chaq_sdfgen.models.atlas import atlas_sdf  # noqa: E402
from chaq_sdfgen.models.sdf_model import hard_sdf_exact  # noqa: E402
from chaq_sdfgen.parallel import distributed  # noqa: E402


def main():
    distributed.initialize(f"localhost:{port}", nproc, pid)
    assert jax.process_count() == nproc, jax.process_count()
    assert jax.device_count() == 4 * nproc, jax.device_count()
    assert jax.local_device_count() == 4

    mesh = distributed.global_mesh()  # ('data', 'y') = (nproc, 4)
    axes = dict(zip(mesh.axis_names, mesh.devices.shape))
    assert axes == {"data": nproc, "y": 4}, axes

    # identical global input on every process (seeded)
    rng = np.random.default_rng(42)
    n, h, w = 2 * nproc, 32, 24
    imgs = np.zeros((n, h, w, 2), dtype=np.uint8)
    imgs[..., 1] = np.where(rng.random((n, h, w)) < 0.4, 255, 0)
    imgs[..., 0] = 128

    # place as a global array: batch over hosts (DCN), rows over chips (ICI)
    gspec = NamedSharding(mesh, P("data", "y", None, None))
    imgs_g = jax.device_put(imgs, gspec)

    cfg = SdfConfig(spread=6)
    out = atlas_sdf(imgs_g, cfg, mesh)

    # single-process reference, computed redundantly on every host
    want = np.stack(
        [
            np.asarray(hard_sdf_exact(jnp.asarray(imgs[i]), spread=6, core="xla"))
            for i in range(n)
        ]
    )
    for shard in out.addressable_shards:
        got = np.asarray(shard.data)
        np.testing.assert_array_equal(got, want[shard.index])

    print(f"DCN_OK p{pid}", flush=True)
    # proper shutdown barrier: if the leader (which hosts the coordination
    # service) just exits, peers still polling it abort with UNAVAILABLE
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
    os._exit(0)
