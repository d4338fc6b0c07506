"""Multi-device sharding on the virtual 8-device CPU mesh: the sharded
pipelines must be bitwise identical to single-device, and gradients must
flow through the halo exchange (SURVEY.md §4)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from chaq_sdfgen.models.sdf_model import hard_sdf_exact_from_bool
from chaq_sdfgen.ops import softsdf
from chaq_sdfgen.parallel import mesh as meshlib
from chaq_sdfgen.parallel.sharded import sharded_hard_sdf_bytes, sharded_soft_sdf_field


from conftest import needs_devices

def _mesh1d(n):
    needs_devices(n)
    return meshlib.make_mesh((n,), ("y",))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_hard_bitwise_equal(n):
    rng = np.random.default_rng(n)
    b = rng.random((64, 40)) < 0.35
    mesh = _mesh1d(n)
    got = sharded_hard_sdf_bytes(jnp.asarray(b), 9, mesh)
    want = hard_sdf_exact_from_bool(jnp.asarray(b), 9, core="xla")
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_sharded_hard_band_larger_than_shard():
    # band (spread+2 = 20) spans several 8-row shards: the multi-hop halo
    # must gather blocks from beyond the nearest neighbour.
    rng = np.random.default_rng(0)
    b = rng.random((64, 32)) < 0.3
    mesh = _mesh1d(8)
    got = sharded_hard_sdf_bytes(jnp.asarray(b), 18, mesh)
    want = hard_sdf_exact_from_bool(jnp.asarray(b), 18, core="xla")
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_sharded_hard_batched_2d_mesh():
    rng = np.random.default_rng(1)
    b = rng.random((4, 32, 24)) < 0.4
    needs_devices(8)
    mesh = meshlib.make_mesh((2, 4), ("data", "y"))
    got = sharded_hard_sdf_bytes(jnp.asarray(b), 6, mesh, batch_axis="data")
    want = hard_sdf_exact_from_bool(jnp.asarray(b), 6, core="xla")
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.slow
def test_sharded_soft_matches_single_chip():
    rng = np.random.default_rng(2)
    gray = (rng.random((48, 32)) * 255).astype(np.float32)
    mesh = _mesh1d(4)
    got = np.asarray(
        sharded_soft_sdf_field(jnp.asarray(gray), 6, mesh, tau=2.0, temperature=1.0)
    )
    want = np.asarray(
        softsdf.soft_sdf_field_scan(jnp.asarray(gray), 6, tau=2.0, temperature=1.0)
    )
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.slow
def test_sharded_soft_gradient_flows_across_shards():
    rng = np.random.default_rng(3)
    gray = (rng.random((32, 16)) * 255).astype(np.float32)
    mesh = _mesh1d(4)
    w = jnp.asarray(rng.standard_normal((32, 16)).astype(np.float32))

    def loss_sharded(g):
        return jnp.vdot(sharded_soft_sdf_field(g, 5, mesh, tau=2.0, temperature=1.0), w)

    def loss_single(g):
        return jnp.vdot(softsdf.soft_sdf_field_scan(g, 5, tau=2.0, temperature=1.0), w)

    g1 = np.asarray(jax.grad(loss_sharded)(jnp.asarray(gray)))
    g2 = np.asarray(jax.grad(loss_single)(jnp.asarray(gray)))
    assert np.abs(g2).max() > 0
    np.testing.assert_allclose(g1, g2, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("n,spread", [(2, 6), (4, 6), (8, 8)])
def test_sharded_soft_scan_matches_single_chip(n, spread):
    """Undeclared range: each shard runs the scan cores with a band-row
    halo of the pass-1 field (multi-hop when band > the 8-row shards)."""
    rng = np.random.default_rng(21 + n)
    gray = (rng.random((64, 40)) * 255).astype(np.float32)
    mesh = _mesh1d(n)
    got = np.asarray(
        sharded_soft_sdf_field(jnp.asarray(gray), spread, mesh, tau=2.0, temperature=1.0)
    )
    want = np.asarray(
        softsdf.soft_sdf_field_scan(jnp.asarray(gray), spread, tau=2.0, temperature=1.0)
    )
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("gray_range", [None, (0.0, 255.0)])
def test_sharded_soft_test_above_invert(gray_range):
    """-n/invert semantics must reach the sharded soft path (both cores:
    the scan cores without a declared range, the cascade with one)."""
    from chaq_sdfgen.ops import soft_mxu

    rng = np.random.default_rng(24)
    gray = (rng.random((32, 24)) * 255).astype(np.float32)
    mesh = _mesh1d(4)
    got = np.asarray(
        sharded_soft_sdf_field(
            jnp.asarray(gray), 6, mesh, tau=2.0, temperature=1.0,
            test_above=False, gray_range=gray_range,
        )
    )
    if gray_range is None:
        want = softsdf.soft_sdf_field_scan(
            jnp.asarray(gray), 6, tau=2.0, temperature=1.0, test_above=False
        )
    else:
        want = soft_mxu.soft_sdf_field_mxu(
            jnp.asarray(gray), 8, 2.0, 1.0, 1e-6, test_above=False
        )
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=2e-5)


def test_row_sharding_placement():
    needs_devices(8)
    mesh = meshlib.make_mesh((2, 4), ("data", "y"))
    sh = meshlib.row_sharding(mesh, batch_axis="data")
    x = jax.device_put(jnp.zeros((2, 32, 8)), sh)
    assert x.sharding.spec == P("data", "y", None)


@pytest.mark.slow
@pytest.mark.parametrize("n", [2, 8])
def test_sharded_jfa_bitwise_equal(n):
    from chaq_sdfgen.ops import jfa
    from chaq_sdfgen.parallel.sharded import sharded_jfa_distance

    rng = np.random.default_rng(n)
    b = rng.random((64, 48)) < 0.15
    mesh = _mesh1d(n)
    got = np.asarray(sharded_jfa_distance(jnp.asarray(b), mesh))
    want = np.asarray(jfa.jfa_distance(jnp.asarray(b)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.slow
def test_sharded_jfa_stride_exceeds_shard():
    # 8 shards of 8 rows, strides up to 32 -> multi-hop state halos
    from chaq_sdfgen.ops import jfa
    from chaq_sdfgen.parallel.sharded import sharded_jfa_distance

    rng = np.random.default_rng(99)
    b = rng.random((64, 32)) < 0.02
    b[3, 5] = True
    mesh = _mesh1d(8)
    got = np.asarray(sharded_jfa_distance(jnp.asarray(b), mesh))
    want = np.asarray(jfa.jfa_distance(jnp.asarray(b)))
    np.testing.assert_array_equal(got, want)


def test_sharded_jfa_small_fast():
    """Fast-profile JFA sharding coverage (the exhaustive bitwise tests
    above are marked slow): 16x16, 2 shards, strides down from 8."""
    from chaq_sdfgen.ops import jfa
    from chaq_sdfgen.parallel.sharded import sharded_jfa_distance

    rng = np.random.default_rng(77)
    b = rng.random((16, 16)) < 0.2
    b[0, 3] = True
    mesh = _mesh1d(2)
    got = np.asarray(sharded_jfa_distance(jnp.asarray(b), mesh))
    want = np.asarray(jfa.jfa_distance(jnp.asarray(b)))
    np.testing.assert_array_equal(got, want)


def test_sharded_soft_mm_matches_single_chip_mm():
    """The collapsed two-einsum sharded split (K2-row pass-1-sum halo)
    must match the single-chip mm path (same math, CPU precision)."""
    from chaq_sdfgen.ops import soft_mxu

    rng = np.random.default_rng(81)
    gray = (rng.random((64, 40)) * 255).astype(np.float32)
    spread, band = 6, 8
    mesh = _mesh1d(4)
    got = np.asarray(
        sharded_soft_sdf_field(
            jnp.asarray(gray), spread, mesh, tau=2.0, temperature=1.0,
            gray_range=(0.0, 255.0),
        )
    )
    want = np.asarray(
        soft_mxu.soft_sdf_field_mxu(jnp.asarray(gray), band, 2.0, 1.0, 1e-6)
    )
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_sharded_soft_mm_gradient_matches_single_chip():
    from chaq_sdfgen.ops import soft_mxu

    rng = np.random.default_rng(82)
    gray = (rng.random((32, 24)) * 255).astype(np.float32)
    spread, band = 5, 7
    mesh = _mesh1d(4)
    w = jnp.asarray(rng.standard_normal((32, 24)).astype(np.float32))

    def loss_sharded(g):
        return jnp.vdot(
            sharded_soft_sdf_field(
                g, spread, mesh, tau=2.0, temperature=1.0,
                gray_range=(0.0, 255.0),
            ),
            w,
        )

    def loss_single(g):
        return jnp.vdot(
            soft_mxu.soft_sdf_field_mxu(g, band, 2.0, 1.0, 1e-6), w
        )

    g1 = np.asarray(jax.grad(loss_sharded)(jnp.asarray(gray)))
    g2 = np.asarray(jax.grad(loss_single)(jnp.asarray(gray)))
    assert np.abs(g2).max() > 0
    np.testing.assert_allclose(g1, g2, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", [2, 8])
def test_sharded_soft_mm_halo_spans_shards(n):
    """The cascade's K2-row halo of the pass-1 sum: with 8 shards of 8
    rows, K2 = 10 > 8 and the halo hops two shards."""
    from chaq_sdfgen.ops import soft_mxu

    rng = np.random.default_rng(90 + n)
    gray = (rng.random((64, 40)) * 255).astype(np.float32)
    mesh = _mesh1d(n)
    got = np.asarray(
        sharded_soft_sdf_field(
            jnp.asarray(gray), 14, mesh, tau=2.0, temperature=1.0,
            gray_range=(0.0, 255.0),
        )
    )
    want = np.asarray(soft_mxu.soft_sdf_field_mxu(jnp.asarray(gray), 16, 2.0, 1.0, 1e-6))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_sharded_hard_sparse_seed_across_seam_uncovered_tail():
    """A lone seed 56 rows below shard 0's seam, inside the spread, must
    reach shard 0 through the 66-row halo; each shard's early-exit tap
    loop (edt.band_min_ext) must not stop before it (distances beyond
    the spread are clamped by the remap and would hide a miss)."""
    b = np.zeros((224, 128), bool)
    b[112, 64] = True  # 56 rows below shard 0's bottom edge (row 55)
    mesh = _mesh1d(4)
    got = sharded_hard_sdf_bytes(jnp.asarray(b), 64, mesh)
    want = hard_sdf_exact_from_bool(jnp.asarray(b), 64, core="xla")
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("shape2d", [(2, 4), (4, 2)])
def test_sharded_jfa_2d_mesh_bitwise_equal(shape2d):
    """x-sharded JFA: 2-D ('y','x') tile mesh,
    bitwise vs single-chip — incl. strides exceeding the tile width
    (multi-hop col slabs through fetch_col_slab)."""
    from chaq_sdfgen.ops import jfa
    from chaq_sdfgen.parallel.sharded import sharded_jfa_distance

    rng = np.random.default_rng(sum(shape2d))
    b = rng.random((64, 48)) < 0.15
    needs_devices(shape2d[0] * shape2d[1])
    mesh = meshlib.make_mesh(shape2d, ("y", "x"))
    got = np.asarray(
        sharded_jfa_distance(jnp.asarray(b), mesh, x_axis="x")
    )
    want = np.asarray(jfa.jfa_distance(jnp.asarray(b)))
    np.testing.assert_array_equal(got, want)


def test_sharded_jfa_2d_sparse_corner_seed():
    # a single seed whose propagation must cross BOTH mesh axes,
    # including the diagonal (two-hop corner) route
    from chaq_sdfgen.ops import jfa
    from chaq_sdfgen.parallel.sharded import sharded_jfa_distance

    b = np.zeros((32, 32), bool)
    b[3, 2] = True
    needs_devices(8)
    mesh = meshlib.make_mesh((4, 2), ("y", "x"))
    got = np.asarray(sharded_jfa_distance(jnp.asarray(b), mesh, x_axis="x"))
    want = np.asarray(jfa.jfa_distance(jnp.asarray(b)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,spread", [(2, 300), (4, 70)])
def test_sharded_hard_wide_band(n, spread):
    """Bands wider than a shard (multi-hop halos) and beyond the u8 range
    of the single-device kernel: still bitwise equal to one device."""
    b = np.zeros((128, 96), bool)
    b[5, 9] = b[100, 90] = True
    mesh = _mesh1d(n)
    got = sharded_hard_sdf_bytes(jnp.asarray(b), spread, mesh)
    want = hard_sdf_exact_from_bool(jnp.asarray(b), spread, core="xla")
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
