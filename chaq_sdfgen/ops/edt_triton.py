"""Pass 2 of the exact EDT as one Pallas kernel for NVIDIA GPUs (Triton).

The XLA core (``ops/edt.py``) evaluates pass 2 as a loop of full-image
slice-add-min steps: every tap group reads and writes the whole
accumulator in device memory. This kernel keeps a tile of the result in
registers instead. Each program owns ``TM`` output rows by ``TN`` columns
of every field, reads the row distances of pass 1 (stored as u8, or u16
when the band does not fit a byte) once per tap from L1/L2, and writes
only the final bytes.

- The tap loop stops early: once ``k * k`` reaches the largest squared
  distance in the tile, no farther row can lower any pixel of it. Tiles
  near a boundary finish after a few taps whatever the band, so large
  spreads cost little more than small ones.
- Both fields of the hard pipeline (distance to the inside set and to the
  outside set) run in one program, followed by the correctly rounded
  sqrt, the signed merge and the byte remap (``ops/merge.py``).
- The full-range exact field uses the same loop on one field with a
  distance epilogue.

All arithmetic is on exact integers (squares < 2^31), so the result is
bitwise equal to the XLA core. Inputs are padded with ``band`` sentinel
rows on both sides and to whole tiles, so every load is in bounds and the
kernel needs no masks; the same code therefore runs in interpret mode.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from chaq_sdfgen.ops import merge
from chaq_sdfgen.ops.numerics import refined_sqrt

TM = 16  # output rows per program
TN = 128  # output columns per program
NUM_WARPS = 4


def storage_dtype(sentinel: int):
    """Narrowest unsigned type that holds row distances up to ``sentinel``."""
    if sentinel <= 255:
        return jnp.uint8
    if sentinel <= 65535:
        return jnp.uint16
    raise ValueError(f"row-distance sentinel {sentinel} does not fit 16 bits")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pad_rows(d: jnp.ndarray, band: int, sentinel: int) -> jnp.ndarray:
    """(N, H, W) row distances -> (N, band + Hp + band, Wp) in the storage
    type, with ``sentinel`` in every row and column outside the image."""
    _, h, w = d.shape
    hp, wp = _round_up(h, TM), _round_up(w, TN)
    d = d.astype(storage_dtype(sentinel))
    return jnp.pad(
        d, ((0, 0), (band, band + hp - h), (0, wp - w)), constant_values=sentinel
    )


def _pass2_kernel(*refs, band, h, w, epilogue):
    *in_refs, o_ref = refs
    n, i, j = pl.program_id(0), pl.program_id(1), pl.program_id(2)
    r0 = i * TM  # first output row; its centre tap is input row r0 + band
    c0 = pl.multiple_of(j * TN, TN)
    cols = pl.ds(c0, TN)

    def sq(ref, start):
        d = ref[n, pl.ds(start, TM), cols].astype(jnp.int32)
        return d * d

    rows_i = r0 + lax.broadcasted_iota(jnp.int32, (TM, TN), 0)
    cols_i = c0 + lax.broadcasted_iota(jnp.int32, (TM, TN), 1)
    live = jnp.logical_and(rows_i < h, cols_i < w)

    def tile_max(accs):
        m = jnp.int32(0)
        for a in accs:
            # Triton reduces one axis at a time
            m = jnp.maximum(m, jnp.where(live, a, 0).max(axis=1).max(axis=0))
        return m

    def cond(carry):
        k, _, m = carry
        return jnp.logical_and(k <= band, k * k < m)

    def body(carry):
        k, accs, _ = carry
        kk = k * k
        accs = tuple(
            jnp.minimum(
                a, jnp.minimum(sq(ref, r0 + band - k), sq(ref, r0 + band + k)) + kk
            )
            for a, ref in zip(accs, in_refs)
        )
        return k + 1, accs, tile_max(accs)

    accs = tuple(sq(ref, r0 + band) for ref in in_refs)
    _, accs, _ = lax.while_loop(cond, body, (jnp.int32(1), accs, tile_max(accs)))
    o_ref[0] = epilogue(*accs)


def _pass2_call(inputs, h, w, band, epilogue, out_dtype, interpret):
    n, hext, wp = inputs[0].shape
    hp = hext - 2 * band
    kernel = functools.partial(
        _pass2_kernel, band=band, h=h, w=w, epilogue=epilogue
    )
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((n, hp, wp), out_dtype),
        grid=(n, hp // TM, wp // TN),
        out_specs=pl.BlockSpec((1, TM, TN), lambda b, i, j: (b, i, j)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="edt_pass2",
    )(*inputs)
    return out[:, :h, :w]


def _batched(fn, x):
    """Run ``fn`` on (N, H, W); any leading shape is flattened into N."""
    lead = x.shape[:-2]
    out = fn(x.reshape((-1,) + x.shape[-2:]))
    return out.reshape(lead + out.shape[-2:])


@functools.partial(
    jax.jit, static_argnames=("spread", "asymmetric", "band", "interpret")
)
def sdf_bytes(
    b: jnp.ndarray,
    spread: int,
    asymmetric: bool = False,
    band: int | None = None,
    interpret: bool = False,
) -> jnp.ndarray:
    """Hard EXACT pipeline from a thresholded grid: (..., H, W) bool ->
    uint8, byte-identical to the XLA core. Needs H >= 2 (a one-row image
    takes the reference's no-sqrt quirk, which only the XLA core has)."""
    from chaq_sdfgen.ops.edt import row_nearest

    band = band if band is not None else spread + 2
    sent = band + 1
    if b.shape[-2] < 2:
        raise ValueError("the kernel needs at least two rows")

    def epilogue(a_in, a_out):
        d_in = refined_sqrt(a_in.astype(jnp.float32))
        d_out = refined_sqrt(a_out.astype(jnp.float32))
        return merge.remap_to_byte(merge.signed_merge(d_out, d_in), spread, asymmetric)

    def run(bb):
        h, w = bb.shape[-2:]
        d_in = pad_rows(row_nearest(bb, sent), band, sent)
        d_out = pad_rows(row_nearest(jnp.logical_not(bb), sent), band, sent)
        return _pass2_call((d_in, d_out), h, w, band, epilogue, jnp.uint8, interpret)

    return _batched(run, b)


@functools.partial(jax.jit, static_argnames=("sat", "interpret"))
def distance_field(
    seeds: jnp.ndarray, sat: int, interpret: bool = False
) -> jnp.ndarray:
    """(..., H, W) bool -> f32 exact distance to the nearest True pixel,
    32768.0 where there is none. ``sat`` is the row-distance saturation
    (``edt.full_range_sat``)."""
    from chaq_sdfgen.ops.edt import NO_SEED, row_nearest

    band = max(seeds.shape[-2] - 1, 1)
    satsq = sat * sat

    def epilogue(a):
        dist = refined_sqrt(a.astype(jnp.float32))
        return jnp.where(a >= satsq, jnp.float32(NO_SEED), dist)

    def run(s):
        h, w = s.shape[-2:]
        d = pad_rows(row_nearest(s, sat), band, sat)
        return _pass2_call((d,), h, w, band, epilogue, jnp.float32, interpret)

    return _batched(run, seeds)
