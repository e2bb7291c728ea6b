"""Multi-chip sharding of the genotype matrix over a device mesh.

The sample-column axis is the natural sharding seam (the device-mesh generalization
of the reference's multi-database composition, bgt.c:829-842): each device
holds a column slice of the packed planes; per-site/per-group counts are
local masked popcounts followed by a ``psum`` over the sample axis, and
genotype output gathers column slices with an ``all_gather`` only when GT
emission is requested.  Site batches stream along the (optional) data
axis.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

shard_map = jax.shard_map

from ..ops import counts as counts_ops

SAMPLE_AXIS = "s"
ROW_AXIS = "r"  # site-batch data axis (SURVEY §2 parallelism inventory)


def make_mesh(devices=None, axis: str = SAMPLE_AXIS) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def make_mesh2(n_rows_axis: int, devices=None) -> Mesh:
    """2-axis (site-batch x sample-column) mesh: rows shard along 'r',
    columns along 's'.  Counts psum over 's' only (each row block's counts
    stay with its row shard); GT gathers ride 's' within a row block."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    assert n % n_rows_axis == 0, (n, n_rows_axis)
    return Mesh(devices.reshape(n_rows_axis, n // n_rows_axis),
                (ROW_AXIS, SAMPLE_AXIS))


def pad_words_for_mesh(n_words: int, n_dev: int) -> int:
    return (n_words + n_dev - 1) // n_dev * n_dev


def shard_planes(mesh: Mesh, plane0: np.ndarray, plane1: np.ndarray,
                 masks: np.ndarray):
    """Place planes and masks on the mesh, sharded along the word axis."""
    n_dev = mesh.devices.size
    words = pad_words_for_mesh(plane0.shape[1], n_dev)
    pad = words - plane0.shape[1]
    if pad:
        plane0 = np.pad(plane0, ((0, 0), (0, pad)))
        plane1 = np.pad(plane1, ((0, 0), (0, pad)))
        masks = np.pad(masks, ((0, 0), (0, pad)))
    sh = NamedSharding(mesh, P(None, SAMPLE_AXIS))
    return (jax.device_put(plane0, sh), jax.device_put(plane1, sh),
            jax.device_put(masks, sh))


def sharded_count_fn(mesh: Mesh):
    """jitted (p0, p1, masks) -> (rows, groups, 4) with psum over columns."""

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(None, SAMPLE_AXIS), P(None, SAMPLE_AXIS), P(None, SAMPLE_AXIS)),
        out_specs=P(None),
    )
    def _counts(p0, p1, masks):
        local = counts_ops.count_codes(p0, p1, masks)
        return jax.lax.psum(local, SAMPLE_AXIS)

    return jax.jit(_counts)


def sharded_count_range_fn(mesh: Mesh):
    """(p0, p1, masks, start, length) over device-resident sharded planes:
    row-slice locally, masked popcounts, psum over the sample axis.
    Compiled once per distinct (bucketed) length."""
    cache: dict = {}

    def call(p0, p1, masks, start: int, length: int):
        fn = cache.get(length)
        if fn is None:
            def _counts(p0, p1, masks, start):
                s0 = jax.lax.dynamic_slice_in_dim(p0, start, length, axis=0)
                s1 = jax.lax.dynamic_slice_in_dim(p1, start, length, axis=0)
                local = counts_ops.count_codes(s0, s1, masks)
                return jax.lax.psum(local, SAMPLE_AXIS)

            fn = jax.jit(shard_map(
                _counts, mesh=mesh,
                in_specs=(P(None, SAMPLE_AXIS), P(None, SAMPLE_AXIS),
                          P(None, SAMPLE_AXIS), P()),
                out_specs=P(None), check_vma=False,
            ))
            cache[length] = fn
        return fn(p0, p1, masks, jnp.int32(start))

    return call


def shard_planes2(mesh: Mesh, plane0: np.ndarray, plane1: np.ndarray,
                  masks: np.ndarray):
    """Place planes on a 2-axis mesh: rows over 'r', word-columns over 's';
    masks replicate along 'r' and shard along 's'.  Row/column counts pad
    to the axis sizes."""
    r, s = mesh.shape[ROW_AXIS], mesh.shape[SAMPLE_AXIS]
    words = pad_words_for_mesh(plane0.shape[1], s)
    rows = (plane0.shape[0] + r - 1) // r * r
    pad_c = words - plane0.shape[1]
    pad_r = rows - plane0.shape[0]
    if pad_c or pad_r:
        plane0 = np.pad(plane0, ((0, pad_r), (0, pad_c)))
        plane1 = np.pad(plane1, ((0, pad_r), (0, pad_c)))
    if pad_c:
        masks = np.pad(masks, ((0, 0), (0, pad_c)))
    psh = NamedSharding(mesh, P(ROW_AXIS, SAMPLE_AXIS))
    msh = NamedSharding(mesh, P(None, SAMPLE_AXIS))
    return (jax.device_put(plane0, psh), jax.device_put(plane1, psh),
            jax.device_put(masks, msh))


def sharded_count2_fn(mesh: Mesh):
    """jitted (p0, p1, masks) -> (rows, groups, 4) over a 2-axis mesh:
    each (row-block, column-block) device computes local masked popcounts,
    the psum rides the sample axis only, and the result stays row-sharded
    along 'r' (no gather until the host reads it back)."""

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(ROW_AXIS, SAMPLE_AXIS), P(ROW_AXIS, SAMPLE_AXIS),
                  P(None, SAMPLE_AXIS)),
        out_specs=P(ROW_AXIS, None, None), check_vma=False,
    )
    def _counts(p0, p1, masks):
        local = counts_ops.count_codes(p0, p1, masks)
        return jax.lax.psum(local, SAMPLE_AXIS)

    return jax.jit(_counts)


def sharded_pairs_rows_fn(mesh: Mesh):
    """(p0, p1, rows) -> (len(rows), words*16) uint8 diploid GT pair indices
    (code0*4 + code1), replicated on every host.

    The production caller behind GT-emitting queries on ``.gtc.shard``
    stores: each device decodes its own column slice for the requested rows,
    an ``all_gather`` over the sample axis reassembles the full genotype row
    (the collective replacing the reference's in-process memcpy merge,
    bgt.c:829-842), and the pair indices are formed on device so the
    readback is one byte per sample per site.  Compiled once per row-count
    bucket; ``rows`` is a replicated int32 index vector (pad to a bucket
    with repeats of row 0 and slice the result)."""
    cache: dict = {}

    def call(p0, p1, rows_idx):
        n = int(rows_idx.shape[0])
        fn = cache.get(n)
        if fn is None:
            def _pairs(p0, p1, rows):
                l0 = jnp.take(p0, rows, axis=0)
                l1 = jnp.take(p1, rows, axis=0)
                codes = counts_ops.decode_codes(l0, l1)
                full = jax.lax.all_gather(codes, SAMPLE_AXIS, axis=1,
                                          tiled=True)
                return (full[:, 0::2] << 2) | full[:, 1::2]

            fn = jax.jit(shard_map(
                _pairs, mesh=mesh,
                in_specs=(P(None, SAMPLE_AXIS), P(None, SAMPLE_AXIS), P()),
                out_specs=P(None), check_vma=False,
            ))
            cache[n] = fn
        return fn(p0, p1, rows_idx)

    return call


def sharded_pairs_rows2_fn(mesh: Mesh):
    """2-axis-mesh GT pair gather: rows sharded over 'r', columns over 's'.

    Each (row-block, column-block) device contributes its rows of the
    requested (replicated) row-id vector — rows outside its block as zeros
    — a ``psum`` over 'r' assembles the selected rows on every column
    shard, then the usual ``all_gather`` over 's' reassembles full
    genotype rows.  Compiled once per row-count bucket."""
    cache: dict = {}

    def call(p0, p1, rows_idx):
        n = int(rows_idx.shape[0])
        fn = cache.get(n)
        if fn is None:
            def _pairs(p0, p1, rows):
                block = p0.shape[0]
                r_idx = jax.lax.axis_index(ROW_AXIS)
                loc = rows - r_idx * block
                valid = (loc >= 0) & (loc < block)
                locc = jnp.clip(loc, 0, block - 1)
                l0 = jnp.where(valid[:, None], jnp.take(p0, locc, axis=0), 0)
                l1 = jnp.where(valid[:, None], jnp.take(p1, locc, axis=0), 0)
                l0 = jax.lax.psum(l0, ROW_AXIS)
                l1 = jax.lax.psum(l1, ROW_AXIS)
                codes = counts_ops.decode_codes(l0, l1)
                full = jax.lax.all_gather(codes, SAMPLE_AXIS, axis=1,
                                          tiled=True)
                return (full[:, 0::2] << 2) | full[:, 1::2]

            fn = jax.jit(shard_map(
                _pairs, mesh=mesh,
                in_specs=(P(ROW_AXIS, SAMPLE_AXIS), P(ROW_AXIS, SAMPLE_AXIS),
                          P()),
                out_specs=P(None), check_vma=False,
            ))
            cache[n] = fn
        return fn(p0, p1, rows_idx)

    return call


def sharded_gather_codes_fn(mesh: Mesh):
    """jitted (p0, p1) -> (rows, words*32) uint8 codes, all-gathered."""

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(None, SAMPLE_AXIS), P(None, SAMPLE_AXIS)),
        out_specs=P(None), check_vma=False,
    )
    def _codes(p0, p1):
        local = counts_ops.decode_codes(p0, p1)
        return jax.lax.all_gather(local, SAMPLE_AXIS, axis=1, tiled=True)

    return jax.jit(_codes)
