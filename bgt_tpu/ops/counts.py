"""Device kernels: masked popcount genotype counting and code decode.

The hot reduction of every query — per-site counts of the four genotype
codes over the selected haplotype columns, overall and per sample group
(reference bgt.c:735-757) — formulated as bitwise ops + popcounts over the
packed planes:

    n1_0 = popcount(p0 & mask)        # code 1 or 3 (low bit set)
    n1_1 = popcount(p1 & mask)        # code 2 or 3 (high bit set)
    n11  = popcount(p0 & p1 & mask)   # code 3
    cnt1 = n1_0 - n11; cnt2 = n1_1 - n11; cnt3 = n11
    cnt0 = popcount(mask) - cnt1 - cnt2 - cnt3

AN = cnt0+cnt1+cnt3, AC1 = cnt1, AC2 = cnt3 (bgt.c:746-756).

Every kernel here is plain ``jax.numpy``/``lax`` that XLA compiles for the
device it finds.  On an H100 (400 W limit) the 1-mask count pass over a
150k x 2,048-word tile runs as fast as a bare popcount-reduce over the same
planes; a hand-written Pallas-Triton kernel was slower at 1, 2 and 32 masks
and was dropped (PERF.md; tools/probe_roofline.py re-measures).
"""

from __future__ import annotations

import functools
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

JAX_CACHE_DIR = Path(__file__).resolve().parents[2] / "build" / "jaxcache"


def _setup_compilation_cache() -> None:
    """Persistent XLA compilation cache, so a kernel compiles once per
    machine, not once per process.  Where ``JAX_COMPILATION_CACHE_DIR`` is
    set, JAX has already taken the directory from it and it is left alone;
    otherwise the cache lives at the fixed ``build/jaxcache`` of this
    checkout (the path is part of the cache key, so it must not move)."""
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        try:
            JAX_CACHE_DIR.mkdir(parents=True, exist_ok=True)
        except OSError:  # read-only checkout: run without a cache
            return
        jax.config.update("jax_compilation_cache_dir", str(JAX_CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.2)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


_setup_compilation_cache()


@jax.jit
def count_codes(p0: jax.Array, p1: jax.Array, masks: jax.Array) -> jax.Array:
    """Per-row, per-group genotype-code counts.

    p0, p1: (rows, words) uint32 packed planes.
    masks:  (groups, words) uint32 column masks.
    returns (rows, groups, 4) int32: counts of codes 0..3.

    Groups are unrolled statically (<=33) so no (rows, groups, words)
    intermediate is ever materialized.  Shapes are static under tracing,
    so this also runs inside the shard_map bodies of parallel/mesh.py.
    """
    pc = jax.lax.population_count
    both = p0 & p1
    per_group = []
    for gi in range(masks.shape[0]):
        m = masks[gi][None, :]
        n10 = pc(p0 & m).sum(axis=-1, dtype=jnp.int32)
        n11 = pc(p1 & m).sum(axis=-1, dtype=jnp.int32)
        nb = pc(both & m).sum(axis=-1, dtype=jnp.int32)
        tot = pc(masks[gi]).sum(dtype=jnp.int32)
        cnt1 = n10 - nb
        cnt2 = n11 - nb
        cnt0 = tot - cnt1 - cnt2 - nb
        per_group.append(jnp.stack([cnt0, cnt1, cnt2, nb], axis=-1))
    return jnp.stack(per_group, axis=1)


@functools.partial(jax.jit, static_argnames=("length",))
def count_codes_range(p0, p1, masks, start, length: int):
    """count_codes over a device-resident row slice [start, start+length)."""
    s0 = jax.lax.dynamic_slice_in_dim(p0, start, length, axis=0)
    s1 = jax.lax.dynamic_slice_in_dim(p1, start, length, axis=0)
    return count_codes(s0, s1, masks)


@functools.partial(jax.jit, static_argnames=("length", "n_out"))
def gather_codes_range(p0, p1, cols, start, length: int, n_out: int):
    """Decode + column-subset a device-resident row slice."""
    s0 = jax.lax.dynamic_slice_in_dim(p0, start, length, axis=0)
    s1 = jax.lax.dynamic_slice_in_dim(p1, start, length, axis=0)
    codes = decode_codes(s0, s1)
    return jnp.take(codes, cols, axis=1)


@functools.partial(jax.jit, static_argnames=("length",))
def gt_pair_idx_range(p0, p1, cols, start, length: int):
    """Diploid GT cell indices for a row slice: code(hap0)*4+code(hap1).

    The full decode + column subset + pairing runs on device; the readback
    is one uint8 per sample per site (the direct input to the 16-entry text
    cell LUT).
    """
    s0 = jax.lax.dynamic_slice_in_dim(p0, start, length, axis=0)
    s1 = jax.lax.dynamic_slice_in_dim(p1, start, length, axis=0)
    codes = decode_codes(s0, s1)
    sub = jnp.take(codes, cols, axis=1)
    return (sub[:, 0::2] << 2) | sub[:, 1::2]


def site_stats(counts: jax.Array) -> dict:
    """AN/AC vectors from (rows, groups, 4) counts (bgtm_cal_info)."""
    tot = counts.sum(axis=1)  # (rows, 4)
    out = {
        "AN": tot[:, 0] + tot[:, 1] + tot[:, 3],
        "AC": tot[:, 1],
        "AC_M": tot[:, 3],
    }
    n_groups = counts.shape[1]
    if n_groups > 1:
        out["GAN"] = counts[:, :, 0] + counts[:, :, 1] + counts[:, :, 3]
        out["GAC"] = counts[:, :, 1]
        out["GAC_M"] = counts[:, :, 3]
    return out


@jax.jit
def decode_codes(p0: jax.Array, p1: jax.Array) -> jax.Array:
    """(rows, words*32) uint8 genotype codes from packed planes."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    b0 = (p0[:, :, None] >> shifts[None, None, :]) & 1
    b1 = (p1[:, :, None] >> shifts[None, None, :]) & 1
    codes = (b1 << 1) | b0
    return codes.reshape(p0.shape[0], -1).astype(jnp.uint8)


@functools.partial(jax.jit, static_argnames=("n_out",))
def gather_codes(p0: jax.Array, p1: jax.Array, cols: jax.Array, n_out: int) -> jax.Array:
    """Decode and column-subset in one jit: (rows, n_out) uint8 codes."""
    codes = decode_codes(p0, p1)
    return jnp.take(codes, cols, axis=1)

