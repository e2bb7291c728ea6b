"""Device-side PBWT decode: lax.scan over rows within a checkpoint block.

The reference decodes PBWT rows with a sequential run-walk per row
(pbc_dec_core / pbs_dec, reference pbwt.c:69-170): row k's bits are the
RLE-expanded transform permuted by S_k, and S_{k+1} is the stable partition
of S_k by those bits.  This module expresses that recurrence as a JAX scan
so decode can run on the device directly from RLE data in HBM:

    per row:  starts = exclusive_cumsum(run_lens)
              y = cumsum(scatter(starts, bit_transitions))      # rank-space bits
              a = scatter(S, y)                                  # original order
              S' = stable_partition(S, y)                        # via cumsums

Independent checkpoint blocks (every 2^shift rows) decode in parallel via
vmap/grid; within a block the scan is inherently sequential.

DESIGN NOTE — why the production path uses tiles instead.  Each scan step is
dominated by gathers/scatters of m-wide int vectors, which run far below
an accelerator's elementwise rate; the same data as pre-decoded
packed tiles (ops/tiles.py, built once by the native host codec at ~GB/s)
is scanned by the popcount kernels as a streaming pass.  The design
chooses the layout the device likes rather than forcing the CPU-optimal
encoding through it.  The scan
decoder remains the right tool when only RLE data fits in HBM and a full
decode of a narrow row range is needed; it is also the correctness oracle
for any future hand-written variant.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _rle_to_run_arrays(rle: bytes, max_runs: int):
    """Host-side: RLE bytes -> fixed-width (lens, bits) arrays."""
    v = np.frombuffer(rle, dtype=np.uint8).astype(np.int32)
    t = v >> 1
    lens = (t & 0xF) << (4 * (t >> 4))
    bits = v & 1
    out_l = np.zeros(max_runs, np.int32)
    out_b = np.zeros(max_runs, np.int32)
    out_l[: lens.size] = lens
    out_b[: bits.size] = bits
    return out_l, out_b


def pack_block(rle_rows: list[bytes], m: int):
    """Pad a checkpoint block's RLE rows into dense (rows, max_runs) arrays."""
    max_runs = max(1, max((len(r) for r in rle_rows), default=1))
    lens = np.zeros((len(rle_rows), max_runs), np.int32)
    bits = np.zeros((len(rle_rows), max_runs), np.int32)
    for i, r in enumerate(rle_rows):
        lens[i], bits[i] = _rle_to_run_arrays(r, max_runs)
    return jnp.asarray(lens), jnp.asarray(bits)


@functools.partial(jax.jit, static_argnames=("m",))
def decode_block(S0: jax.Array, lens: jax.Array, bits: jax.Array, m: int):
    """Decode one checkpoint block.

    S0: (m,) int32 permutation before the first row.
    lens/bits: (rows, max_runs) run arrays (zero-length runs are padding).
    Returns (rows, m) uint8 bits in original column order, plus the final S.
    """

    def step(S, row):
        run_lens, run_bits = row
        starts = jnp.cumsum(run_lens) - run_lens
        # bit value at each rank: transitions scattered at run starts
        prev = jnp.concatenate([jnp.zeros(1, jnp.int32), run_bits[:-1]])
        delta = run_bits - prev
        z = jnp.zeros(m + 1, jnp.int32).at[starts].add(
            jnp.where(run_lens > 0, delta, 0))
        y = jnp.cumsum(z)[:m]
        # original order: a[S[i]] = y[i]
        a = jnp.zeros(m, jnp.uint8).at[S].set(y.astype(jnp.uint8))
        # stable partition of S by y
        n0 = m - jnp.sum(y)
        ones_excl = jnp.cumsum(y) - y
        zeros_excl = jnp.arange(m, dtype=jnp.int32) - ones_excl
        dest = jnp.where(y == 0, zeros_excl, n0 + ones_excl)
        S_next = jnp.zeros_like(S).at[dest].set(S)
        return S_next, a

    S_final, rows = jax.lax.scan(step, S0.astype(jnp.int32), (lens, bits))
    return rows, S_final


def decode_pbf_on_device(path: str, max_rows: int | None = None) -> np.ndarray:
    """Decode a whole 2-plane PBF through the device scan (demo/oracle path)."""
    from ..formats.pbf import PbfReader
    import struct

    pb = PbfReader(path)
    m = pb.m
    # walk the raw file collecting checkpoint S arrays + RLE rows per block
    out_planes = [[], []]
    pb.fp.seek(16)
    blocks: list[tuple[list[np.ndarray], list[list[bytes]]]] = []
    cur = None
    n = 0
    while max_rows is None or n < max_rows:
        t = pb.fp.read(1)
        if t == b"S":
            Ss = [np.frombuffer(pb.fp.read(4 * m), dtype="<i4") for _ in range(pb.g)]
            cur = (Ss, [[] for _ in range(pb.g)])
            blocks.append(cur)
            t = pb.fp.read(1)
        if t != b"B":
            break
        for gi in range(pb.g):
            (l,) = struct.unpack("<i", pb.fp.read(4))
            cur[1][gi].append(pb.fp.read(l))
        n += 1
    pb.close()
    for Ss, rle_lists in blocks:
        for gi in range(pb.g):
            if not rle_lists[gi]:
                continue
            lens, bits = pack_block(rle_lists[gi], m)
            rows, _ = decode_block(jnp.asarray(Ss[gi]), lens, bits, m)
            out_planes[gi].append(np.asarray(rows))
    p0 = np.concatenate(out_planes[0], axis=0) if out_planes[0] else np.zeros((0, m), np.uint8)
    p1 = np.concatenate(out_planes[1], axis=0) if out_planes[1] else np.zeros((0, m), np.uint8)
    return (p1.astype(np.uint8) << 1) | p0
