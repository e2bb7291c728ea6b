"""Batched query execution on the device (single- and multi-database).

The device-backed replacement for the reference's per-site read loop: each
database's site table (positions, alleles, row numbers) is scanned once into
columnar arrays, site selection (region/BED/paging) becomes a vectorized
mask, the k-way multi-database merge keyed on (rid,pos,rlen,alt) is a sorted
array merge instead of a per-record lookahead loop (reference bgt.c:797-878),
genotype counting runs as masked-popcount device kernels over packed tiles
in device memory (optionally sharded over a device mesh), site filters evaluate as
compiled vector expressions over the AC/AN arrays, and VCF text assembles
from LUT gathers.  Output bytes are identical to the general path (and the
reference CLI); tests cross-check both.

Applicability: the whole view/server surface, including the -S/-H
accumulators (batched reductions over the tile store); the general path
remains the byte-exact arbiter in tests.  Allele sets (-a) apply as a
canonical-key site prefilter (probe-per-key for small sets), and binary
BCF output (-b/-u) serializes through the native batched record emitter.
"""

from __future__ import annotations

import numpy as np

from ..core import kexpr
from ..formats import bcf as bcflib
from ..io.bgzf import BgzfReader
from ..ops.tiles import TileStore
from . import engine

# ops.counts pulls in jax; rowstats/memo/host-tier queries (the cold CLI
# path) must never pay that import, so it stays lazy


def _counts_ops():
    from ..ops import counts
    return counts

BATCH_ROWS = 4096


class SiteTable:
    """All site records of a DB parsed into columnar arrays.

    The one-time .bcf scan is cached in a memory-mapped ``.sites.bin``
    sidecar (written by ``bgt import``; rebuilt here when the .bcf is
    newer), so cold-start queries skip both the per-record parse AND the
    eager sidecar read: at 39.2M sites the former ``.sites.npz`` cost ~8 s
    of read+copy on open, while the mmap faults in only the pages a query
    touches (region masks scan rid/pos/rlen; allele text loads lazily).
    Legacy ``.sites.npz`` sidecars are still read.
    """

    def __init__(self, prefix: str, h0: bcflib.BcfHeader):
        self.h0 = h0
        import os
        from ..formats import sites as sites_fmt
        bcf_path = prefix + ".bcf"
        self._ref_cat_b: bytes | None = None
        self._alt_cat_b: bytes | None = None
        self._ref_cat_mm = self._alt_cat_mm = None
        for sidecar, loader in ((prefix + ".sites.bin", self._load_bin),
                                (prefix + ".sites.npz", self._load)):
            try:
                if os.path.getmtime(sidecar) >= os.path.getmtime(bcf_path):
                    if loader(sidecar):
                        return
            except OSError:
                pass
        self._scan(bcf_path)
        try:
            sites_fmt.write_sidecar(
                prefix + ".sites.bin", self.rid, self.pos, self.rlen,
                self.n_allele, self.ref_len, self.alt_len,
                self._ref_cat_b, self._alt_cat_b)
            # reload through the mmap so every load path exposes identical
            # dtypes/views (scan arrays are int64; the sidecar narrows)
            self._load_bin(prefix + ".sites.bin")
        except OSError:
            pass

    def _load_bin(self, sidecar: str) -> bool:
        from ..formats import sites as sites_fmt
        z = sites_fmt.load_sidecar(sidecar)
        if z is None:
            return False
        self.n = z["n"]
        self.rid = z["rid"]
        self.pos = z["pos"]
        self.rlen = z["rlen"]
        self.n_allele = z["n_allele"]
        self.ref_len = z["ref_len"]
        self.alt_len = z["alt_len"]
        self.ref_off = z["ref_off"]
        self.alt_off = z["alt_off"]
        self._ref_cat_mm = z["ref_cat"]
        self._alt_cat_mm = z["alt_cat"]
        self._sidecar_path = z["path"]
        self._pos_base = z["pos_base"]
        self._rlen_base = z["rlen_base"]
        self._max_rlen = z["max_rlen"]
        self._warm_rows: list = []
        self._refs = None
        self._alts = None
        return True

    @property
    def max_rlen(self) -> int:
        """Largest record span (for the searchsorted region window);
        stored in the v2 sidecar header, computed lazily otherwise."""
        v = getattr(self, "_max_rlen", None)
        if v is None:
            v = self._max_rlen = (int(np.asarray(self.rlen).max())
                                  if self.n else 0)
        return v

    def prefault_rows(self, lo: int, hi: int) -> None:
        """Warm the pos/rlen pages for rows [lo, hi) with buffered
        sequential reads: the vectorized region mask over a cold mmap
        otherwise faults 4 KiB at a time (measured 4.8 s vs ~0.4 s for the
        full 39.2M-site columns; windowed it is proportionally cheaper).
        Already-warmed row ranges are skipped (same policy as
        TileStore.prefault_range)."""
        if getattr(self, "_sidecar_path", None) is None:
            return
        if (hi - lo) * 12 < 16 << 20:
            return  # small window: faults are cheaper than a syscall pass
        warmed = getattr(self, "_warm_rows", None)
        if warmed is None:
            warmed = self._warm_rows = []
        for wlo, whi in warmed:
            if lo >= wlo and hi <= whi:
                return
            if wlo <= lo < whi:
                lo = whi
            if wlo < hi <= whi:
                hi = wlo
        if hi <= lo:
            return
        warmed.append((lo, hi))
        from ..formats import sites as sites_fmt
        sites_fmt.prefault_range(self._sidecar_path,
                                 self._pos_base + 8 * lo,
                                 self._pos_base + 8 * hi)
        sites_fmt.prefault_range(self._sidecar_path,
                                 self._rlen_base + 4 * lo,
                                 self._rlen_base + 4 * hi)

    @property
    def ref_cat(self) -> bytes:
        if self._ref_cat_b is None:
            self._ref_cat_b = self._ref_cat_mm.tobytes()
        return self._ref_cat_b

    @property
    def alt_cat(self) -> bytes:
        if self._alt_cat_b is None:
            self._alt_cat_b = self._alt_cat_mm.tobytes()
        return self._alt_cat_b

    def _scan(self, bcf_path: str) -> None:
        from .. import native
        res = None
        try:
            res = native.site_scan(bcf_path)
        except OSError:
            res = None
        if res is not None:
            (self.rid, self.pos, self.rlen, self.n_allele, self.ref_len,
             self.alt_len, self._ref_cat_b, self._alt_cat_b) = res
            self.n = self.rid.size
            self._finish()
            return
        fp = BgzfReader(bcf_path)
        bcflib.BcfHeader.read_bcf(fp)
        rid = []
        pos = []
        rlen = []
        nal = []
        refs = []
        alts = []
        ref_lens = []
        b = bcflib.Bcf1()
        while b.read(fp) >= 0:
            rid.append(b.rid)
            pos.append(b.pos)
            rlen.append(b.rlen)
            nal.append(b.n_allele)
            r, a = b.get_ref_alt1()
            refs.append(r)
            alts.append(a)
            ref_lens.append(len(r))
        fp.close()
        self.n = len(rid)
        self.rid = np.array(rid, dtype=np.int32)
        self.pos = np.array(pos, dtype=np.int64)
        self.rlen = np.array(rlen, dtype=np.int64)
        self.n_allele = np.array(nal, dtype=np.int32)
        self.ref_len = np.array(ref_lens, dtype=np.int64)
        # concatenated allele buffers + per-site offsets (for native emission)
        self._ref_cat_b = b"".join(refs)
        self.alt_len = np.array([len(a) for a in alts], dtype=np.int64)
        self._alt_cat_b = b"".join(alts)
        self._finish()

    def _load(self, sidecar: str) -> bool:
        """Legacy eager .sites.npz sidecar."""
        z = np.load(sidecar)
        self.rid = z["rid"]
        self.pos = z["pos"]
        self.rlen = z["rlen"]
        self.n_allele = z["n_allele"]
        self.ref_len = z["ref_len"]
        self.alt_len = z["alt_len"]
        self._ref_cat_b = z["ref_cat"].tobytes()
        self._alt_cat_b = z["alt_cat"].tobytes()
        self.n = self.rid.size
        self._finish()
        return True

    def _finish(self) -> None:
        self.ref_off = np.zeros(self.n, dtype=np.int64)
        np.cumsum(self.ref_len[:-1], out=self.ref_off[1:])
        self.alt_off = np.zeros(self.n, dtype=np.int64)
        np.cumsum(self.alt_len[:-1], out=self.alt_off[1:])
        self._refs: list | None = None
        self._alts: list | None = None

    @property
    def refs(self) -> list:
        if self._refs is None:
            self._refs = [
                self.ref_cat[int(o): int(o + l)]
                for o, l in zip(self.ref_off.tolist(), self.ref_len.tolist())
            ]
        return self._refs

    @property
    def alts(self) -> list:
        if self._alts is None:
            self._alts = [
                self.alt_cat[int(o): int(o + l)]
                for o, l in zip(self.alt_off.tolist(), self.alt_len.tolist())
            ]
        return self._alts

    def ref_s(self, r: int) -> str:
        o = int(self.ref_off[r])
        return self.ref_cat[o: o + int(self.ref_len[r])].decode("latin-1")

    def alt_s(self, r: int) -> str:
        o = int(self.alt_off[r])
        return self.alt_cat[o: o + int(self.alt_len[r])].decode("latin-1")


class MergedSites:
    """Columnar view of the union-merged site list across databases."""

    __slots__ = ("n", "rid", "pos", "rlen", "n_allele", "ref_len",
                 "ref_cat", "ref_off", "alt_cat", "alt_off", "alt_len", "pres")

    def __init__(self, n):
        self.n = n

    def ref_s(self, i: int) -> str:
        o = int(self.ref_off[i])
        return self.ref_cat[o: o + int(self.ref_len[i])].decode("latin-1")

    def alt_s(self, i: int) -> str:
        o = int(self.alt_off[i])
        return self.alt_cat[o: o + int(self.alt_len[i])].decode("latin-1")


import threading

# One lock guards every module-level cache: the server is a
# ThreadingHTTPServer, and an unlocked refresh/evict pair (get then pop)
# can race another thread's eviction of the same key (KeyError -> 500).
_CACHE_LOCK = threading.RLock()


def _lru_get(cache: dict, key):
    with _CACHE_LOCK:
        hit = cache.get(key)
        if hit is not None or key in cache:
            cache[key] = cache.pop(key)  # refresh recency
        return hit


def _lru_put(cache: dict, key, val, cap: int) -> None:
    with _CACHE_LOCK:
        cache[key] = val
        while len(cache) > cap:
            evicted = cache.pop(next(iter(cache)))
            closer = getattr(evicted, "release", None)
            if closer is not None:
                try:
                    closer()
                except Exception:  # noqa: BLE001 - best-effort fd release
                    pass


# Per-database caches are LRU-bounded: a long-lived process serving many
# databases must not accumulate memmap file descriptors / device buffers
# without bound (a 12k-database fuzz run hit EMFILE before these caps).
_SITE_CACHE: dict = {}
_TILE_CACHE: dict = {}
_DEVICE_CACHE: dict = {}
_SITE_CAP = 64
_TILE_CAP = 32
_DEVICE_CAP = 8
# (db_key, masks bytes) -> full-range (n_rows, groups, 4) int32 host counts.
# One device pass + one readback per distinct mask set per database; repeat
# queries (server workloads, paging) then never touch the device.
_COUNT_MEMO: dict = {}
_COUNT_MEMO_BYTES = 512 << 20


def _cache_key(bf: engine.BgtFile):
    import os
    path = os.path.abspath(bf.prefix + ".bcf")
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        mtime = 0
    return (path, mtime)


def get_site_table(bf: engine.BgtFile) -> SiteTable:
    key = _cache_key(bf)
    st = _lru_get(_SITE_CACHE, key)
    if st is None:
        st = SiteTable(bf.prefix, bf.h0)
        _lru_put(_SITE_CACHE, key, st, _SITE_CAP)
    return st


def get_tiles(bf: engine.BgtFile) -> TileStore:
    key = _cache_key(bf)
    ts = _lru_get(_TILE_CACHE, key)
    if ts is None:
        ts = TileStore.open_or_build(bf.prefix)
        _lru_put(_TILE_CACHE, key, ts, _TILE_CAP)
    return ts


class DeviceTiles:
    """Tile planes resident on the device (transferred once per process)."""

    def __init__(self, ts: TileStore):
        import jax.numpy as jnp
        self.n_rows = ts.n_rows
        self.p0 = jnp.asarray(ts.plane0)
        self.p1 = jnp.asarray(ts.plane1)
        self.p0.block_until_ready()


def _hbm_budget() -> int:
    """Bytes of device memory we allow for resident tiles."""
    import os
    env = os.environ.get("BGT_TPU_HBM_BUDGET")
    if env:
        return int(env)
    try:
        import jax
        stats = jax.devices()[0].memory_stats() or {}
        limit = stats.get("bytes_limit")
        if limit:
            return int(limit * 0.6)
    except Exception:  # noqa: BLE001
        pass
    return 8 << 30


_DEVICE_OK: list = [None]


def device_available() -> bool:
    """True when a JAX backend can be initialized (cached); without one,
    host popcount serves the count tiers instead of failing the query."""
    if _DEVICE_OK[0] is None:
        try:
            import jax
            jax.devices()
            _DEVICE_OK[0] = True
        except RuntimeError:
            _DEVICE_OK[0] = False
    return _DEVICE_OK[0]


def host_counts(ts: TileStore, rows: np.ndarray, masks: np.ndarray,
                chunk_rows: int = 16384) -> np.ndarray:
    """CPU masked-popcount counts (same math as the device kernel);
    threaded native popcount when the library is present."""
    from .. import native
    lib = native.get_lib()
    if lib is not None and ts.plane0.flags.c_contiguous and rows.size:
        import ctypes
        import os
        n_g = masks.shape[0]
        rows_c = np.ascontiguousarray(rows, np.int64)
        masks_c = np.ascontiguousarray(masks, np.uint32)
        pop = np.ascontiguousarray(
            np.bitwise_count(masks_c).sum(axis=1, dtype=np.int32))
        out = np.empty((rows.size, n_g, 4), dtype=np.int32)
        nt = min(os.cpu_count() or 1, 8)
        p0 = ts.plane0.ctypes.data if isinstance(ts.plane0, np.ndarray) \
            else None
        if p0 is not None:
            ret = lib.bgt_host_counts(
                ctypes.c_void_p(ts.plane0.ctypes.data),
                ctypes.c_void_p(ts.plane1.ctypes.data),
                ctypes.c_void_p(rows_c.ctypes.data), rows_c.size,
                ts.plane0.shape[1], ctypes.c_void_p(masks_c.ctypes.data),
                n_g, ctypes.c_void_p(pop.ctypes.data),
                ctypes.c_void_p(out.ctypes.data), nt)
            if ret == 0:
                return out
    n_g = masks.shape[0]
    out = np.empty((rows.size, n_g, 4), dtype=np.int32)
    tot = np.bitwise_count(masks).sum(axis=1, dtype=np.int32)
    for lo in range(0, rows.size, chunk_rows):
        sl = rows[lo: lo + chunk_rows]
        p0 = ts.plane0[sl]
        p1 = ts.plane1[sl]
        both = p0 & p1
        for gi in range(n_g):
            m = masks[gi]
            n10 = np.bitwise_count(p0 & m).sum(axis=1, dtype=np.int32)
            n11 = np.bitwise_count(p1 & m).sum(axis=1, dtype=np.int32)
            nb = np.bitwise_count(both & m).sum(axis=1, dtype=np.int32)
            cnt1 = n10 - nb
            cnt2 = n11 - nb
            blk = out[lo: lo + sl.size, gi]
            blk[:, 0] = tot[gi] - cnt1 - cnt2 - nb
            blk[:, 1] = cnt1
            blk[:, 2] = cnt2
            blk[:, 3] = nb
    return out


def get_device_tiles(bf: engine.BgtFile) -> DeviceTiles | None:
    """Device-resident planes, or None when they exceed the HBM budget
    (queries then stream row chunks through the device instead)."""
    key = _cache_key(bf)
    if key in _DEVICE_CACHE:
        return _lru_get(_DEVICE_CACHE, key)
    ts = get_tiles(bf)
    dt = None
    if ts.plane0.nbytes * 2 <= _hbm_budget():
        dt = DeviceTiles(ts)
    _lru_put(_DEVICE_CACHE, key, dt, _DEVICE_CAP)
    return dt


def stream_counts(ts: TileStore, rows: np.ndarray, masks: np.ndarray,
                  chunk_rows: int = 16384) -> np.ndarray:
    """Counts for arbitrary row sets by streaming host->HBM row chunks.

    jax dispatch is asynchronous, so the next chunk's host->device transfer
    overlaps the previous chunk's kernel (double buffering without explicit
    semaphores); only the small count tensors are synchronized at the end.
    """
    import jax
    import jax.numpy as jnp
    jm = jnp.asarray(masks)
    pending = []
    count_codes = _counts_ops().count_codes
    for lo in range(0, rows.size, chunk_rows):
        sl = rows[lo: lo + chunk_rows]
        p0 = jax.device_put(np.ascontiguousarray(ts.plane0[sl]))
        p1 = jax.device_put(np.ascontiguousarray(ts.plane1[sl]))
        pending.append(count_codes(p0, p1, jm))
    if not pending:
        return np.zeros((0, masks.shape[0], 4), dtype=np.int32)
    return np.concatenate([np.asarray(c) for c in pending], axis=0)


def _planes_from_pairs(pairs: np.ndarray):
    """Repack a (sites, samples) GT pair matrix (code0*4+code1) into packed
    2-bit planes over the output columns only, plus the identity column
    list — the shape the native BCF serializer consumes.  Bridges mesh-
    gathered genotypes (shard stores) into the plane-reading emitters."""
    n, n_out = pairs.shape
    codes = np.empty((n, n_out * 2), dtype=np.uint8)
    codes[:, 0::2] = pairs >> 2
    codes[:, 1::2] = pairs & 3
    nbytes = (n_out * 2 + 31) // 32 * 4
    b0 = np.packbits(codes & 1, axis=1, bitorder="little")
    b1 = np.packbits(codes >> 1, axis=1, bitorder="little")
    p0 = np.zeros((n, nbytes), np.uint8)
    p1 = np.zeros((n, nbytes), np.uint8)
    p0[:, : b0.shape[1]] = b0
    p1[:, : b1.shape[1]] = b1
    return (p0.view(np.uint32), p1.view(np.uint32),
            np.arange(n_out * 2, dtype=np.int64))


def _shard_min_rows() -> int:
    """Row-span crossover below which an in-process mesh loses to a single
    device (BGT_TPU_SHARD_MIN_ROWS overrides; 0 forces the mesh)."""
    import os
    env = os.environ.get("BGT_TPU_SHARD_MIN_ROWS")
    if env:
        return int(env)
    return 65536


def _bucket(n: int, cap: int) -> int:
    b = 1024
    while b < n:
        b <<= 1
    return min(b, cap)


class ShardContext:
    """Multi-device execution: planes sharded over the sample-column axis.

    Built once per process when more than one device is visible (set
    BGT_TPU_SHARD=0 to force single-device execution).  Per database the
    padded planes are placed across the mesh once; each query ships only its
    small mask tensor and reads back the count tensor (psum-merged).

    Multi-host (``jax.process_count() > 1`` after ``jax.distributed``
    initialization): the mesh spans every process's devices; each host
    places only its own word-column slice of the planes
    (distributed.place_local), counts psum globally, and every host reads
    back the replicated count tensor — the device-mesh generalization of the
    reference's per-sub-cohort database composition (bgt.c:829-842).
    """

    def __init__(self):
        import jax
        from ..parallel import distributed, mesh as meshlib
        self.meshlib = meshlib
        self.distributed = distributed
        self.multi_process = jax.process_count() > 1
        self.mesh = (distributed.global_mesh() if self.multi_process
                     else meshlib.make_mesh())
        self.n_dev = self.mesh.devices.size
        self.count_range = meshlib.sharded_count_range_fn(self.mesh)
        self.pairs_rows = meshlib.sharded_pairs_rows_fn(self.mesh)
        self._planes: dict = {}
        # 2-axis (site-batch x sample-column) meshes + their kernels,
        # keyed by the row-axis size r (single-process only)
        self._mesh2: dict = {}

    def _axes_for(self, ts) -> tuple[int, int]:
        """(r, s) mesh factorization for a database's tile shape: the
        sample axis takes at most enough devices that each still holds
        >=256 words (8192 haplotypes); leftover devices shard the
        site-batch axis — narrow site-heavy matrices (the reference's
        row-streaming seam, bgt.c:797-878) run rows x columns sharded.
        BGT_TPU_MESH2=RxS overrides."""
        import os
        env = os.environ.get("BGT_TPU_MESH2")
        if env:
            r, s = (int(x) for x in env.lower().split("x"))
            if r * s == self.n_dev and r >= 1 and s >= 1:
                return r, s
        s = max(1, min(self.n_dev, ts.n_words // 256))
        while self.n_dev % s:
            s -= 1
        return self.n_dev // s, s

    def _mesh2_fns(self, r: int):
        hit = self._mesh2.get(r)
        if hit is None:
            mesh2 = self.meshlib.make_mesh2(r)
            hit = (mesh2, self.meshlib.sharded_count2_fn(mesh2),
                   self.meshlib.sharded_pairs_rows2_fn(mesh2))
            self._mesh2[r] = hit
        return hit

    def _place(self, arr: np.ndarray, words: int):
        """Column-shard a host array over the mesh (multi-host aware)."""
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P
        pad = words - arr.shape[1]
        if pad:
            arr = np.pad(arr, ((0, 0), (0, pad)))
        if self.multi_process:
            lo, hi = self.distributed.local_column_range(arr.shape[1], self.mesh)
            return self.distributed.place_local(self.mesh, arr[:, lo:hi])
        sh = NamedSharding(self.mesh, P(None, self.meshlib.SAMPLE_AXIS))
        return jax.device_put(arr, sh)

    def _place_shard(self, ts, arr: np.ndarray):
        """Place a pre-sliced column shard (loaded from a .gtc.shard file):
        verify its boundaries equal this process's mesh slice, pad the tail
        shard to the per-device width, and place without ever holding the
        full matrix (no full-DB load per host)."""
        import numpy as np
        lo, hi = self.distributed.local_column_range(ts.n_words, self.mesh)
        if ts.word_offset != lo or ts.word_limit < min(hi, ts.n_words):
            raise ValueError(
                f"tile shard covers words [{ts.word_offset},{ts.word_limit})"
                f" but this process's mesh slice is [{lo},{hi}); re-emit "
                "shards with TileStore.emit_shards matching the mesh")
        local = np.asarray(arr[:, : hi - lo])
        if local.shape[1] < hi - lo:
            local = np.pad(local, ((0, 0), (0, hi - lo - local.shape[1])))
        return self.distributed.place_local(self.mesh, local)

    def executor(self, ctx: "_DbCtx"):
        """Per-database mesh executor (placement cached): 1-axis
        sample-column sharding, or rows x columns on a 2-axis mesh when
        the tile shape warrants it (:meth:`_axes_for`)."""
        key = _cache_key(ctx.bf)
        hit = self._planes.get(key)
        if hit is not None:
            return hit
        ts = ctx.ts
        r, s = ((1, self.n_dev) if self.multi_process or ts.is_shard
                else self._axes_for(ts))
        if r == 1:
            words = self.meshlib.pad_words_for_mesh(ts.n_words, self.n_dev)
            if ts.is_shard:
                if not self.multi_process:
                    raise ValueError("column-shard tile in a single-process "
                                     "run: open the full .gtc instead")
                p0 = self._place_shard(ts, ts.plane0)
                p1 = self._place_shard(ts, ts.plane1)
            else:
                p0 = self._place(ts.plane0, words)
                p1 = self._place(ts.plane1, words)
            hit = _MeshExec1(self, p0, p1, words, ts.n_rows)
        else:
            hit = self._build_exec2(ts, r, s)
        self._planes[key] = hit
        return hit

    def _build_exec2(self, ts, r: int, s: int):
        """Place a database on the (r, s) 2-axis mesh (production use of
        the site-batch axis)."""
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P
        mesh2, count2, pairs2 = self._mesh2_fns(r)
        words = self.meshlib.pad_words_for_mesh(ts.n_words, s)
        rows_pad = (ts.n_rows + r - 1) // r * r
        psh = NamedSharding(mesh2, P(self.meshlib.ROW_AXIS,
                                     self.meshlib.SAMPLE_AXIS))

        def place(arr):
            pc = words - arr.shape[1]
            pr = rows_pad - arr.shape[0]
            if pc or pr:
                arr = np.pad(arr, ((0, pr), (0, pc)))
            return jax.device_put(arr, psh)

        return _MeshExec2(self, mesh2, count2, pairs2,
                          place(ts.plane0), place(ts.plane1), words,
                          ts.n_rows, rows_pad)

    def put_masks(self, masks: np.ndarray, words: int):
        return self._place(masks, words)


class _MaskMemo:
    """Tiny LRU of device-placed mask tensors: repeated queries with the
    same sample subset skip the per-call host->mesh mask transfer (part of
    the flat in-process dispatch overhead)."""

    def __init__(self, place, cap: int = 8):
        self._place = place
        self._cap = cap
        self._memo: dict = {}

    def get(self, masks: np.ndarray):
        key = (masks.shape, masks.tobytes())
        with _CACHE_LOCK:
            hit = self._memo.get(key)
            if hit is not None:
                self._memo[key] = self._memo.pop(key)
                return hit
        placed = self._place(masks)
        with _CACHE_LOCK:
            while len(self._memo) >= self._cap:
                self._memo.pop(next(iter(self._memo)))
            self._memo[key] = placed
        return placed


class _MeshExec1:
    """Sample-column 1-axis mesh executor for one database."""

    kind = "s"

    def __init__(self, sc: ShardContext, p0, p1, words: int, n_rows: int):
        self.sc = sc
        self.p0 = p0
        self.p1 = p1
        self.words = words
        self.n_rows = n_rows
        self._masks = _MaskMemo(lambda m: sc.put_masks(m, words))

    def count_range(self, masks: np.ndarray, start: int,
                    length: int) -> np.ndarray:
        msk = self._masks.get(masks)
        return np.asarray(
            self.sc.count_range(self.p0, self.p1, msk, start, length))

    def pairs(self, rows_idx) -> np.ndarray:
        import jax.numpy as jnp
        return np.asarray(
            self.sc.pairs_rows(self.p0, self.p1, jnp.asarray(rows_idx)))


class _MeshExec2:
    """Rows x columns 2-axis mesh executor: counts run the full row range
    (the memo/full-pass tier is the production consumer; the crossover
    gate keeps small spans off the mesh), sliced to the caller's range on
    readback; GT pairs psum over the row axis then all_gather columns."""

    kind = "rs"

    def __init__(self, sc: ShardContext, mesh2, count2, pairs2, p0, p1,
                 words: int, n_rows: int, rows_pad: int):
        self.sc = sc
        self.mesh2 = mesh2
        self._count2 = count2
        self._pairs2 = pairs2
        self.p0 = p0
        self.p1 = p1
        self.words = words
        self.n_rows = n_rows
        self.rows_pad = rows_pad
        self._masks = _MaskMemo(self._put_masks)

    def _put_masks(self, masks: np.ndarray):
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P
        pad = self.words - masks.shape[1]
        if pad:
            masks = np.pad(masks, ((0, 0), (0, pad)))
        sh = NamedSharding(self.mesh2, P(None, self.sc.meshlib.SAMPLE_AXIS))
        return jax.device_put(masks, sh)

    def count_range(self, masks: np.ndarray, start: int,
                    length: int) -> np.ndarray:
        full = np.asarray(
            self._count2(self.p0, self.p1, self._masks.get(masks)))
        return full[start: start + length]

    def pairs(self, rows_idx) -> np.ndarray:
        import jax.numpy as jnp
        return np.asarray(
            self._pairs2(self.p0, self.p1, jnp.asarray(rows_idx)))


_shard_ctx: list = [None, False]  # [context, initialized]


def get_shard_context() -> ShardContext | None:
    import os
    if _shard_ctx[1]:
        return _shard_ctx[0]
    _shard_ctx[1] = True
    if os.environ.get("BGT_TPU_SHARD", "") == "0":
        return None
    import jax
    try:
        n_dev = len(jax.devices())
    except RuntimeError:  # no usable backend: queries stay host-side
        return None
    if n_dev < 2:
        return None
    _shard_ctx[0] = ShardContext()
    return _shard_ctx[0]


def reset_shard_context() -> None:
    _shard_ctx[0] = None
    _shard_ctx[1] = False


def applicable(opt, bm: engine.BgtmReader) -> bool:
    # the whole view surface runs here, including the -S/-H accumulators
    # (batched over the tile store, _accumulate_al_hap) — EXCEPT tiny
    # unfiltered -i/-n pages against a cold site table: the streaming
    # engine path (RNI seek + sequential reads, engine.read) answers those
    # in milliseconds, while building the columnar table for a 39.2M-site
    # database costs ~13 s (hrc_full measurement); long-lived processes
    # (the server) still warm the table on their first non-page query
    if (opt.n_rec is not None and opt.n_rec <= 4096
            and bm.site_flt is None and bm.h_al is None and not bm.fields
            and len(bm.bgt) == 1 and bm.bgt[0].bed is None
            and getattr(opt, "max_gt", None) is None
            and getattr(opt, "srv_max_read", None) is None):
        with _CACHE_LOCK:
            cold = _cache_key(bm.bgt[0].f) not in _SITE_CACHE
        if cold:
            return False
    return True


class _DbCtx:
    """Per-database execution context within a fast query."""

    def __init__(self, g: engine.BgtReader, opt):
        self.g = g
        self.bf = g.f
        self.st = get_site_table(self.bf)
        self.ts = get_tiles(self.bf)
        self.opt = opt
        # GT gathers use host decode when counting runs on a mesh (avoids
        # holding a second, unsharded device copy of the planes)
        self.sharding_active = False

    def select_rows(self) -> np.ndarray:
        st = self.st
        g = self.g
        if g.itr is not None:
            it = g.itr
            # rid and (within a contig) pos are sorted by construction
            # (the importer rejects unsorted input, like hts_idx_push), so
            # the region becomes a searchsorted window instead of a full
            # 39.2M-element mask scan; only pos+rlen>beg needs elementwise
            # work inside the window (reference seam: hts.c:725-814 walks
            # CSI chunks for the same reason)
            # needles must match the array dtype: a Python-int needle vs an
            # int32 mmap column makes numpy promote (= copy) the whole
            # 157 MB array before the binary search (measured 267 ms vs
            # 0.01 ms)
            tid32 = np.int32(it.tid)
            lo_t = int(np.searchsorted(st.rid, tid32, "left"))
            hi_t = int(np.searchsorted(st.rid, tid32, "right"))
            sub = st.pos[lo_t:hi_t]
            lo = lo_t + int(np.searchsorted(
                sub, np.int64(it.beg - st.max_rlen + 1), "left"))
            hi = lo_t + int(np.searchsorted(sub, np.int64(it.end), "left"))
            st.prefault_rows(lo, hi)
            mask = (st.pos[lo:hi] + st.rlen[lo:hi] > it.beg)
            rows = lo + np.nonzero(mask)[0]
        elif self.opt.seekn > 0:
            rows = np.arange(min(self.opt.seekn, st.n), st.n)
        else:
            rows = np.arange(st.n)
        if g.bed is not None:
            keep = []
            for r in rows:
                chrom = g.h_out.id_name(bcflib.BCF_DT_CTG, int(st.rid[r]))
                hit = g.bed.overlap(chrom, int(st.pos[r]), int(st.pos[r] + st.rlen[r]))
                if g.bed_excl != bool(hit):
                    keep.append(r)
            rows = np.array(keep, dtype=np.int64)
        if g.h_al is not None:
            rows = self._al_filter(rows)
        return rows

    def _al_filter(self, rows: np.ndarray) -> np.ndarray:
        """Allele-set site prefilter (al_present, reference bgt.c:252-270):
        keep sites whose alt (or ref) canonical key is in the -a set.

        Small allele sets invert the scan: each key names a narrow genomic
        window (site pos ∈ [key_pos - max_ref_len, key_pos]), so candidate
        rows come from a searchsorted probe per key instead of walking the
        whole selection — the batched analogue of the reference's per-
        allele region seek (bgt.c:513-543)."""
        if rows.size > 64 * max(len(self.g.h_al), 1):
            inv = self._al_filter_inverted(rows)
            if inv is not None:
                return inv
        if isinstance(self.g.h_al, engine.AlleleSet):
            ctg = [n for n, _ in
                   self.g.h_out.ids[bcflib.BCF_DT_CTG]]
            kinds = self.g.h_al.match_sites(self.st, rows, ctg)
            return rows[kinds != 0]
        return self._al_filter_walk(rows)

    def _al_filter_walk(self, rows: np.ndarray) -> np.ndarray:
        st = self.st
        h_al = self.g.h_al
        names = {}
        rid_l = st.rid.tolist()
        pos_l = st.pos.tolist()
        rlen_l = st.rlen.tolist()
        refs = st.refs
        alts = st.alts
        keep = []
        for r in rows.tolist():
            ref = refs[r]
            alt = alts[r]
            min_l = min(len(ref), len(alt))
            shift = 0
            while shift < min_l and ref[shift] == alt[shift]:
                shift += 1
            rid = rid_l[r]
            chrom = names.get(rid)
            if chrom is None:
                chrom = names[rid] = self.g.h_out.id_name(
                    bcflib.BCF_DT_CTG, rid)
            head = f"{chrom}:{pos_l[r] + shift}:{rlen_l[r] - shift}:"
            if (head + alt[shift:].decode("latin-1") in h_al
                    or head + ref[shift:].decode("latin-1") in h_al):
                keep.append(r)
        return np.array(keep, dtype=np.int64)

    def _al_filter_inverted(self, rows: np.ndarray) -> np.ndarray | None:
        """Probe candidate rows per allele key; None when a key does not
        parse as chrom:pos (caller falls back to the full walk)."""
        st = self.st
        g = self.g
        ctg_ids = {name: i for i, (name, _ii)
                   in enumerate(g.h_out.ids[bcflib.BCF_DT_CTG])}
        window = int(st.ref_len.max()) if st.n else 0
        cand: set[int] = set()
        comp = st.rid.astype(np.int64) * (1 << 40) + st.pos
        for key in g.h_al:
            # canonical key = chrom:pos:rlen:seq where chrom may itself
            # contain ':' (HLA contigs): parse from the right and validate
            # the numeric fields; anything odd falls back to the full walk
            c = key.rsplit(":", 3)
            if len(c) < 4:
                return None
            try:
                kpos = int(c[1])
                int(c[2])
            except ValueError:
                return None
            rid = ctg_ids.get(c[0])
            if rid is None:
                continue
            # canonical key pos is 0-based (al_parse does int(s)-1;
            # al_from_bcf uses b.pos): site pos = kpos - shift with
            # shift ∈ [0, ref_len), so candidates live in
            # (kpos - window, kpos]; the probe below over-covers by one on
            # the left, which is safe — the exact key check follows
            base = rid << 40
            lo = int(np.searchsorted(comp, base + (kpos - 1 - window)))
            hi = int(np.searchsorted(comp, base + kpos, side="right"))
            cand.update(range(lo, hi))
        if not cand:
            return np.zeros(0, dtype=np.int64)
        cand_rows = np.array(sorted(cand), dtype=np.int64)
        # exact canonical-key check on the candidates only
        matched = self._al_filter_walk(cand_rows)
        # intersect with the region/BED-selected rows, preserving order
        return matched[np.isin(matched, rows, assume_unique=True)]

    def masks(self, n_groups: int) -> np.ndarray:
        g = self.g
        if n_groups > 1:
            return self.ts.group_masks(np.asarray(g.group), n_groups,
                                       np.asarray(g.out))
        cols = np.empty(g.n_out * 2, dtype=np.int64)
        cols[0::2] = np.asarray(g.out) * 2
        cols[1::2] = np.asarray(g.out) * 2 + 1
        return self.ts.pack_mask(cols)[None, :]

    def gt_cols(self, mgs: np.ndarray) -> np.ndarray:
        """Haplotype columns for GT output (samples with mgs<=1)."""
        samples = np.asarray(self.g.out)[mgs <= 1]
        cols = np.empty(samples.size * 2, dtype=np.int64)
        cols[0::2] = samples * 2
        cols[1::2] = samples * 2 + 1
        return cols

    def _count_tier(self, rows: np.ndarray, masks: np.ndarray,
                    memo_ok: bool) -> str:
        """host vs device for a count pass: a one-shot CLI subset query
        should not pay a tile transfer to the device when the host
        popcount finishes in well under a second.

        device when: forced by env, the planes are already device-resident
        (warm server), or the popcount volume exceeds the host budget;
        host otherwise.  BGT_TPU_COUNT_TIER=host|device overrides.  The
        cut points below are not yet calibrated on the H100."""
        import os
        env = os.environ.get("BGT_TPU_COUNT_TIER", "auto")
        if env in ("host", "device"):
            return env
        if not device_available():
            return "host"
        key = _cache_key(self.bf)
        resident = _DEVICE_CACHE.get(key) is not None or (
            _shard_ctx[0] is not None and key in _shard_ctx[0]._planes)
        if resident:
            return "device"
        ts = self.ts
        # three masked-popcount passes over the ROW SPAN per mask: the
        # tier choice must reflect the cheapest host option (region-only),
        # not the full-range memo pass — at 1M+ rows the memo pass is 10x
        # the region work, and routing it to a non-resident device copies
        # the whole tile to the device first
        span = int(rows[-1]) + 1 - int(rows[0])
        work = span * masks.shape[0] * ts.plane0.shape[1] * 4 * 3
        # 64 GiB default (host popcount bytes); not yet calibrated against
        # a host-to-device copy of the tile on the H100
        budget = int(os.environ.get("BGT_TPU_HOST_WORK_MAX", 64 << 30))
        return "host" if work <= budget else "device"

    def counts_for(self, rows: np.ndarray, masks: np.ndarray,
                   sharding_cb=None) -> np.ndarray:
        """(len(rows), n_groups, 4) counts.

        Resolution order: (1) the materialized all-columns aggregate built at
        tile time (rowstats — the all-samples AC/AN query is pure host); (2)
        the per-mask count memo (one full-range device pass + readback per
        distinct mask set per DB); (3) a device kernel over the row span
        (planes device-resident, sharded over the sample axis when a mesh is
        active); (4) streamed row chunks when tiles exceed the HBM budget.

        ``sharding_cb``: zero-arg callable resolving the mesh context, only
        invoked when a device pass is actually needed.
        """
        if rows.size == 0:
            return np.zeros((0, masks.shape[0], 4), dtype=np.int32)
        ts = self.ts
        if (masks.shape[0] == 1 and ts.rowstats is not None
                and masks[0].tobytes() == ts.all_mask().tobytes()):
            return ts.rowstats[rows][:, None, :]
        memo_key = (_cache_key(self.bf), masks.tobytes())
        hit = _COUNT_MEMO.get(memo_key)
        if hit is not None:
            return hit[rows]
        memo_ok = ts.n_rows * masks.shape[0] * 16 <= _COUNT_MEMO_BYTES
        span = int(rows[-1]) + 1 - int(rows[0])
        if ts.is_shard:
            sharding = sharding_cb() if sharding_cb is not None else None
            if sharding is None:
                raise ValueError("column-shard tile needs the multi-process "
                                 "mesh path for subset counts")
            ex = sharding.executor(self)
            length = _bucket(int(rows[-1]) + 1 - int(rows[0]), ex.n_rows)
            start = min(int(rows[0]), ex.n_rows - length)
            counts = ex.count_range(masks, start, length)
            return counts[rows - start]
        if self._count_tier(rows, masks, memo_ok) == "host":
            # memoize the full range only when that pass is itself cheap
            # (separate, smaller budget than the host-vs-device tier cut:
            # a one-shot query must not pay a 10x-larger pass to warm a
            # memo, but a ~1s full pass buys all later subset queries)
            import os
            memo_budget = int(os.environ.get("BGT_TPU_MEMO_WORK_MAX",
                                             8 << 30))
            full_work = ts.n_rows * masks.shape[0] * ts.plane0.shape[1] * 12
            memo_ok = memo_ok and full_work <= memo_budget
            if (memo_ok or rows.size > ts.n_rows // 2) \
                    and ts.plane0.nbytes * 2 > 256 << 20:
                ts.prefault()  # full-tile pass: avoid 4KiB fault-at-a-time
            elif span * ts.plane0.shape[1] * 8 > 256 << 20:
                # large region on a huge tile: warm just the row span
                ts.prefault_range(int(rows[0]), int(rows[-1]) + 1)
            counts = host_counts(ts, np.arange(ts.n_rows) if memo_ok else rows,
                                 masks)
            if memo_ok:
                with _CACHE_LOCK:
                    _COUNT_MEMO[memo_key] = counts
                return counts[rows]
            return counts
        start = int(rows[0])
        if memo_ok:
            start, span = 0, ts.n_rows
        sharding = sharding_cb() if sharding_cb is not None else None
        if (sharding is not None and not sharding.multi_process
                and span < _shard_min_rows()):
            # below the mesh-dispatch crossover a single device wins: the
            # multi-device dispatch + replicated-output assembly costs a
            # flat ~60-100 ms on the CPU proxy (tools/bench_scaling.py
            # measures the crossover), which only amortizes on large row
            # spans.  Multi-process meshes have no single-device fallback
            # (no process holds the full columns), so they always shard.
            sharding = None
        if sharding is not None:
            ex = sharding.executor(self)
            length = _bucket(span, ex.n_rows)
            start = min(start, ex.n_rows - length)
            counts = ex.count_range(masks, start, length)
        else:
            dt = get_device_tiles(self.bf)
            if dt is None:  # tiles exceed the HBM budget: stream row chunks
                return stream_counts(self.ts, rows, masks)
            import jax.numpy as jnp
            length = _bucket(span, dt.n_rows)
            start = min(start, dt.n_rows - length)
            counts = np.asarray(_counts_ops().count_codes_range(
                dt.p0, dt.p1, jnp.asarray(masks), start, length))
        if memo_ok:
            full = counts[:ts.n_rows]
            with _CACHE_LOCK:
                while (sum(v.nbytes for v in _COUNT_MEMO.values())
                       + full.nbytes > _COUNT_MEMO_BYTES and _COUNT_MEMO):
                    _COUNT_MEMO.pop(next(iter(_COUNT_MEMO)))
                _COUNT_MEMO[memo_key] = full
            return full[rows]
        return counts[rows - start]

    def pairs_for(self, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
        """(len(rows), n_samples) uint8 GT cell indices (code0*4+code1).

        Host decode: this path serves multi-DB/subset/no-native GT output;
        the dominant single-DB dump bypasses it entirely (the native emitter
        reads the packed planes directly), and readback-heavy device GT
        gathers lose on hosts with slow device->host links.
        """
        if rows.size == 0 or cols.size == 0:
            return np.zeros((rows.size, cols.size // 2), dtype=np.uint8)
        if self.ts.is_shard:
            return self._pairs_sharded(rows, cols)
        codes = self.ts.codes(rows, cols)
        return (codes[:, 0::2] << 2) | codes[:, 1::2]

    def _pairs_sharded(self, rows: np.ndarray, cols: np.ndarray,
                       chunk_rows: int = 2048) -> np.ndarray:
        """GT pair assembly when this process holds only a column-slice
        shard: decode + all_gather over the sample-axis mesh
        (mesh.sharded_pairs_rows_fn), then subset the replicated pair matrix
        to the requested output samples.  The multi-host GT-output seam of
        SURVEY §7.5 ("GT gather via all_gather only when genotype output is
        requested"); replaces the former hard error.
        """
        sharding = get_shard_context()
        if sharding is None:
            raise ValueError(
                "column-shard tile store but no device mesh: GT-emitting "
                "queries on shards need the multi-process mesh path")
        ex = sharding.executor(self)
        samples = np.asarray(cols[0::2] // 2, dtype=np.int64)
        out = np.empty((rows.size, samples.size), dtype=np.uint8)
        for lo in range(0, rows.size, chunk_rows):
            sl = rows[lo: lo + chunk_rows]
            n = _bucket(int(sl.size), chunk_rows)
            idx = np.zeros(n, dtype=np.int32)
            idx[: sl.size] = sl
            pairs_full = ex.pairs(idx)
            out[lo: lo + sl.size] = pairs_full[: sl.size][:, samples]
        return out


class FastView:
    """Executes a prepared BgtmReader query batch-wise."""

    def __init__(self, bm: engine.BgtmReader, opt, sharding=None):
        self.bm = bm
        self.opt = opt
        self.dbs = [_DbCtx(g, opt) for g in bm.bgt]
        # device/mesh discovery is deferred until a query actually needs a
        # device pass: rowstats- and memo-served queries must run (and the
        # CLI must not fail) without a reachable accelerator
        self._sharding = sharding
        self._sharding_resolved = sharding is not None

    @property
    def sharding(self):
        if not self._sharding_resolved:
            self._sharding = get_shard_context()
            self._sharding_resolved = True
            for ctx in self.dbs:
                ctx.sharding_active = self._sharding is not None
        return self._sharding

    # --- merge -------------------------------------------------------------

    def _merge(self, rows_per_db: list[np.ndarray]) -> MergedSites:
        """Union-merge site lists in bcfcmp order (key + occurrence rank)."""
        n_bgt = len(self.dbs)
        if n_bgt == 1:
            st = self.dbs[0].st
            rows = rows_per_db[0]
            mv = MergedSites(rows.size)
            mv.rid = st.rid[rows]
            mv.pos = st.pos[rows]
            mv.rlen = st.rlen[rows]
            mv.n_allele = st.n_allele[rows]
            mv.ref_len = st.ref_len[rows]
            mv.ref_cat = st.ref_cat
            mv.ref_off = st.ref_off[rows]
            mv.alt_cat = st.alt_cat
            mv.alt_off = st.alt_off[rows]
            mv.alt_len = st.alt_len[rows]
            mv.pres = rows[:, None]
            return mv
        from .. import native
        if native.get_lib() is not None:
            res = native.merge_sites([ctx.st for ctx in self.dbs],
                                     rows_per_db)
            if res is not None:
                (n, rid, pos, rlen, nal, ref_len, alt_len, pres, ref_cat,
                 alt_cat) = res
                mv = MergedSites(n)
                mv.rid, mv.pos, mv.rlen, mv.n_allele = rid, pos, rlen, nal
                mv.ref_len, mv.alt_len = ref_len, alt_len
                mv.ref_cat, mv.alt_cat = ref_cat, alt_cat
                mv.ref_off = np.zeros(n, np.int64)
                np.cumsum(ref_len[:-1], out=mv.ref_off[1:])
                mv.alt_off = np.zeros(n, np.int64)
                np.cumsum(alt_len[:-1], out=mv.alt_off[1:])
                mv.pres = pres
                return mv
        fast = self._merge_lexsort(rows_per_db)
        if fast is not None:
            return fast
        return self._merge_dict(rows_per_db)

    def _merge_dict(self, rows_per_db: list[np.ndarray]) -> MergedSites:
        """Scalar fallback union merge (kept as the oracle for the lexsort
        path and for pathological allele lengths)."""
        n_bgt = len(self.dbs)
        # extended key = (rid, pos, rlen, alt, occurrence#-within-db):
        # duplicate keys inside one DB pair up occurrence-wise across DBs,
        # exactly like the lookahead merge consumes them one at a time
        merged: dict = {}
        for d, ctx in enumerate(self.dbs):
            st = ctx.st
            occ: dict = {}
            rid_l = st.rid.tolist()
            pos_l = st.pos.tolist()
            rlen_l = st.rlen.tolist()
            for r in rows_per_db[d].tolist():
                key = (rid_l[r], pos_l[r], rlen_l[r], st.alts[r])
                k = occ.get(key, 0)
                occ[key] = k + 1
                ext = key + (k,)
                slot = merged.get(ext)
                if slot is None:
                    merged[ext] = slot = [-1] * n_bgt
                slot[d] = r
        order = sorted(merged)
        n = len(order)
        mv = MergedSites(n)
        mv.pres = np.full((n, n_bgt), -1, dtype=np.int64)
        rid = np.empty(n, dtype=np.int32)
        pos = np.empty(n, dtype=np.int64)
        rlen = np.empty(n, dtype=np.int64)
        nal = np.empty(n, dtype=np.int32)
        ref_len = np.empty(n, dtype=np.int64)
        ref_off = np.empty(n, dtype=np.int64)
        alt_off = np.empty(n, dtype=np.int64)
        alt_len = np.empty(n, dtype=np.int64)
        refs = []
        alts = []
        r_off = a_off = 0
        for i, ext in enumerate(order):
            slot = merged[ext]
            mv.pres[i] = slot
            rid[i], pos[i], rlen[i] = ext[0], ext[1], ext[2]
            first = next(d for d in range(n_bgt) if slot[d] >= 0)
            st = self.dbs[first].st
            r = slot[first]
            ref_len[i] = st.ref_len[r]
            refs.append(st.refs[r])
            ref_off[i] = r_off
            r_off += len(st.refs[r])
            alts.append(ext[3])
            alt_off[i] = a_off
            alt_len[i] = len(ext[3])
            a_off += alt_len[i]
            # reference takes max n_allele across EQUAL records (bgt.c:811-819)
            na = 0
            for d in range(n_bgt):
                if slot[d] >= 0:
                    na = max(na, int(self.dbs[d].st.n_allele[slot[d]]))
            nal[i] = na
        mv.rid, mv.pos, mv.rlen, mv.n_allele, mv.ref_len = rid, pos, rlen, nal, ref_len
        mv.ref_cat = b"".join(refs)
        mv.ref_off = ref_off
        mv.alt_cat = b"".join(alts)
        mv.alt_off = alt_off
        mv.alt_len = alt_len
        return mv

    def _merge_lexsort(self, rows_per_db: list[np.ndarray]):
        """Vectorized union merge: one lexsort over (rid, pos, rlen,
        alt-rank, occurrence) columns replaces the per-row dict loop
        (key order matches bcfcmp, bgt.c:803-820).
        Returns None for pathological allele widths (dict fallback)."""
        n_bgt = len(self.dbs)
        widths = [int(ctx.st.alt_len[rows].max()) if rows.size else 0
                  for ctx, rows in zip(self.dbs, rows_per_db)]
        width = max(1, max(widths))
        if width > 256:
            return None  # fixed-width alt matrix would blow up on huge alts

        def within(lens, total):
            seg = np.repeat(np.cumsum(lens) - lens, lens)
            return np.arange(total, dtype=np.int64) - seg

        def alt_sarr(st, rows):
            n = rows.size
            out = np.zeros((n, width), np.uint8)
            lens = st.alt_len[rows]
            total = int(lens.sum())
            if total:
                w = within(lens, total)
                idx = np.repeat(st.alt_off[rows], lens) + w
                fpos = np.repeat(np.arange(n, dtype=np.int64) * width,
                                 lens) + w
                out.reshape(-1)[fpos] = np.frombuffer(
                    st.alt_cat, np.uint8)[idx]
            return out.view(f"S{width}").reshape(n)

        parts = []
        for d, ctx in enumerate(self.dbs):
            rows = rows_per_db[d]
            st = ctx.st
            parts.append((st.rid[rows].astype(np.int64), st.pos[rows],
                          st.rlen[rows], alt_sarr(st, rows),
                          st.n_allele[rows].astype(np.int64), rows))
        alt_all = np.concatenate([p[3] for p in parts])
        uniq_alt, alt_rank = np.unique(alt_all, return_inverse=True)
        alt_rank = alt_rank.astype(np.int64)
        rid_all = np.concatenate([p[0] for p in parts])
        pos_all = np.concatenate([p[1] for p in parts])
        rlen_all = np.concatenate([p[2] for p in parts])
        nal_all = np.concatenate([p[4] for p in parts])
        row_all = np.concatenate([p[5] for p in parts])
        db_all = np.concatenate([np.full(p[5].size, d, np.int64)
                                 for d, p in enumerate(parts)])
        N = rid_all.size
        if N == 0:
            mv = MergedSites(0)
            mv.pres = np.full((0, n_bgt), -1, dtype=np.int64)
            mv.rid = np.zeros(0, np.int32)
            mv.pos = mv.rlen = mv.ref_len = mv.alt_len = mv.ref_off = \
                mv.alt_off = np.zeros(0, np.int64)
            mv.n_allele = np.zeros(0, np.int32)
            mv.ref_cat = mv.alt_cat = b""
            return mv
        # composite sort keys: c1 = (rid, pos), c2 = (rlen, alt, occ) —
        # two radix passes instead of five (falls back when ranges overflow)
        pos_m = int(pos_all.max()) + 1
        rid_m = int(rid_all.max()) + 1
        rlen_m = int(rlen_all.max()) + 1
        na = uniq_alt.size
        if rid_m * pos_m >= 1 << 62 or rlen_m * na * 4096 >= 1 << 62:
            return None  # dict fallback for pathological ranges
        c1 = rid_all * pos_m + pos_all
        c2_noocc = rlen_all * na + alt_rank
        # occurrence rank within each DB for duplicated keys (stable
        # lexsort keeps row order among equal keys)
        occ_all = np.zeros(N, np.int64)
        max_occ = 0
        off = 0
        for p in parts:
            nd = p[5].size
            if nd:
                sl = slice(off, off + nd)
                o = np.lexsort((c2_noocc[sl], c1[sl]))
                k1 = c1[sl][o]
                k2 = c2_noocc[sl][o]
                new = np.empty(nd, bool)
                new[0] = True
                new[1:] = (k1[1:] != k1[:-1]) | (k2[1:] != k2[:-1])
                ar = np.arange(nd)
                first = np.maximum.accumulate(np.where(new, ar, 0))
                occ_sorted = ar - first
                occ_all[sl][o] = occ_sorted
                m = int(occ_sorted.max())
                max_occ = max(max_occ, m)
            off += nd
        if (max_occ + 1) * rlen_m * na >= 1 << 62:
            return None
        c2 = c2_noocc * (max_occ + 1) + occ_all
        order = np.lexsort((c2, c1))
        k1 = c1[order]
        k2 = c2[order]
        new = np.empty(N, bool)
        new[0] = True
        new[1:] = (k1[1:] != k1[:-1]) | (k2[1:] != k2[:-1])
        grp = np.cumsum(new) - 1
        n = int(grp[-1]) + 1
        mv = MergedSites(n)
        mv.pres = np.full((n, n_bgt), -1, dtype=np.int64)
        mv.pres[grp, db_all[order]] = row_all[order]
        firsts_in_order = order[np.nonzero(new)[0]]
        mv.rid = rid_all[firsts_in_order].astype(np.int32)
        mv.pos = pos_all[firsts_in_order]
        mv.rlen = rlen_all[firsts_in_order]
        # reference takes max n_allele across EQUAL records (bgt.c:811-819)
        mv.n_allele = np.maximum.reduceat(
            nal_all[order], np.nonzero(new)[0]).astype(np.int32)
        # ALT bytes from the rank vocabulary
        aid = alt_rank[firsts_in_order]
        alt_lens = np.char.str_len(uniq_alt).astype(np.int64)[aid]
        mv.alt_len = alt_lens
        mv.alt_off = np.zeros(n, np.int64)
        np.cumsum(alt_lens[:-1], out=mv.alt_off[1:])
        total_a = int(alt_lens.sum())
        acat = np.empty(total_a, np.uint8)
        src = np.frombuffer(uniq_alt.tobytes(), np.uint8)
        w_a = within(alt_lens, total_a)
        idx = np.repeat(aid * width, alt_lens) + w_a
        acat[:] = src[idx]
        mv.alt_cat = acat.tobytes()
        # REF bytes from the first database holding each record
        first_db = np.argmax(mv.pres >= 0, axis=1)
        ref_len = np.zeros(n, np.int64)
        for d, ctx in enumerate(self.dbs):
            m = first_db == d
            if m.any():
                ref_len[m] = ctx.st.ref_len[mv.pres[m, d]]
        mv.ref_len = ref_len
        mv.ref_off = np.zeros(n, np.int64)
        np.cumsum(ref_len[:-1], out=mv.ref_off[1:])
        total_r = int(ref_len.sum())
        rcat = np.empty(total_r, np.uint8)
        out_off = mv.ref_off
        for d, ctx in enumerate(self.dbs):
            m = first_db == d
            if not m.any():
                continue
            st = ctx.st
            rows = mv.pres[m, d]
            lens = st.ref_len[rows]
            tot = int(lens.sum())
            if not tot:
                continue
            sidx = np.repeat(st.ref_off[rows], lens) + within(lens, tot)
            didx = np.repeat(out_off[m], lens) + within(lens, tot)
            rcat[didx] = np.frombuffer(st.ref_cat, np.uint8)[sidx]
        mv.ref_cat = rcat.tobytes()
        return mv

    # --- the full run ------------------------------------------------------

    def run(self, out) -> None:
        from ..log import device_trace
        with device_trace():
            self._run(out)

    def _run(self, out) -> None:
        from ..log import stage
        bm = self.bm
        opt = self.opt
        if all(ctx.g.n_out == 0 for ctx in self.dbs):
            return
        with stage("site-select"):
            rows_per_db = [
                ctx.select_rows() if ctx.g.n_out > 0 else np.zeros(0, np.int64)
                for ctx in self.dbs
            ]
        # early truncation: an unfiltered single-DB -i/-n page only ever
        # touches its first n_rec(+1) selected rows (the reference streams
        # and breaks, view.c:151-156); materializing millions of rows for
        # a 100-record page cost ~1 s at the 39.2M-site scale
        if (opt.n_rec is not None and bm.site_flt is None
                and bm.h_al is None and len(self.dbs) == 1
                and getattr(opt, "max_gt", None) is None
                and getattr(opt, "srv_max_read", None) is None):
            rows_per_db = [rows_per_db[0][: opt.n_rec + 1]]
        with stage("merge"):
            mv = self._merge(rows_per_db)
        n_groups = bm.n_groups
        info_on = bool(bm.flag & engine.F_SET_AC) or bm.site_flt is not None \
            or bool(bm.fields) or n_groups > 1

        # per-DB device counts, then merge with missing-fill (code 2);
        # a query with no INFO/filter/table surface never needs them
        counts = np.zeros((mv.n, n_groups, 4), dtype=np.int64)
        for d, ctx in enumerate(self.dbs):
            if ctx.g.n_out == 0:
                continue
            rows_d = rows_per_db[d]
            bm.n_gt_read += int(rows_d.size) * ctx.g.n_out
            if not info_on:
                continue
            masks = ctx.masks(n_groups)
            with stage(f"device-counts[{d}]"):
                cd = ctx.counts_for(rows_d, masks, lambda: self.sharding)
            pres = mv.pres[:, d]
            if len(self.dbs) == 1:
                counts += cd
            else:
                # map merged rows to positions within rows_d
                have = pres >= 0
                idx = np.searchsorted(rows_d, pres[have])
                counts[have] += cd[idx]
                # absent rows: every column of this DB reads as missing
                # (a0=0, a1=1 -> code 2 fill, bgt.c:838-839)
                miss = np.zeros((n_groups, 4), dtype=np.int64)
                for gi in range(n_groups):
                    miss[gi, 2] = int(np.unpackbits(
                        masks[gi].view(np.uint8)).sum())
                counts[~have] += miss[None, :, :]

        tot = counts.sum(axis=1)
        an = tot[:, 0] + tot[:, 1] + tot[:, 3]
        ac = tot[:, 1]
        ac_m = tot[:, 3]
        if n_groups > 1:
            gan = counts[:, :, 0] + counts[:, :, 1] + counts[:, :, 3]
            gac = counts[:, :, 1]
            gac_m = counts[:, :, 3]

        # site filter over the whole batch
        pass_mask = np.ones(mv.n, dtype=bool)
        if bm.site_flt is not None:
            env = {"AC": ac.astype(np.int64), "AN": an.astype(np.int64)}
            for gi in range(n_groups):
                env[f"AN{gi + 1}"] = (gan[:, gi] if n_groups > 1 else an).astype(np.int64)
                env[f"AC{gi + 1}"] = (gac[:, gi] if n_groups > 1 else ac).astype(np.int64)
            try:
                fn = bm.site_flt.compile_vector(np)
                missing_vars = bm.site_flt.var_names - set(env)
                if missing_vars:
                    raise TypeError(f"unknown vars {missing_vars}")
                _t, vec = fn(env)
                pass_mask = np.asarray(vec) != 0
            except (TypeError, KeyError):
                for i in range(mv.n):
                    ss = self._site_info(i, counts)
                    pass_mask[i] = bm.pass_site_flt(ss)

        no_gt = bool(bm.flag & engine.F_NO_GT)

        n_rec = opt.n_rec if opt.n_rec is not None else None
        ctg_names = [n for n, _ in bm.h_out.ids[bcflib.BCF_DT_CTG]]

        sel_all = np.nonzero(pass_mask)[0]
        sel = sel_all
        if n_rec is not None and sel.size > n_rec:
            sel = sel[:n_rec]
        max_gt = getattr(opt, "max_gt", None)
        srv_max_read = getattr(opt, "srv_max_read", None)
        if max_gt is not None or srv_max_read is not None:
            sel, bm.truncated = self._truncate_server(mv, sel, max_gt,
                                                      srv_max_read)
        if bm.h_al is not None and bm.flag & (engine.F_CNT_AL
                                              | engine.F_CNT_HAP):
            if max_gt is not None or srv_max_read is not None:
                # the server loop checks quotas BEFORE each read, so the
                # accumulated set equals the emitted set (server.py)
                sel_acc = sel
            elif sel.size != sel_all.size:
                # the CLI loop reads one record past the -n cutoff before
                # breaking, so that site still accumulates -S/-H counts
                # (view.c:151-156)
                sel_acc = sel_all[:sel.size + 1]
            else:
                sel_acc = sel
            with stage("al-hap-counts"):
                self._accumulate_al_hap(sel_acc, mv)

        if sel.size == 0 or (getattr(opt, "not_vcf", False) and not bm.fields):
            return  # -S/-H runs emit no records (view.c:151-156)

        if not no_gt:
            # bulk GT dumps walk every plane page: warm the cache
            # sequentially instead of faulting 4 KiB at a time
            for ctx in self.dbs:
                ts = ctx.ts
                if (ctx.g.n_out and not ts.is_shard
                        and sel.size * ts.plane0.shape[1] * 8 > 512 << 20):
                    ts.prefault()

        bcf_writer = getattr(opt, "bcf_writer", None)
        if bcf_writer is not None:
            self._emit_bcf(bcf_writer, sel, mv, an, ac, ac_m,
                           gan if n_groups > 1 else None,
                           gac if n_groups > 1 else None,
                           gac_m if n_groups > 1 else None,
                           info_on, no_gt)
            return

        if bm.fields:  # -t table mode: exact scalar field evaluation
            gen = self._compile_fields(counts, mv)
            write = out.write
            for i in sel.tolist():
                write(gen(i) + "\n")
            return

        gt_codes_fn = None
        gt_planes_spec = None
        if not no_gt:
            mgs_off = 0
            per_db_cols = []
            for ctx in self.dbs:
                m = ctx.g.n_out
                per_db_cols.append(ctx.gt_cols(np.asarray(bm.mgs[mgs_off: mgs_off + m])))
                mgs_off += m
            from .. import native
            if (len(self.dbs) == 1 and per_db_cols[0].size
                    and not self.dbs[0].ts.is_shard
                    and native.get_lib() is not None):
                # zero-copy dump: the native emitter reads the packed planes
                # (a shard store holds only local columns — its GT goes
                # through the mesh all_gather in pairs_for instead)
                gt_planes_spec = (self.dbs[0], per_db_cols[0])

            def gt_codes_fn(msel: np.ndarray) -> np.ndarray:
                """(sites, samples) uint8 GT cell indices across databases."""
                blocks = []
                for d, ctx in enumerate(self.dbs):
                    cols = per_db_cols[d]
                    if cols.size == 0:
                        continue
                    pres = mv.pres[msel, d]
                    have = pres >= 0
                    # missing record: both haplotypes read code 2 -> idx 10
                    block = np.full((msel.size, cols.size // 2), 10, dtype=np.uint8)
                    if have.any():
                        block[have] = ctx.pairs_for(pres[have], cols)
                    blocks.append(block)
                if not blocks:
                    return np.zeros((msel.size, 0), dtype=np.uint8)
                return np.concatenate(blocks, axis=1) if len(blocks) > 1 else blocks[0]

        with stage("emit"):
            self._emit_vcf_lines(out, sel, mv, an, ac, ac_m,
                                 gan if n_groups > 1 else None,
                                 gac if n_groups > 1 else None,
                                 gac_m if n_groups > 1 else None,
                                 info_on, gt_codes_fn, ctg_names,
                                 gt_planes_spec)

    def _accumulate_al_hap(self, sel, mv: MergedSites) -> None:
        """-S/-H accumulators, batched over the tile store.

        Replaces the reference's per-site scalar loops (bgt.c:859-876):
        alcnt is a per-sample reduction over the selected sites, hapcnt a
        per-haplotype bitmask OR — both one vectorized pass over the
        decoded pair matrix per database."""
        bm = self.bm
        h_al = bm.h_al
        do_al = bool(bm.flag & engine.F_CNT_AL) and bm.alcnt is not None
        do_hap = bool(bm.flag & engine.F_CNT_HAP) and bm.hap is not None
        n_sites = sel.size
        base = len(bm.aal)
        # per site: canonical allele key + count target (al_present,
        # bgt.c:252-270: alt-key match -> count code 1, else the ref key
        # matched -> count code 0; the -a prefilter guarantees one matches)
        targets = np.ones(n_sites, dtype=np.uint8)
        ctg = [n for n, _ in bm.h_out.ids[bcflib.BCF_DT_CTG]]
        for k, i in enumerate(sel.tolist()):
            ref = mv.ref_s(i)
            alt = mv.alt_s(i).split(",", 1)[0]
            min_l = min(len(ref), len(alt))
            shift = 0
            while shift < min_l and ref[shift] == alt[shift]:
                shift += 1
            chrom = ctg[int(mv.rid[i])]
            pos = int(mv.pos[i]) + shift
            rl = int(mv.rlen[i]) - shift
            al = alt[shift:]
            if f"{chrom}:{pos}:{rl}:{al}" not in h_al:
                targets[k] = 0
            bm.aal.append(engine.Allele(chrom, pos, rl, al, int(mv.rid[i])))
        if not (do_al or do_hap) or bm.n_out == 0 or n_sites == 0:
            return
        # x86 shift semantics (count mod 64), as the reference's 1ULL<<n
        weights = np.uint64(1) << ((np.uint64(base)
                                    + np.arange(n_sites, dtype=np.uint64))
                                   & np.uint64(63))
        s_off = 0
        for d, ctx in enumerate(self.dbs):
            g = ctx.g
            m = g.n_out
            if m == 0:
                continue
            pres = mv.pres[sel, d]
            have = pres >= 0
            ts = ctx.ts
            if not have.any():
                s_off += m
                continue
            # absent records contribute nothing: both haplotypes read as
            # missing (pair 2,2), which never matches target 0/1 nor the
            # hapcnt code==1 test — so only present rows are touched
            if ts.is_shard:
                # column-slice store: pairs come through the mesh gather
                cols = np.empty(m * 2, dtype=np.int64)
                cols[0::2] = np.asarray(g.out) * 2
                cols[1::2] = np.asarray(g.out) * 2 + 1
                pairs = ctx.pairs_for(pres[have], cols)
                g1 = pairs >> 2
                g2 = pairs & 3
                if do_al:
                    t = targets[have][:, None]
                    bm.alcnt[s_off: s_off + m] += \
                        ((g1 == t) | (g2 == t)).sum(axis=0)
                if do_hap:
                    w_h = weights[have]
                    h1 = np.bitwise_or.reduce(
                        (g1 == 1).astype(np.uint64) * w_h[:, None], axis=0)
                    h2 = np.bitwise_or.reduce(
                        (g2 == 1).astype(np.uint64) * w_h[:, None], axis=0)
                    hv = bm.hap[s_off * 2: (s_off + m) * 2]
                    hv[0::2] |= h1
                    hv[1::2] |= h2
                s_off += m
                continue
            # word-level accumulation straight off the packed planes (no
            # per-pair decode; the -S/-H hot path):
            # code==1 per haplotype column is p0 & ~p1; code==0 is
            # ~p0 & ~p1; a sample carries the target when either of its
            # two adjacent column bits does (even/odd bits share a word)
            rows_h = pres[have]
            out_samples = np.asarray(g.out)
            p0 = ts.plane0[rows_h]
            p1 = ts.plane1[rows_h]
            x1 = p0 & ~p1
            if do_al:
                t_h = targets[have]
                X = x1
                if not t_h.all():
                    X = x1.copy()
                    is0 = t_h == 0
                    X[is0] = ~(p0[is0] | p1[is0])
                S = (X | (X >> np.uint32(1))) & np.uint32(0x55555555)
                per_sample = np.unpackbits(S.view(np.uint8), axis=1,
                                           bitorder="little")[:, 0::2]
                bm.alcnt[s_off: s_off + m] += \
                    per_sample[:, out_samples].sum(axis=0, dtype=np.int64)
            if do_hap:
                w_h = weights[have]
                bits1 = np.unpackbits(x1.view(np.uint8), axis=1,
                                      bitorder="little")
                cols = np.empty(m * 2, dtype=np.int64)
                cols[0::2] = out_samples * 2
                cols[1::2] = out_samples * 2 + 1
                hv = bm.hap[s_off * 2: (s_off + m) * 2]
                if np.unique(w_h).size == w_h.size:
                    # weights are pairwise-distinct single bits (always
                    # true under 64 alleles): OR == integer dot product
                    hv |= bits1[:, cols].astype(np.uint64).T @ w_h
                else:
                    # >64 alleles alias weight bits: exact scatter per site
                    inv = np.full(ts.n_words * 32, -1, dtype=np.int64)
                    inv[cols] = np.arange(cols.size, dtype=np.int64)
                    w_l = w_h.tolist()
                    for i in range(bits1.shape[0]):
                        tgt = inv[np.flatnonzero(bits1[i])]
                        tgt = tgt[tgt >= 0]
                        hv[tgt] |= w_l[i]
            s_off += m

    def _emit_vcf_lines(self, out, sel, mv: MergedSites, an, ac, ac_m,
                        gan, gac, gac_m, info_on, gt_codes_fn, ctg_names,
                        gt_planes_spec=None) -> None:
        """Assemble and write all passing site lines.

        Native path: one C call assembles every line (itoa + memcpy) from the
        columnar arrays; GT cells come from one LUT gather for the whole
        batch.  A Python fallback covers the no-native case.
        """
        n_groups = self.bm.n_groups
        from .view import _CELL_LUT

        # GT cells: native zero-copy from packed planes when possible, else
        # pair-index gathers + LUT
        cells = None
        gt_planes = None
        if gt_planes_spec is not None:
            ctx, cols = gt_planes_spec
            rows = mv.pres[sel, 0]
            ts = ctx.ts
            if (rows.size == ts.n_rows and rows.size
                    and rows[0] == 0 and rows[-1] == ts.n_rows - 1):
                # full dump: rows are the identity — no gather copy
                gt_planes = (ts.plane0, ts.plane1, cols)
            else:
                gt_planes = (ts.plane0[rows], ts.plane1[rows], cols)
            gt_codes_fn = None
        elif gt_codes_fn is not None:
            blocks = []
            for lo in range(0, sel.size, BATCH_ROWS):
                pairs = gt_codes_fn(sel[lo: lo + BATCH_ROWS])
                if pairs.shape[1] == 0:
                    gt_codes_fn = None
                    break
                blocks.append(_CELL_LUT[pairs])
            if gt_codes_fn is not None:
                cells = np.concatenate(blocks, axis=0) if len(blocks) > 1 else blocks[0]

        end_val = np.where(mv.ref_len[sel] != mv.rlen[sel],
                           mv.pos[sel] + mv.rlen[sel], -1)

        from .. import native
        if native.get_lib() is not None:
            # contig-name buffer indexed per site by rid
            names = [n.encode("latin-1") for n in ctg_names]
            name_cat = b"".join(names)
            name_lens = np.array([len(x) for x in names], dtype=np.int32)
            name_offs = np.zeros(len(names), dtype=np.int64)
            np.cumsum(name_lens[:-1], out=name_offs[1:])
            rid = mv.rid[sel]
            chunks = native.emit_vcf_lines(
                name_cat, name_offs[rid], name_lens[rid],
                (mv.pos[sel] + 1),
                mv.ref_cat, mv.ref_off[sel], mv.ref_len[sel].astype(np.int32),
                mv.alt_cat, mv.alt_off[sel], mv.alt_len[sel].astype(np.int32),
                mv.n_allele[sel], end_val,
                int(bool(info_on)), n_groups,
                an[sel], ac[sel], ac_m[sel],
                gan[sel] if gan is not None else None,
                gac[sel] if gac is not None else None,
                gac_m[sel] if gac_m is not None else None,
                cells, gt_planes)
            raw = getattr(out, "buffer", None)
            if raw is not None:
                out.flush()
                for data in chunks:
                    raw.write(memoryview(data))
                raw.flush()
            else:
                for data in chunks:
                    out.write(data.tobytes().decode("latin-1"))
            return

        # ----- Python fallback -----
        gt_strs = None
        if cells is not None:
            big = cells.tobytes().decode("latin-1")
            gt_strs = (big, 4 * cells.shape[1])
        pos1 = (mv.pos[sel] + 1).tolist()
        rid_l = mv.rid[sel].tolist()
        sel_l = sel.tolist()
        end_l = end_val.tolist()
        if info_on:
            an_l = an[sel].tolist()
            ac_l = ac[sel].tolist()
        parts: list[str] = []
        ap = parts.append
        for k in range(len(sel_l)):
            chrom = ctg_names[rid_l[k]]
            i = sel_l[k]
            multi = mv.n_allele[i] > 2
            alt_disp = mv.alt_s(i) + (",<M>" if multi else "")
            infos = []
            if end_l[k] >= 0:
                infos.append(f"END={end_l[k]}")
            if info_on:
                infos.append(f"AN={an_l[k]}")
                infos.append(f"AC={ac_l[k]},{int(ac_m[i])}" if multi
                             else f"AC={ac_l[k]}")
                if n_groups > 1:
                    for gi in range(n_groups):
                        infos.append(f"AN{gi + 1}={int(gan[i, gi])}")
                        infos.append(
                            f"AC{gi + 1}={int(gac[i, gi])},{int(gac_m[i, gi])}"
                            if multi else f"AC{gi + 1}={int(gac[i, gi])}")
            line = (f"{chrom}\t{pos1[k]}\t.\t{mv.ref_s(i)}\t{alt_disp}\t0\t.\t"
                    + (";".join(infos) if infos else "."))
            if gt_strs is not None:
                big, w = gt_strs
                line += "\tGT" + big[k * w: (k + 1) * w]
            ap(line)
        ap("")
        out.write("\n".join(parts))

    def _emit_bcf(self, writer, sel, mv: MergedSites, an, ac, ac_m,
                  gan, gac, gac_m, info_on, no_gt) -> None:
        """Batched binary BCF record emission (single DB, native).

        Records are serialized in ~48 MiB batches so the BGZF writer's
        background deflate pipeline overlaps compression with assembly
        (2-stage pipeline; a single monolithic emit call would leave the
        compressor idle for its whole duration)."""
        from .. import native
        bm = self.bm
        ctx = self.dbs[0]
        cols = None
        if not no_gt:
            cols = ctx.gt_cols(np.asarray(bm.mgs))
            if not cols.size:
                cols = None
        h = bm.h_out
        n_groups = bm.n_groups
        gan_ids = [h.id2int(bcflib.BCF_DT_ID, f"AN{g + 1}")
                   for g in range(n_groups)]
        gac_ids = [h.id2int(bcflib.BCF_DT_ID, f"AC{g + 1}")
                   for g in range(n_groups)]
        end_all = np.where(mv.ref_len[sel] != mv.rlen[sel],
                           mv.pos[sel] + mv.rlen[sel], -1)
        rec_bytes = 128 + (cols.size // 2 if cols is not None else 0)
        batch = max(512, (48 << 20) // rec_bytes)
        ts = ctx.ts
        for lo in range(0, sel.size, batch):
            bsel = sel[lo: lo + batch]
            gt_planes = None
            if cols is not None:
                rows = mv.pres[bsel, 0]
                if ts.is_shard:
                    # mesh all_gather assembles the pairs; repack them into
                    # dense output-column planes for the native serializer
                    gt_planes = _planes_from_pairs(
                        ctx.pairs_for(rows, cols))
                elif (bsel.size == ts.n_rows and bsel.size
                        and rows[0] == 0 and rows[-1] == ts.n_rows - 1):
                    gt_planes = (ts.plane0, ts.plane1, cols)
                else:
                    gt_planes = (ts.plane0[rows], ts.plane1[rows], cols)
            data = native.emit_bcf_records(
                mv.rid[bsel], mv.pos[bsel], mv.rlen[bsel],
                mv.ref_cat, mv.ref_off[bsel],
                mv.ref_len[bsel].astype(np.int32),
                mv.alt_cat, mv.alt_off[bsel],
                mv.alt_len[bsel].astype(np.int32),
                mv.n_allele[bsel], end_all[lo: lo + batch],
                int(bool(info_on)), n_groups,
                an[bsel], ac[bsel], ac_m[bsel],
                gan[bsel] if gan is not None else None,
                gac[bsel] if gac is not None else None,
                gac_m[bsel] if gac_m is not None else None,
                h.id2int(bcflib.BCF_DT_ID, "END"),
                h.id2int(bcflib.BCF_DT_ID, "AN"),
                h.id2int(bcflib.BCF_DT_ID, "AC"),
                gan_ids, gac_ids,
                h.id2int(bcflib.BCF_DT_ID, "GT"),
                gt_planes)
            for chunk in data:
                writer.write(memoryview(chunk))

    def _truncate_server(self, mv: MergedSites, sel: np.ndarray,
                         max_gt: int | None, max_read: int | None):
        """Server-loop truncation (reference bgt-server.go:330-352), exactly
        mirroring the general path's n_gt_read accounting (engine.read_core:
        per merged-site read, every DB with records remaining adds n_out;
        filter-failed sites are read and counted too).

        Returns (sel_emitted, marker): the passing sites the reference loop
        would emit before hitting either quota, and whether the trailing
        ``*`` truncation marker is due.
        """
        n = mv.n
        g = np.zeros(n, dtype=np.int64)
        for d, ctx in enumerate(self.dbs):
            if ctx.g.n_out == 0:
                continue
            idx = np.nonzero(mv.pres[:, d] >= 0)[0]
            if idx.size:
                g[: int(idx[-1]) + 1] += ctx.g.n_out
        cum = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(g, out=cum[1:])  # cum[i+1] = gt read after sites 0..i
        e = sel.size
        limit_n = e if max_read is None else min(e, max_read + 1)
        if max_gt is not None and e:
            # before emitting passing site k (0-based), the loop has read
            # through merged index sel[k-1]; it breaks when that count
            # exceeds max_gt
            before = np.concatenate([[0], cum[sel[:-1] + 1]])
            exceed = np.nonzero(before > max_gt)[0]
            k_gt = e if exceed.size == 0 else int(exceed[0])
        else:
            k_gt = e
        k = min(limit_n, k_gt)
        if k < e:
            return sel[:k], True
        # everything passing was emitted; the loop then drains trailing
        # filtered sites to EOF, so the final check sees the full-stream
        # gt count and the post-loop n_read
        marker = (max_read is not None and e > max_read) or \
            (max_gt is not None and cum[n] > max_gt)
        return sel, marker

    def _site_info(self, i: int, counts: np.ndarray) -> engine.SiteInfo:
        ss = engine.SiteInfo()
        ss.n_groups = self.bm.n_groups
        tot = counts[i].sum(axis=0)
        ss.an = int(tot[0] + tot[1] + tot[3])
        ss.ac = [int(tot[1]), int(tot[3])]
        if ss.n_groups > 1:
            ss.gan = [int(counts[i, g, 0] + counts[i, g, 1] + counts[i, g, 3])
                      for g in range(ss.n_groups)]
            ss.gac = [[int(counts[i, g, 1]), int(counts[i, g, 3])]
                      for g in range(ss.n_groups)]
        return ss

    def _compile_fields(self, counts, mv: MergedSites):
        """Per-site table-line generator using scalar kexpr eval (exact)."""
        bm = self.bm
        ctg_names = [n for n, _ in bm.h_out.ids[bcflib.BCF_DT_CTG]]

        def gen(i: int) -> str:
            ss = self._site_info(i, counts)
            parts = []
            for ke in bm.fields:
                bm._assign_expr(ke, ss)
                ke.set_str("CHROM", ctg_names[int(mv.rid[i])])
                ke.set_int("POS", int(mv.pos[i]) + 1)
                ke.set_int("END", int(mv.pos[i] + mv.rlen[i]))
                ke.set_str("REF", mv.ref_s(i))
                ke.set_str("ALT", mv.alt_s(i))
                err, iv, rv, sv, t = ke.eval()
                if err:
                    parts.append("*")
                elif t == kexpr.KEV_INT:
                    parts.append(str(iv))
                elif t == kexpr.KEV_REAL:
                    parts.append(kexpr.fmt_real(rv))
                else:
                    parts.append(sv)
            return "\t".join(parts)

        return gen
