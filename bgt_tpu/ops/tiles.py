"""Genotype tile store: HBM-friendly packed 2-bit genotype matrix.

The device layout for a BGT database.  The on-disk PBF stays the
compact interchange format (PBWT+RLE, reference-compatible); at import time
(or lazily on first query) the matrix is ALSO materialized as two bit-planes
packed 32 haplotypes per uint32 word, row-major:

    plane0: (n_rows, n_words) uint32   # low genotype bit  (code & 1)
    plane1: (n_rows, n_words) uint32   # high genotype bit (code >> 1)

with genotype code = a1<<1|a0 in {0=ref, 1=alt, 2=missing, 3=<M>}
(reference acf.md:21-24).  This trades disk for speed-of-light device
scans: per-site AC/AN and per-group counts become masked popcounts on the
VPU (8 genotypes/byte of HBM traffic), replacing the reference's sequential
per-row RLE walk + scalar count loop (bgt.c:735-757, pbwt.c:129-170).

Column (haplotype) packing is little-endian within each word: haplotype j
lives in word j>>5 bit j&31, so numpy packbits(bitorder='little') and the
device kernels agree.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from ..formats.pbf import PbfReader

MAGIC_V1 = b"GTC\x01"
MAGIC = b"GTC\x02"  # v2 appends the per-row all-columns code-count aggregate
MAGIC_SHARD = b"GTS\x01"  # column-slice shard of a GTC tile
WORD_BITS = 32
# column padding: a fixed part of the GTC format (rows are whole 1024-column
# blocks, so word rows stay aligned and split evenly over mesh devices)
COL_ALIGN = 1024


def _pad_words(m: int) -> int:
    return (m + COL_ALIGN - 1) // COL_ALIGN * (COL_ALIGN // WORD_BITS)


class TileStore:
    """In-memory (optionally disk-cached) packed genotype matrix.

    A store is either *full* (planes cover all ``n_words`` columns) or a
    *shard* (planes cover global word-columns ``[word_offset, word_limit)``
    only — the on-disk artifact that lets each host of a multi-process mesh
    load just its own sample columns, generalizing the reference's
    one-database-per-sub-cohort composition, bgt.c:829-842).  ``n_words``
    always refers to the full matrix so mask layouts stay global.
    """

    def __init__(self, n_rows: int, m: int, plane0: np.ndarray, plane1: np.ndarray,
                 rowstats: np.ndarray | None = None,
                 n_words_global: int | None = None, word_offset: int = 0):
        self.n_rows = n_rows
        self.m = m  # real number of haplotype columns
        self.n_words = (plane0.shape[1] if n_words_global is None
                        else n_words_global)
        self.is_shard = n_words_global is not None
        self.word_offset = word_offset
        self.word_limit = word_offset + plane0.shape[1]
        self._plane0 = plane0
        self._plane1 = plane1
        self._map_spec = None  # (path, hdr_bytes) when memmap-backed
        # (n_rows, 4) int32 counts of codes 0..3 over all m columns — the
        # materialized aggregate behind all-samples AC/AN queries (the
        # reference recounts per query, bgt.c:735-757).  Loaded stores keep
        # the on-disk view and materialize lazily: a GT-only page against a
        # 39.2M-row database must not read the 600 MB aggregate it never
        # uses (set via _rowstats_src in :meth:`load`).
        if rowstats is None and self.is_shard:
            raise ValueError("shard stores carry the global rowstats")
        self._rowstats_src = None
        self._rowstats = (rowstats if rowstats is not None
                          else self._calc_rowstats())

    @property
    def rowstats(self) -> np.ndarray:
        if self._rowstats is None and self._rowstats_src is not None:
            self._rowstats = np.array(self._rowstats_src).reshape(
                self.n_rows, 4)
        return self._rowstats

    @property
    def plane0(self) -> np.ndarray:
        if self._plane0 is None:
            self._remap()
        return self._plane0

    @property
    def plane1(self) -> np.ndarray:
        if self._plane1 is None:
            self._remap()
        return self._plane1

    def _remap(self) -> None:
        """Re-open the mapped planes after :meth:`release`."""
        path, hdr = self._map_spec
        local_words = self.word_limit - self.word_offset
        plane_elems = self.n_rows * local_words
        data = np.memmap(path, dtype=np.uint32, mode="r", offset=hdr,
                         shape=(2 * plane_elems,))
        self._plane0 = data[:plane_elems].reshape(self.n_rows, local_words)
        self._plane1 = data[plane_elems:].reshape(self.n_rows, local_words)

    def release(self) -> None:
        """Drop this store's references to the mapped planes (LRU eviction).

        The mapping — and the file descriptor mmap dups internally — is then
        freed as soon as the last in-flight view dies, instead of waiting for
        the TileStore object itself to be collected; a straggler that still
        holds the store (not a view) transparently remaps on next access."""
        if self._map_spec is not None:
            self._plane0 = self._plane1 = None

    def _calc_rowstats(self) -> np.ndarray:
        n10 = np.bitwise_count(self.plane0).sum(axis=1, dtype=np.int32)
        n11 = np.bitwise_count(self.plane1).sum(axis=1, dtype=np.int32)
        nb = np.bitwise_count(self.plane0 & self.plane1).sum(axis=1, dtype=np.int32)
        cnt1 = n10 - nb
        cnt2 = n11 - nb
        cnt0 = np.int32(self.m) - cnt1 - cnt2 - nb
        return np.stack([cnt0, cnt1, cnt2, nb], axis=1).astype(np.int32)

    # --- construction ------------------------------------------------------

    @classmethod
    def from_pbf(cls, path: str, progress: bool = False) -> "TileStore":
        pb = PbfReader(path)
        m = pb.m
        n_words = _pad_words(m)
        rows0 = []
        rows1 = []
        n = 0
        nbytes = n_words * 4
        while True:
            planes = pb.read_row()
            if planes is None:
                break
            b0 = np.packbits(planes[0], bitorder="little")
            b1 = np.packbits(planes[1], bitorder="little")
            r0 = np.zeros(nbytes, dtype=np.uint8)
            r1 = np.zeros(nbytes, dtype=np.uint8)
            r0[: b0.size] = b0
            r1[: b1.size] = b1
            rows0.append(r0)
            rows1.append(r1)
            n += 1
        pb.close()
        if n:
            plane0 = np.vstack(rows0).view(np.uint32)
            plane1 = np.vstack(rows1).view(np.uint32)
        else:
            plane0 = np.zeros((0, n_words), np.uint32)
            plane1 = np.zeros((0, n_words), np.uint32)
        return cls(n, m, plane0, plane1)

    @classmethod
    def from_codes(cls, codes: np.ndarray) -> "TileStore":
        """Build from a (n_rows, m) uint8 code matrix (tests, import)."""
        n, m = codes.shape
        nbytes = _pad_words(m) * 4
        p0 = np.packbits(codes & 1, axis=1, bitorder="little")
        p1 = np.packbits(codes >> 1, axis=1, bitorder="little")
        out0 = np.zeros((n, nbytes), np.uint8)
        out1 = np.zeros((n, nbytes), np.uint8)
        out0[:, : p0.shape[1]] = p0
        out1[:, : p1.shape[1]] = p1
        return cls(n, m, out0.view(np.uint32), out1.view(np.uint32))

    @classmethod
    def build_gtc(cls, pbf_path: str, gtc_path: str) -> int | None:
        """Streaming PBF -> GTC build with O(block) memory (python fallback
        of the native ``bgt_gtc_from_pbf``; reference streams one row at a
        time too, pbwt.c:313-337).  Returns n_rows, or None when the PBF has
        no footer (pipe-written) and the caller must use :meth:`from_pbf`."""
        pb = PbfReader(pbf_path)
        n_rows = pb.n
        if n_rows <= 0 and pb.idx.size == 0:
            pb.close()
            return None
        m = pb.m
        n_words = _pad_words(m)
        row_bytes = n_words * 4
        hdr = 20
        plane_bytes = n_rows * row_bytes
        stats_off = hdr + 2 * plane_bytes
        block = max(16, (8 << 20) // row_bytes)
        with open(gtc_path, "wb") as fp:
            fp.write(MAGIC)
            fp.write(struct.pack("<qii", n_rows, m, n_words))
            r = 0
            while r < n_rows:
                nb = min(block, n_rows - r)
                rows0 = np.zeros((nb, row_bytes), np.uint8)
                rows1 = np.zeros((nb, row_bytes), np.uint8)
                for i in range(nb):
                    planes = pb.read_row()
                    if planes is None:
                        raise ValueError("PBF ended before footer row count")
                    b0 = np.packbits(planes[0], bitorder="little")
                    b1 = np.packbits(planes[1], bitorder="little")
                    rows0[i, : b0.size] = b0
                    rows1[i, : b1.size] = b1
                w0 = rows0.view(np.uint32)
                w1 = rows1.view(np.uint32)
                n10 = np.bitwise_count(w0).sum(axis=1, dtype=np.int32)
                n11 = np.bitwise_count(w1).sum(axis=1, dtype=np.int32)
                both = np.bitwise_count(w0 & w1).sum(axis=1, dtype=np.int32)
                cnt1 = n10 - both
                cnt2 = n11 - both
                stats = np.stack([np.int32(m) - cnt1 - cnt2 - both,
                                  cnt1, cnt2, both], axis=1).astype(np.int32)
                fp.seek(hdr + r * row_bytes)
                fp.write(rows0.tobytes())
                fp.seek(hdr + plane_bytes + r * row_bytes)
                fp.write(rows1.tobytes())
                fp.seek(stats_off + r * 16)
                fp.write(stats.tobytes())
                r += nb
        pb.close()
        return n_rows

    # --- disk cache --------------------------------------------------------

    def save(self, path: str) -> None:
        assert not self.is_shard
        with open(path, "wb") as fp:
            fp.write(MAGIC)
            fp.write(struct.pack("<qii", self.n_rows, self.m, self.n_words))
            fp.write(np.ascontiguousarray(self.plane0).tobytes())
            fp.write(np.ascontiguousarray(self.plane1).tobytes())
            fp.write(np.ascontiguousarray(self.rowstats).tobytes())

    def save_shard(self, path: str, w0: int, w1: int,
                   block_rows: int = 16384) -> None:
        """Emit global word-columns [w0, w1) as a shard file, streamed in
        row blocks so the full planes are never materialized."""
        assert not self.is_shard and 0 <= w0 < w1 <= self.n_words
        with open(path, "wb") as fp:
            fp.write(MAGIC_SHARD)
            fp.write(struct.pack("<qiiii", self.n_rows, self.m, self.n_words,
                                 w0, w1))
            for plane in (self.plane0, self.plane1):
                for lo in range(0, self.n_rows, block_rows):
                    fp.write(np.ascontiguousarray(
                        plane[lo: lo + block_rows, w0:w1]).tobytes())
            fp.write(np.ascontiguousarray(self.rowstats).tobytes())

    @classmethod
    def load(cls, path: str) -> "TileStore":
        """Memory-map the planes (read-only): cold-start queries that are
        served by the rowstats aggregate never fault the matrix in at all.
        Accepts full GTC tiles and GTS column-slice shards."""
        with open(path, "rb") as fp:
            magic = fp.read(4)
            if magic == MAGIC_SHARD:
                n_rows, m, n_words, w0, w1 = struct.unpack("<qiiii",
                                                           fp.read(24))
            elif magic in (MAGIC, MAGIC_V1):
                n_rows, m, n_words = struct.unpack("<qii", fp.read(16))
                w0, w1 = 0, n_words
            else:
                raise ValueError("not a GTC tile file")
            hdr = fp.tell()
        local_words = w1 - w0
        plane_elems = n_rows * local_words
        data = np.memmap(path, dtype=np.uint32, mode="r", offset=hdr,
                         shape=(2 * plane_elems,))
        stats_src = None
        if magic != MAGIC_V1:
            raw = np.memmap(path, dtype=np.int32, mode="r",
                            offset=hdr + 8 * plane_elems)
            if raw.size >= 4 * n_rows:
                stats_src = raw[: 4 * n_rows]
        plane0 = data[:plane_elems].reshape(n_rows, local_words)
        plane1 = data[plane_elems:].reshape(n_rows, local_words)
        if magic == MAGIC_SHARD:
            # a truncated shard file leaves stats_src None; let the
            # constructor raise its intended ValueError rather than an
            # AttributeError on .reshape
            ts = cls(n_rows, m, plane0, plane1,
                     rowstats=(stats_src.reshape(n_rows, 4)
                               if stats_src is not None else None),
                     n_words_global=n_words, word_offset=w0)
        else:
            ts = cls(n_rows, m, plane0, plane1,
                     rowstats=(stats_src.reshape(n_rows, 4)
                               if stats_src is not None else None))
        if stats_src is not None:
            # defer materialization to first aggregate use (property)
            ts._rowstats = None
            ts._rowstats_src = stats_src
        ts._path = path
        ts._map_spec = (path, hdr)
        return ts

    def prefault(self) -> None:
        """Sequentially warm the page cache beneath the memory-mapped
        planes.  Bulk dumps touch every page; letting the memmap fault
        4 KiB at a time costs ~10x a buffered pass on a cold cache
        (measured 23.4s -> 14.0s for a cold full ``view -b`` at the HRC
        bench shape)."""
        path = getattr(self, "_path", None)
        if path is None or getattr(self, "_prefaulted", False):
            return
        self._prefaulted = True
        buf = bytearray(32 << 20)
        try:
            with open(path, "rb", buffering=0) as fp:
                while fp.readinto(buf):
                    pass
        except OSError:
            pass

    def prefault_range(self, lo_row: int, hi_row: int) -> None:
        """Sequentially warm the page cache for rows [lo_row, hi_row) of
        BOTH planes (region-bounded :meth:`prefault`): a cold region
        subset on a multi-GB tile otherwise faults 4 KiB at a time.

        Row ranges warmed by this process are tracked and skipped on
        repeat: re-reading an already-cached 1.2 GB span costs ~0.25 s of
        pure buffer-cache copying, which dominated the warm HRC-scale
        subset query."""
        path = getattr(self, "_path", None)
        if path is None or self._map_spec is None:
            return
        if getattr(self, "_prefaulted", False):
            return
        warmed = getattr(self, "_warm_rows", None)
        if warmed is None:
            warmed = self._warm_rows = []
        for wlo, whi in warmed:
            if lo_row >= wlo and hi_row <= whi:
                return
            # trim the request to the uncovered tail/head on partial overlap
            if wlo <= lo_row < whi:
                lo_row = whi
            if wlo < hi_row <= whi:
                hi_row = wlo
        if hi_row <= lo_row:
            return
        warmed.append((lo_row, hi_row))
        hdr = self._map_spec[1]
        row_bytes = (self.word_limit - self.word_offset) * 4
        plane_bytes = self.n_rows * row_bytes
        buf = bytearray(16 << 20)
        try:
            with open(path, "rb", buffering=0) as fp:
                for base in (hdr, hdr + plane_bytes):
                    fp.seek(base + lo_row * row_bytes)
                    left = (hi_row - lo_row) * row_bytes
                    while left > 0:
                        n = fp.readinto(
                            memoryview(buf)[: min(len(buf), left)])
                        if not n:
                            break
                        left -= n
        except OSError:
            pass

    @classmethod
    def open_or_build(cls, prefix: str) -> "TileStore":
        """Load ``prefix.gtc`` if fresh, else build from ``prefix.pbf``.

        ``BGT_TPU_TILE_SHARD=K:N`` (or an explicit path) makes this process
        open only its column-slice shard ``prefix.gtc.shard-K-of-N`` — the
        per-host load path for multi-process meshes; a missing shard file is
        a loud error, never a silent fallback to the full tile."""
        shard = os.environ.get("BGT_TPU_TILE_SHARD")
        if shard:
            if ":" in shard and not os.path.exists(shard):
                k, n = shard.split(":", 1)
                shard = f"{prefix}.gtc.shard-{int(k)}-of-{int(n)}"
            if not os.path.exists(shard):
                raise FileNotFoundError(
                    f"BGT_TPU_TILE_SHARD set but '{shard}' does not exist; "
                    f"emit shards with TileStore.emit_shards('{prefix}', ...)")
            return cls.load(shard)
        gtc = prefix + ".gtc"
        pbf = prefix + ".pbf"
        if os.path.exists(gtc) and os.path.getmtime(gtc) >= os.path.getmtime(pbf):
            return cls.load(gtc)
        # build into a temp path and rename: the streaming writers pwrite at
        # final offsets, so an interrupted build would otherwise leave a
        # full-size, header-complete file that loads with zeroed planes
        tmp = f"{gtc}.tmp{os.getpid()}"
        from .. import native
        try:
            try:
                if native.gtc_from_pbf(pbf, tmp) is not None:
                    os.replace(tmp, gtc)
                    return cls.load(gtc)
            except OSError:
                pass
            if cls.build_gtc(pbf, tmp) is not None:
                os.replace(tmp, gtc)
                return cls.load(gtc)
            ts = cls.from_pbf(pbf)
            try:
                ts.save(tmp)
                os.replace(tmp, gtc)
            except OSError:
                pass
            return ts
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    @classmethod
    def emit_shards(cls, prefix: str, n_proc: int,
                    n_dev_total: int) -> list[str]:
        """Split ``prefix.gtc`` into per-process column-slice files whose
        boundaries match a ``n_dev_total``-device mesh spread over
        ``n_proc`` processes (distributed.local_column_range)."""
        from ..parallel import mesh as meshlib
        ts = cls.open_or_build(prefix)
        words = meshlib.pad_words_for_mesh(ts.n_words, n_dev_total)
        per_dev = words // n_dev_total
        dpp = n_dev_total // n_proc
        if (n_proc - 1) * dpp * per_dev >= ts.n_words:
            raise ValueError(
                f"mesh ({n_proc} processes x {n_dev_total // n_proc} devices)"
                f" is wider than the {ts.n_words}-word matrix: the last "
                "process would own no real columns — use fewer processes")
        paths = []
        for k in range(n_proc):
            lo = k * dpp * per_dev
            hi = min((k + 1) * dpp * per_dev, ts.n_words)
            path = f"{prefix}.gtc.shard-{k}-of-{n_proc}"
            ts.save_shard(path, lo, hi)
            paths.append(path)
        return paths

    # --- masks -------------------------------------------------------------

    def all_mask(self) -> np.ndarray:
        """(n_words,) uint32 mask covering all m real columns."""
        mask = np.zeros(self.n_words, dtype=np.uint32)
        full, rem = divmod(self.m, WORD_BITS)
        mask[:full] = 0xFFFFFFFF
        if rem:
            mask[full] = (1 << rem) - 1
        return mask

    def pack_mask(self, cols: np.ndarray) -> np.ndarray:
        """(n_words,) uint32 mask with the given haplotype columns set."""
        bits = np.zeros(self.n_words * WORD_BITS, dtype=np.uint8)
        bits[np.asarray(cols, dtype=np.int64)] = 1
        return np.packbits(bits, bitorder="little").view(np.uint32)

    def group_masks(self, group_of_sample: np.ndarray, n_groups: int,
                    sample_cols: np.ndarray) -> np.ndarray:
        """(n_groups, n_words) masks; sample i covers columns 2i, 2i+1.

        ``group_of_sample``: per-output-sample group id (1-based, as in the
        reference's group[] array); ``sample_cols``: original sample index
        per output sample.
        """
        masks = np.zeros((n_groups, self.n_words), dtype=np.uint32)
        for g in range(1, n_groups + 1):
            samples = sample_cols[group_of_sample == g]
            cols = np.empty(samples.size * 2, dtype=np.int64)
            cols[0::2] = samples * 2
            cols[1::2] = samples * 2 + 1
            masks[g - 1] = self.pack_mask(cols)
        return masks

    # --- decode ------------------------------------------------------------

    def codes(self, rows: np.ndarray, cols: np.ndarray | None = None) -> np.ndarray:
        """(len(rows), m or len(cols)) uint8 genotype codes (host path)."""
        if self.is_shard:
            raise ValueError(
                "genotype decode needs the full tile; this process holds "
                f"only word-columns [{self.word_offset},{self.word_limit}) — "
                "run GT-emitting queries against the full .gtc")
        p0 = self.plane0[rows]
        p1 = self.plane1[rows]
        b0 = np.unpackbits(p0.view(np.uint8), axis=1, bitorder="little")
        b1 = np.unpackbits(p1.view(np.uint8), axis=1, bitorder="little")
        codes = (b1 << 1) | b0
        if cols is not None:
            return codes[:, cols]
        return codes[:, : self.m]
