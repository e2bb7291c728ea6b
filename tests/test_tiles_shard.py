"""Streaming GTC build (bounded memory) + column-slice shard artifacts.

The tile build must stream (peak RSS O(block), not
O(matrix)) and a host must be able to load only its sample-column slice
from disk (the reference's own scale-out seam is one DB per sub-cohort,
bgt.c:829-842; SURVEY §7.5)."""

import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from bgt_tpu import native
from bgt_tpu.formats.pbf import PbfWriter
from bgt_tpu.ops.tiles import TileStore

REPO = Path(__file__).resolve().parent.parent


def make_pbf(path, codes, shift=4):
    w = PbfWriter(str(path), codes.shape[1], 2, shift)
    for row in codes:
        w.write_row([row & 1, row >> 1])
    w.close()


def test_streaming_builders_byte_identical(tmp_path):
    """native streaming, python streaming, and in-RAM builders produce the
    same .gtc bytes."""
    rng = np.random.default_rng(11)
    codes = rng.choice(4, size=(300, 133), p=[0.7, 0.2, 0.05, 0.05]).astype(np.uint8)
    make_pbf(tmp_path / "t.pbf", codes)
    ts = TileStore.from_pbf(str(tmp_path / "t.pbf"))
    ts.save(str(tmp_path / "ram.gtc"))
    assert TileStore.build_gtc(str(tmp_path / "t.pbf"),
                               str(tmp_path / "py.gtc")) == 300
    assert (tmp_path / "py.gtc").read_bytes() == (tmp_path / "ram.gtc").read_bytes()
    if native.get_lib() is not None:
        assert native.gtc_from_pbf(str(tmp_path / "t.pbf"),
                                   str(tmp_path / "nat.gtc")) == 300
        assert (tmp_path / "nat.gtc").read_bytes() == \
            (tmp_path / "ram.gtc").read_bytes()


def test_streaming_build_multiblock(tmp_path):
    """More rows than one 8MB block at a tiny width still round-trips."""
    rng = np.random.default_rng(12)
    codes = rng.choice(4, size=(77, 33)).astype(np.uint8)
    make_pbf(tmp_path / "t.pbf", codes)
    # force multiple blocks through the python builder
    import bgt_tpu.ops.tiles as tiles
    ts0 = TileStore.from_codes(codes)
    real_max = max
    TileStore.build_gtc.__func__.__defaults__  # no-op: documents signature
    n = TileStore.build_gtc(str(tmp_path / "t.pbf"), str(tmp_path / "s.gtc"))
    assert n == 77
    ts = TileStore.load(str(tmp_path / "s.gtc"))
    assert np.array_equal(ts.codes(np.arange(77)), codes)
    assert np.array_equal(ts.rowstats, ts0.rowstats)


def test_shard_roundtrip(tmp_path):
    rng = np.random.default_rng(13)
    m = 40 * 32  # 40 words
    codes = rng.choice(4, size=(120, m)).astype(np.uint8)
    make_pbf(tmp_path / "db.pbf", codes)
    full = TileStore.open_or_build(str(tmp_path / "db"))
    paths = TileStore.emit_shards(str(tmp_path / "db"), n_proc=2, n_dev_total=8)
    assert [os.path.basename(p) for p in paths] == \
        ["db.gtc.shard-0-of-2", "db.gtc.shard-1-of-2"]
    off = 0
    for p in paths:
        sh = TileStore.load(p)
        assert sh.is_shard and sh.n_rows == 120 and sh.m == m
        assert sh.n_words == full.plane0.shape[1]
        assert sh.word_offset == off
        w = sh.plane0.shape[1]
        assert np.array_equal(sh.plane0, full.plane0[:, off:off + w])
        assert np.array_equal(sh.plane1, full.plane1[:, off:off + w])
        # global rowstats travel with every shard
        assert np.array_equal(sh.rowstats, full.rowstats)
        off += w
    assert off >= full.n_words
    # shards refuse the decode path loudly
    sh = TileStore.load(paths[0])
    with pytest.raises(ValueError, match="full tile"):
        sh.codes(np.arange(3))


def test_shard_env_open(tmp_path, monkeypatch):
    rng = np.random.default_rng(14)
    codes = rng.choice(4, size=(50, 96)).astype(np.uint8)
    make_pbf(tmp_path / "db.pbf", codes)
    TileStore.emit_shards(str(tmp_path / "db"), n_proc=2, n_dev_total=8)
    monkeypatch.setenv("BGT_TPU_TILE_SHARD", "1:2")
    ts = TileStore.open_or_build(str(tmp_path / "db"))
    assert ts.is_shard and ts.word_offset > 0
    monkeypatch.setenv("BGT_TPU_TILE_SHARD", "3:4")
    with pytest.raises(FileNotFoundError):
        TileStore.open_or_build(str(tmp_path / "db"))


BUILD_RSS_SCRIPT = r"""
import resource, sys
sys.path.insert(0, %(repo)r)
from bgt_tpu import native
assert native.get_lib() is not None, "native library did not load"
# cap the HEAP well below the full-matrix size AFTER the imports/dlopen:
# the streaming build must succeed anyway (the old builder malloc'd both
# full planes: ~%(plane_mb)d MB)
resource.setrlimit(resource.RLIMIT_DATA, (%(cap)d, %(cap)d))
n = native.gtc_from_pbf(%(pbf)r, %(gtc)r)
print("rows", n)
"""


def test_native_build_bounded_memory(tmp_path):
    """GTC build of a matrix larger than the allowed heap: the old
    implementation held both full planes in RAM;
    the streaming build completes under a hard RLIMIT_DATA cap."""
    if native.get_lib() is None:
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(15)
    m = 16384
    n_rows = 40_000
    chunk = 8192
    from bgt_tpu.native import NativePbfWriter
    w = NativePbfWriter(str(tmp_path / "big.pbf"), m, 2, 13)
    stats_want = []
    for lo in range(0, n_rows, chunk):
        codes = rng.integers(0, 4, size=(min(chunk, n_rows - lo), m),
                             dtype=np.uint8)
        w.write_codes(codes)
        stats_want.append(TileStore.from_codes(codes).rowstats)
    w.close()
    plane_bytes = 2 * n_rows * (m // 8)  # 205 MB: what the old builder held
    cap = 128 << 20
    assert plane_bytes > cap
    script = BUILD_RSS_SCRIPT % {"repo": str(REPO), "cap": cap,
                                 "plane_mb": plane_bytes >> 20,
                                 "pbf": str(tmp_path / "big.pbf"),
                                 "gtc": str(tmp_path / "big.gtc")}
    res = subprocess.run([sys.executable, "-c", script], capture_output=True)
    assert res.returncode == 0, res.stderr.decode()[-2000:]
    assert f"rows {n_rows}" in res.stdout.decode()
    ts = TileStore.load(str(tmp_path / "big.gtc"))
    assert np.array_equal(ts.rowstats, np.vstack(stats_want))


def test_interrupted_gtc_build_not_loadable(tmp_path, monkeypatch):
    """open_or_build writes to a temp path + renames: a killed build must
    never leave a loadable-looking .gtc with zeroed planes."""
    rng = np.random.default_rng(19)
    codes = rng.choice(4, size=(50, 64)).astype(np.uint8)
    make_pbf(tmp_path / "db.pbf", codes)
    import bgt_tpu.ops.tiles as tiles
    from bgt_tpu import native as nat
    monkeypatch.setattr(nat, "gtc_from_pbf",
                        lambda *a, **k: (_ for _ in ()).throw(OSError("x")))
    calls = {}
    orig = TileStore.build_gtc.__func__

    def dying(cls, pbf, gtc):
        orig(cls, pbf, gtc)  # writes the temp file fully...
        raise KeyboardInterrupt  # ...but the build "dies" before rename

    monkeypatch.setattr(TileStore, "build_gtc", classmethod(dying))
    with pytest.raises(KeyboardInterrupt):
        TileStore.open_or_build(str(tmp_path / "db"))
    assert not (tmp_path / "db.gtc").exists()
    import glob
    assert not glob.glob(str(tmp_path / "db.gtc.tmp*")), "temp not cleaned"
    monkeypatch.undo()


def test_emit_shards_rejects_too_wide_mesh(tmp_path):
    rng = np.random.default_rng(20)
    codes = rng.choice(4, size=(30, 40)).astype(np.uint8)  # 32 words padded
    make_pbf(tmp_path / "db.pbf", codes)
    with pytest.raises(ValueError, match="wider"):
        TileStore.emit_shards(str(tmp_path / "db"), n_proc=64, n_dev_total=64)


def test_planes_from_pairs_roundtrip():
    """The shard-GT repack adapter (mesh-gathered pairs -> dense planes for
    the native BCF serializer) must decode back to the same pair matrix."""
    import numpy as np
    from bgt_tpu.query.fastpath import _planes_from_pairs

    rng = np.random.default_rng(7)
    pairs = rng.integers(0, 16, size=(23, 37), dtype=np.uint8)
    p0, p1, cols = _planes_from_pairs(pairs)
    assert cols.tolist() == list(range(37 * 2))
    b0 = np.unpackbits(p0.view(np.uint8), axis=1, bitorder="little")
    b1 = np.unpackbits(p1.view(np.uint8), axis=1, bitorder="little")
    codes = ((b1 << 1) | b0)[:, : 37 * 2]
    back = (codes[:, 0::2] << 2) | codes[:, 1::2]
    assert np.array_equal(back, pairs)
