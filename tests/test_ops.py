"""Device kernel correctness: tiles, counts, decode, sharded counts."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bgt_tpu.ops import counts as counts_ops
from bgt_tpu.ops.tiles import TileStore


def ref_counts(codes, group_cols):
    """Scalar oracle: counts of codes 0..3 per row per group."""
    out = np.zeros((codes.shape[0], len(group_cols), 4), dtype=np.int64)
    for gi, cols in enumerate(group_cols):
        sub = codes[:, cols]
        for c in range(4):
            out[:, gi, c] = (sub == c).sum(axis=1)
    return out


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    n_rows, m = 64, 333
    codes = rng.choice(4, size=(n_rows, m), p=[0.7, 0.2, 0.05, 0.05]).astype(np.uint8)
    ts = TileStore.from_codes(codes)
    return codes, ts


def test_tiles_roundtrip(data, tmp_path):
    codes, ts = data
    assert np.array_equal(ts.codes(np.arange(ts.n_rows)), codes)
    ts.save(str(tmp_path / "t.gtc"))
    ts2 = TileStore.load(str(tmp_path / "t.gtc"))
    assert np.array_equal(ts2.codes(np.arange(ts2.n_rows)), codes)


def test_tiles_from_pbf(tmp_path):
    from bgt_tpu.formats.pbf import PbfWriter
    rng = np.random.default_rng(1)
    codes = rng.choice(4, size=(50, 41)).astype(np.uint8)
    w = PbfWriter(str(tmp_path / "t.pbf"), 41, 2, 4)
    for row in codes:
        w.write_row([row & 1, row >> 1])
    w.close()
    ts = TileStore.from_pbf(str(tmp_path / "t.pbf"))
    assert np.array_equal(ts.codes(np.arange(50)), codes)


def test_rowstats_aggregate(data, tmp_path):
    """The materialized all-columns aggregate equals a full recount and
    survives the GTC v2 round-trip (native and numpy builders agree)."""
    codes, ts = data
    want = ref_counts(codes, [np.arange(ts.m)])[:, 0, :]
    assert np.array_equal(ts.rowstats, want)
    # all_mask matches pack_mask over every column
    assert np.array_equal(ts.all_mask(), ts.pack_mask(np.arange(ts.m)))
    ts.save(str(tmp_path / "t.gtc"))
    ts2 = TileStore.load(str(tmp_path / "t.gtc"))
    assert np.array_equal(ts2.rowstats, want)


def test_rowstats_native_vs_numpy(tmp_path):
    from bgt_tpu import native
    from bgt_tpu.formats.pbf import PbfWriter
    if native.get_lib() is None:
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(7)
    codes = rng.choice(4, size=(70, 97), p=[0.6, 0.3, 0.05, 0.05]).astype(np.uint8)
    w = PbfWriter(str(tmp_path / "t.pbf"), 97, 2, 4)
    for row in codes:
        w.write_row([row & 1, row >> 1])
    w.close()
    native.gtc_from_pbf(str(tmp_path / "t.pbf"), str(tmp_path / "t.gtc"))
    ts_native = TileStore.load(str(tmp_path / "t.gtc"))
    ts_np = TileStore.from_pbf(str(tmp_path / "t.pbf"))
    assert np.array_equal(ts_native.rowstats, ts_np.rowstats)
    assert np.array_equal(ts_native.rowstats,
                          ref_counts(codes, [np.arange(97)])[:, 0, :])


def test_count_codes(data):
    codes, ts = data
    rng = np.random.default_rng(2)
    groups = [rng.choice(ts.m, size=50, replace=False),
              rng.choice(ts.m, size=80, replace=False),
              np.arange(ts.m)]
    masks = np.stack([ts.pack_mask(g) for g in groups])
    got = np.asarray(counts_ops.count_codes(
        jnp.asarray(ts.plane0), jnp.asarray(ts.plane1), jnp.asarray(masks)))
    want = ref_counts(codes, groups)
    assert np.array_equal(got, want)


def test_decode_codes(data):
    codes, ts = data
    got = np.asarray(counts_ops.decode_codes(
        jnp.asarray(ts.plane0), jnp.asarray(ts.plane1)))[:, : ts.m]
    assert np.array_equal(got, codes)


def test_gather_codes(data):
    codes, ts = data
    cols = np.array([5, 0, 300, 17, 17, 64])
    got = np.asarray(counts_ops.gather_codes(
        jnp.asarray(ts.plane0), jnp.asarray(ts.plane1), jnp.asarray(cols),
        len(cols)))
    assert np.array_equal(got, codes[:, cols])


def test_sharded_counts_match(data):
    from bgt_tpu.parallel import mesh as meshlib
    codes, ts = data
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"
    mesh = meshlib.make_mesh()
    rng = np.random.default_rng(3)
    groups = [rng.choice(ts.m, size=70, replace=False), np.arange(ts.m)]
    masks = np.stack([ts.pack_mask(g) for g in groups])
    p0, p1, msk = meshlib.shard_planes(mesh, ts.plane0, ts.plane1, masks)
    fn = meshlib.sharded_count_fn(mesh)
    got = np.asarray(fn(p0, p1, msk))
    want = ref_counts(codes, groups)
    assert np.array_equal(got, want)


def test_sharded_gather_codes(data):
    from bgt_tpu.parallel import mesh as meshlib
    codes, ts = data
    mesh = meshlib.make_mesh()
    masks = np.stack([ts.pack_mask(np.arange(ts.m))])
    p0, p1, _ = meshlib.shard_planes(mesh, ts.plane0, ts.plane1, masks)
    fn = meshlib.sharded_gather_codes_fn(mesh)
    got = np.asarray(fn(p0, p1))[:, : ts.m]
    assert np.array_equal(got, codes)


def test_view_sharded_vs_unsharded(tmp_path, ref_bgt, monkeypatch):
    """The whole view CLI must emit identical bytes on an 8-device mesh."""
    import io
    import os
    import subprocess
    from bgt_tpu import testing
    from bgt_tpu.query import importer, fastpath
    from bgt_tpu.query.view import main_view
    vcf = testing.random_vcf(n_samples=16, n_sites=150, seed=55)
    (tmp_path / "in.vcf").write_text(vcf)
    importer.import_vcf(str(tmp_path / "db"), [str(tmp_path / "in.vcf")],
                        is_vcf=True)
    ref = subprocess.run([ref_bgt, "view", "-C", "db"], cwd=tmp_path,
                         capture_output=True, check=True).stdout.decode()

    def run(shard_env):
        monkeypatch.setenv("BGT_TPU_SHARD", shard_env)
        # force the device/mesh tier: this test is about mesh correctness,
        # not the cost model (which would route this tiny shape to host,
        # and the dispatch-crossover gate would route it to one device)
        monkeypatch.setenv("BGT_TPU_COUNT_TIER", "device")
        monkeypatch.setenv("BGT_TPU_SHARD_MIN_ROWS", "0")
        fastpath.reset_shard_context()
        buf = io.StringIO()
        old = os.getcwd()
        os.chdir(tmp_path)
        try:
            assert main_view(["-C", "db"], out=buf) == 0
        finally:
            os.chdir(old)
            fastpath.reset_shard_context()
            monkeypatch.delenv("BGT_TPU_SHARD")
        return buf.getvalue()

    sharded = run("1")
    unsharded = run("0")
    assert sharded == ref
    assert unsharded == ref


def test_device_pbwt_decode(tmp_path):
    """The lax.scan PBWT decoder matches the host codec exactly."""
    from bgt_tpu.formats.pbf import PbfWriter
    from bgt_tpu.ops import decode as dev_decode
    rng = np.random.default_rng(77)
    codes = rng.choice(4, size=(70, 90), p=[0.55, 0.3, 0.05, 0.1]).astype(np.uint8)
    # include degenerate rows (all-zero / all-one planes)
    codes[10] = 0
    codes[11] = 1
    w = PbfWriter(str(tmp_path / "t.pbf"), 90, 2, 4)  # checkpoint every 16 rows
    for row in codes:
        w.write_row([row & 1, row >> 1])
    w.close()
    got = dev_decode.decode_pbf_on_device(str(tmp_path / "t.pbf"))
    assert np.array_equal(got, codes)


def test_streaming_counts_path(tmp_path, ref_bgt, monkeypatch):
    """A tiny HBM budget forces the streaming path; bytes must not change."""
    import io
    import os
    import subprocess
    from bgt_tpu import testing
    from bgt_tpu.query import importer, fastpath
    from bgt_tpu.query.view import main_view
    vcf = testing.random_vcf(n_samples=9, n_sites=120, seed=66)
    (tmp_path / "in.vcf").write_text(vcf)
    importer.import_vcf(str(tmp_path / "db"), [str(tmp_path / "in.vcf")],
                        is_vcf=True)
    ref = subprocess.run([ref_bgt, "view", "-C", "db"], cwd=tmp_path,
                         capture_output=True, check=True).stdout.decode()
    monkeypatch.setenv("BGT_TPU_SHARD", "0")
    monkeypatch.setenv("BGT_TPU_HBM_BUDGET", "1")  # nothing fits
    fastpath.reset_shard_context()
    fastpath._DEVICE_CACHE.clear()
    buf = io.StringIO()
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        assert main_view(["-C", "db"], out=buf) == 0
    finally:
        os.chdir(old)
        fastpath._DEVICE_CACHE.clear()
        fastpath.reset_shard_context()
    assert buf.getvalue() == ref


def test_distributed_helpers_single_process():
    """distributed.py helpers in the single-process 8-device configuration."""
    import jax
    from bgt_tpu.parallel import distributed, mesh as meshlib
    from bgt_tpu.ops import counts as co
    distributed.initialize()  # no-op single process
    mesh = distributed.global_mesh()
    assert mesh.devices.size == 8
    rng = np.random.default_rng(0)
    codes = rng.choice(4, size=(32, 250)).astype(np.uint8)
    ts = TileStore.from_codes(codes)
    lo, hi = distributed.local_column_range(ts.n_words, mesh)
    assert lo == 0 and hi >= ts.n_words
    pad = hi - ts.n_words
    p0 = np.pad(ts.plane0, ((0, 0), (0, pad)))
    p1 = np.pad(ts.plane1, ((0, 0), (0, pad)))
    g0, g1 = distributed.place_local_planes(mesh, p0, p1)
    masks = np.pad(np.stack([ts.pack_mask(np.arange(ts.m))]), ((0, 0), (0, pad)))
    fn = meshlib.sharded_count_range_fn(mesh)
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    msk = jax.device_put(masks, NamedSharding(mesh, P(None, meshlib.SAMPLE_AXIS)))
    got = np.asarray(fn(g0, g1, msk, 0, 32))
    want = ref_counts(codes, [np.arange(ts.m)])
    assert np.array_equal(got, want)


def test_cost_based_count_tier(tmp_path, ref_bgt, monkeypatch):
    """A one-shot subset query on a small DB must resolve on the host and
    never touch the device: a cold CLI subset query must not pay a tile
    transfer that the host popcount beats."""
    import io
    import os
    import subprocess
    from bgt_tpu import testing
    from bgt_tpu.query import importer, fastpath
    from bgt_tpu.query.view import main_view
    vcf = testing.random_vcf(n_samples=20, n_sites=120, seed=66)
    (tmp_path / "in.vcf").write_text(vcf)
    importer.import_vcf(str(tmp_path / "db"), [str(tmp_path / "in.vcf")],
                        is_vcf=True)
    ref = subprocess.run(
        [ref_bgt, "view", "-G", "-C", "-s", ",S0001,S0002", "db"],
        cwd=tmp_path, capture_output=True, check=True).stdout.decode()
    monkeypatch.delenv("BGT_TPU_COUNT_TIER", raising=False)
    fastpath._COUNT_MEMO.clear()

    def boom(*a, **k):
        raise AssertionError("device path used for a cold small query")
    monkeypatch.setattr(fastpath, "get_device_tiles", boom)
    monkeypatch.setattr(fastpath, "stream_counts", boom)
    monkeypatch.setattr(fastpath, "get_shard_context", boom)
    buf = io.StringIO()
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        assert main_view(["-G", "-C", "-s", ",S0001,S0002", "db"],
                         out=buf) == 0
    finally:
        os.chdir(old)
    assert buf.getvalue() == ref


def test_mesh2_counts_parity():
    """2-axis (site x sample) mesh counts equal the single-device kernel
    for both (2,4) and (4,2) layouts, including row/column padding."""
    import jax
    import numpy as np
    from bgt_tpu.ops import counts as counts_ops
    from bgt_tpu.parallel import mesh as meshlib

    rng = np.random.default_rng(19)
    rows, words = 37, 24  # deliberately unaligned to both axes
    p0 = rng.integers(0, 2**32, (rows, words), dtype=np.uint32)
    p1 = rng.integers(0, 2**32, (rows, words), dtype=np.uint32)
    masks = rng.integers(0, 2**32, (3, words), dtype=np.uint32)
    want = np.asarray(counts_ops.count_codes(
        jax.numpy.asarray(p0), jax.numpy.asarray(p1),
        jax.numpy.asarray(masks)))
    for r_axis in (2, 4):
        mesh = meshlib.make_mesh2(r_axis)
        d0, d1, dm = meshlib.shard_planes2(mesh, p0, p1, masks)
        got = np.asarray(meshlib.sharded_count2_fn(mesh)(d0, d1, dm))
        assert got.shape[0] >= rows
        assert np.array_equal(got[:rows], want), r_axis


def test_shard_crossover_gate(tmp_path, monkeypatch):
    """Below BGT_TPU_SHARD_MIN_ROWS an in-process mesh query must route to
    a single device (no plane placement on the mesh), with identical
    bytes; forcing the gate to 0 places the planes."""
    import io
    import os
    from bgt_tpu import testing
    from bgt_tpu.query import importer, fastpath
    from bgt_tpu.query.view import main_view
    vcf = testing.random_vcf(n_samples=12, n_sites=80, seed=77)
    (tmp_path / "in.vcf").write_text(vcf)
    importer.import_vcf(str(tmp_path / "db"), [str(tmp_path / "in.vcf")],
                        is_vcf=True)

    def run():
        fastpath.reset_shard_context()
        fastpath._COUNT_MEMO.clear()
        buf = io.StringIO()
        old = os.getcwd()
        os.chdir(tmp_path)
        try:
            assert main_view(["-G", "-C", "-s", ",S0001,S0003", "db"],
                             out=buf) == 0
        finally:
            os.chdir(old)
        ctx = fastpath.get_shard_context()
        placed = len(ctx._planes) if ctx is not None else 0
        fastpath.reset_shard_context()
        return buf.getvalue(), placed

    monkeypatch.setenv("BGT_TPU_COUNT_TIER", "device")
    # default gate (65536) >> 80 rows: single-device path, nothing placed
    out_gated, placed_gated = run()
    assert placed_gated == 0, "small query placed planes on the mesh"
    # gate off: the mesh serves the same bytes
    monkeypatch.setenv("BGT_TPU_SHARD_MIN_ROWS", "0")
    out_mesh, placed_mesh = run()
    assert placed_mesh == 1, "mesh path did not engage with the gate off"
    assert out_gated == out_mesh


def test_mesh2_production_path(tmp_path, monkeypatch):
    """A narrow (few-sample) DB on an 8-device mesh routes counts through
    the 2-axis rows x columns executor (kind 'rs') with identical bytes to
    the host tier; a wide-enough word count keeps the 1-axis executor
    (the production site-batch axis)."""
    import io
    import os
    from bgt_tpu import testing
    from bgt_tpu.query import importer, fastpath
    from bgt_tpu.query.view import main_view
    vcf = testing.random_vcf(n_samples=10, n_sites=90, seed=31)
    (tmp_path / "in.vcf").write_text(vcf)
    importer.import_vcf(str(tmp_path / "db"), [str(tmp_path / "in.vcf")],
                        is_vcf=True)

    def run():
        fastpath.reset_shard_context()
        fastpath._COUNT_MEMO.clear()
        buf = io.StringIO()
        old = os.getcwd()
        os.chdir(tmp_path)
        try:
            assert main_view(["-G", "-C", "-s", ",S0001,S0003", "db"],
                             out=buf) == 0
        finally:
            os.chdir(old)
        ctx = fastpath.get_shard_context()
        kinds = ([getattr(e, "kind", "?") for e in ctx._planes.values()]
                 if ctx is not None else [])
        fastpath.reset_shard_context()
        return buf.getvalue(), kinds

    monkeypatch.setenv("BGT_TPU_COUNT_TIER", "host")
    monkeypatch.setenv("BGT_TPU_SHARD", "0")
    want, _ = run()
    monkeypatch.delenv("BGT_TPU_SHARD")
    monkeypatch.setenv("BGT_TPU_COUNT_TIER", "device")
    monkeypatch.setenv("BGT_TPU_SHARD_MIN_ROWS", "0")
    # auto heuristic: 10 samples -> few words -> pure row sharding (r=8)
    got, kinds = run()
    assert kinds == ["rs"], kinds
    assert got == want
    # explicit 2x4 layout
    monkeypatch.setenv("BGT_TPU_MESH2", "2x4")
    got2, kinds2 = run()
    assert kinds2 == ["rs"], kinds2
    assert got2 == want
    # forcing all devices onto the sample axis restores the 1-axis executor
    monkeypatch.setenv("BGT_TPU_MESH2", "1x8")
    got1, kinds1 = run()
    assert kinds1 == ["s"], kinds1
    assert got1 == want
