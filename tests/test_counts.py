"""The count kernel at the HRC tile width, the compile-cache rule, the
peak table, and chip_smoke.py's phases at a tiny size (all on the CPU)."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from bgt_tpu.ops import counts as counts_ops

REPO = Path(__file__).resolve().parent.parent
HRC_WORDS = 2048  # 32,488 samples -> 64,976 haplotypes, padded to 1024-col blocks


def oracle(p0, p1, masks):
    """Counts of codes 0..3 per row and mask, from unpacked bits."""
    b0 = np.unpackbits(p0.view(np.uint8), axis=1, bitorder="little")
    b1 = np.unpackbits(p1.view(np.uint8), axis=1, bitorder="little")
    codes = (b1 << 1) | b0
    sel = np.unpackbits(masks.view(np.uint8), axis=1, bitorder="little")
    out = np.empty((p0.shape[0], masks.shape[0], 4), np.int32)
    for gi in range(masks.shape[0]):
        sub = codes[:, sel[gi].astype(bool)]
        for c in range(4):
            out[:, gi, c] = (sub == c).sum(axis=1)
    return out


@pytest.mark.parametrize("rows", [1, 37])
@pytest.mark.parametrize("g", [1, 2, 8, 33])
def test_count_codes_hrc_width(rows, g):
    rng = np.random.default_rng(rows * 100 + g)
    p0 = rng.integers(0, 2**32, (rows, HRC_WORDS), dtype=np.uint32)
    p1 = rng.integers(0, 2**32, (rows, HRC_WORDS), dtype=np.uint32)
    masks = rng.integers(0, 2**32, (g, HRC_WORDS), dtype=np.uint32)
    got = np.asarray(counts_ops.count_codes(
        jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(masks)))
    want = oracle(p0, p1, masks)
    assert got.shape == (rows, g, 4) and got.dtype == np.int32
    assert np.array_equal(got, want)
    # chip_smoke's threaded oracle agrees on the same input
    import chip_smoke
    assert np.array_equal(chip_smoke.numpy_counts(p0, p1, masks, chunk=16),
                          want)


_CACHE_PROBE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import jax, jax.numpy as jnp
from bgt_tpu.ops import counts
# cache even a sub-threshold compile: this probes where entries land
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
p = jnp.ones((8, 64), jnp.uint32)
counts.count_codes(p, p, p[:3]).block_until_ready()
print(json.dumps(jax.config.jax_compilation_cache_dir))
"""


def _cache_dir_of(env):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"} | env | {"JAX_PLATFORMS": "cpu"}
    res = subprocess.run([sys.executable, "-c", _CACHE_PROBE, str(REPO)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_compile_cache_follows_env(tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: JAX's own setting stands and the
    compiled kernel lands there."""
    cache = tmp_path / "cache"
    assert _cache_dir_of({"JAX_COMPILATION_CACHE_DIR": str(cache)}) \
        == str(cache)
    assert any(cache.iterdir())


def test_compile_cache_default_in_checkout():
    """Unset: the fixed build/jaxcache of this checkout."""
    assert _cache_dir_of({}) == str(REPO / "build" / "jaxcache")
    assert counts_ops.JAX_CACHE_DIR == REPO / "build" / "jaxcache"


def test_hbm_peak_table():
    import bench
    assert bench.hbm_peak_gbs("NVIDIA H100 80GB HBM3") == 3350.0
    with pytest.raises(KeyError, match="no HBM peak"):
        bench.hbm_peak_gbs("cpu")


# --- chip_smoke.py phases at 40 samples x 400 sites --------------------------

@pytest.fixture(scope="module")
def smoke_db(tmp_path_factory):
    import chip_smoke
    d = tmp_path_factory.mktemp("smoke")
    return chip_smoke.make_database(d / "work", 40, 400, seed=5)


def test_smoke_refuses_without_gpu(tmp_path):
    """No GPU: non-zero exit and no result line, in the checkout and in a
    directory holding chip_smoke.py alone."""
    lone = tmp_path / "lone"
    lone.mkdir()
    shutil.copy(REPO / "chip_smoke.py", lone)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PATH="/usr/bin:/bin")
    for where in (REPO, lone):
        res = subprocess.run([sys.executable, str(where / "chip_smoke.py")],
                             env=env, capture_output=True, text=True,
                             timeout=300)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout


def test_smoke_database(smoke_db):
    import chip_smoke
    from bgt_tpu.query import engine, fastpath
    st = fastpath.get_site_table(engine.BgtFile(smoke_db))
    assert st.n == 400
    spl = Path(smoke_db + ".spl").read_text().splitlines()
    assert len(spl) == 40 and spl[7].startswith("S00007\tpopulation:Z:")
    assert set(chip_smoke.populations(40, 5)) <= set(range(5))


def test_smoke_kernels(smoke_db):
    import chip_smoke
    chip_smoke.check_kernels(smoke_db, groups=(1, 2, 3), sample_rows=16,
                             seed=5)


def test_smoke_server_and_streamed(smoke_db):
    import chip_smoke
    answers = chip_smoke.check_server(smoke_db, n_ref_sites=120, seed=5)
    assert set(answers) == {"all_samples_C", "subset", "two_groups_filter",
                            "table", "gt_quota", "carriers"}
    assert all(body for _pairs, body in answers.values())
    chip_smoke.check_streamed(smoke_db, answers, seed=5)


def test_smoke_reference_quota(smoke_db):
    """The per-site reference stops at the genotype quota and marks it."""
    import chip_smoke
    from bgt_tpu.query.engine import BgtFile
    body = chip_smoke.reference_body([BgtFile(smoke_db)], [("g", "1")],
                                     max_gt=100)
    lines = body.decode().splitlines()
    assert lines[-1] == "*"
    assert 0 < sum(not l.startswith("#") for l in lines[:-1]) < 400
