"""Real-GPU parity suite.

The normal test run pins JAX to 8 virtual CPU devices (conftest.py); this
file instead checks the device kernels AND one end-to-end query on the
default JAX backend, which must be a CUDA GPU.  Because the CPU pin
happens at interpreter start, the device work runs in a child process with
a clean environment.

Marked ``gpu``: it skips where no GPU is visible, and fails instead of
skipping when BGT_TPU_REQUIRE_GPU=1 (chip_smoke.py sets it).  Run on the
card with ``python -m pytest -m gpu tests/``.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu_env():
    """Environment for a child on the default backend, once a GPU is seen.

    Decided here and not at import, so every xdist worker collects the
    same tests."""
    if shutil.which("nvidia-smi") is None:
        if os.environ.get("BGT_TPU_REQUIRE_GPU") == "1":
            pytest.fail("BGT_TPU_REQUIRE_GPU=1 but nvidia-smi is not on PATH")
        pytest.skip("no CUDA GPU visible (nvidia-smi is not on PATH)")
    return {k: v for k, v in os.environ.items()
            if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}


DEVICE_SCRIPT = r"""
import sys
sys.path.insert(0, REPO)
import numpy as np
import jax
import jax.numpy as jnp

dev = jax.devices()[0]
print("backend:", dev.platform, dev.device_kind, flush=True)
assert dev.platform == "gpu", f"default JAX backend is {dev.platform}, not gpu"

from bgt_tpu import native
assert native.get_lib() is not None, "native host library did not load"

from bgt_tpu.ops import counts as counts_ops

rng = np.random.default_rng(11)
rows, words, groups = 512, 96, 5
p0 = rng.integers(0, 2**32, (rows, words), dtype=np.uint32)
p1 = rng.integers(0, 2**32, (rows, words), dtype=np.uint32)
masks = rng.integers(0, 2**32, (groups, words), dtype=np.uint32)

# host oracle (the same math host_counts uses)
both = p0 & p1
want = np.empty((rows, groups, 4), np.int32)
for g in range(groups):
    m = masks[g]
    n10 = np.bitwise_count(p0 & m).sum(axis=1, dtype=np.int32)
    n11 = np.bitwise_count(p1 & m).sum(axis=1, dtype=np.int32)
    nb = np.bitwise_count(both & m).sum(axis=1, dtype=np.int32)
    tot = np.bitwise_count(m).sum(dtype=np.int32)
    c1 = n10 - nb
    c2 = n11 - nb
    want[:, g, 0] = tot - c1 - c2 - nb
    want[:, g, 1] = c1
    want[:, g, 2] = c2
    want[:, g, 3] = nb

d0 = jax.device_put(p0, dev)
d1 = jax.device_put(p1, dev)
dm = jax.device_put(masks, dev)
got = np.asarray(counts_ops.count_codes(d0, d1, dm))
assert np.array_equal(got, want), "count_codes mismatch on device"
print("count_codes OK", flush=True)

got_r = np.asarray(counts_ops.count_codes_range(d0, d1, dm, 17, 100))
assert np.array_equal(got_r, want[17:117]), "count_codes_range mismatch"
print("count_codes_range OK", flush=True)

codes = np.asarray(counts_ops.decode_codes(d0, d1))
b0 = np.unpackbits(p0.view(np.uint8), axis=1, bitorder="little")
b1 = np.unpackbits(p1.view(np.uint8), axis=1, bitorder="little")
assert np.array_equal(codes, (b1 << 1) | b0), "decode_codes mismatch"
print("decode_codes OK", flush=True)

cols = np.sort(rng.choice(words * 32, size=64, replace=False)).astype(np.int32)
cols = (cols // 2) * 2  # even/odd pairs
cols[1::2] = cols[0::2] + 1
pairs = np.asarray(counts_ops.gt_pair_idx_range(
    d0, d1, jnp.asarray(cols), 0, rows))
cw = ((b1 << 1) | b0)[:, cols]
assert np.array_equal(pairs, (cw[:, 0::2] << 2) | cw[:, 1::2]), \
    "gt_pair_idx_range mismatch"
print("gt_pair_idx_range OK", flush=True)

# end-to-end: subset query served by the device tier must equal host tier
import io
import os
from bgt_tpu import testing
from bgt_tpu.query import fastpath, importer
from bgt_tpu.query.view import main_view

dbdir = sys.argv[1]
os.chdir(dbdir)
if not os.path.exists("db.pbf"):
    open("in.vcf", "w").write(
        testing.random_vcf(n_samples=40, n_sites=400, seed=9))
    importer.import_vcf("db", ["in.vcf"], is_vcf=True)

args = ["-G", "-C", "-s", ",S0001,S0003,S0007,S0011", "db"]

def run(tier):
    os.environ["BGT_TPU_COUNT_TIER"] = tier
    fastpath._COUNT_MEMO.clear()
    buf = io.StringIO()
    assert main_view(args, out=buf) == 0
    return buf.getvalue()

host = run("host")
device = run("device")
assert host == device, "device-tier query bytes differ from host tier"
assert len(host.splitlines()) > 100
assert any(v is not None for v in fastpath._DEVICE_CACHE.values()), \
    "device tier did not make the planes resident"
print("end-to-end subset OK", flush=True)

# sharded kernels on the real mesh (all visible devices) + stream_counts
from bgt_tpu.parallel import mesh as meshlib
from bgt_tpu.query.fastpath import stream_counts
from bgt_tpu.ops.tiles import TileStore

mesh = meshlib.make_mesh()
sp0, sp1, sm = meshlib.shard_planes(mesh, p0, p1, masks)
got_s = np.asarray(meshlib.sharded_count_fn(mesh)(sp0, sp1, sm))
assert np.array_equal(got_s, want), "sharded_count_fn mismatch"
got_sr = np.asarray(meshlib.sharded_count_range_fn(mesh)(
    sp0, sp1, sm, 17, 100))
assert np.array_equal(got_sr, want[17:117]), "sharded_count_range mismatch"
prf = meshlib.sharded_pairs_rows_fn(mesh)
rows_sel = np.array([0, 3, 17, 200, 511], dtype=np.int32)
got_p = np.asarray(prf(sp0, sp1, jnp.asarray(rows_sel)))
cw_all = (b1 << 1) | b0
want_p = (cw_all[rows_sel][:, 0::2] << 2) | cw_all[rows_sel][:, 1::2]
assert np.array_equal(got_p[:, : want_p.shape[1]], want_p), \
    "sharded_pairs_rows mismatch"
print("sharded kernels OK", flush=True)

ts = TileStore(rows, words * 32, p0, p1)
rows_sub = np.arange(13, 400, 7, dtype=np.int64)
got_st = stream_counts(ts, rows_sub, masks, chunk_rows=128)
assert np.array_equal(got_st, want[rows_sub]), "stream_counts mismatch"
print("stream_counts OK", flush=True)
print("DEVICE-SUITE-PASS", flush=True)
"""


def test_device_kernels_and_query(tmp_path, gpu_env):
    script = f"REPO = {str(REPO)!r}\n" + DEVICE_SCRIPT
    res = subprocess.run([sys.executable, "-c", script, str(tmp_path)],
                         env=gpu_env, capture_output=True, text=True,
                         timeout=800)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "DEVICE-SUITE-PASS" in res.stdout, res.stdout[-2000:]
