"""Multi-host execution: 2 jax.distributed CPU processes over one mesh.

Launches two coordinator-connected processes (4 virtual devices each), each
holding only its own word-column slice of the packed planes on its devices
(distributed.place_local), runs the same subset query on both, and asserts
byte-identical output — the psum over the 8-device global mesh must
reproduce the single-process counts exactly (the multi-host generalization
of the reference's multi-database composition, bgt.c:829-842).
"""

import io
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from bgt_tpu import testing
from bgt_tpu.query import importer

REPO = Path(__file__).resolve().parent.parent

RUNNER = r"""
import os, sys
pid = int(sys.argv[1]); port = sys.argv[2]; dbdir = sys.argv[3]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["BGT_TPU_COUNT_TIER"] = "device"  # exercise the mesh, not the host tier
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address="127.0.0.1:" + port,
                           num_processes=2, process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8, len(jax.devices())
sys.path.insert(0, %(repo)r)
import io as _io
from bgt_tpu.query import fastpath
from bgt_tpu.query.view import main_view
os.chdir(dbdir)
buf = _io.StringIO()
# subset query: forces the device count path (not the rowstats aggregate)
ret = main_view(["-G", "-C", "-s", ",S0001,S0003,S0004", "db"], out=buf)
assert ret == 0
ctx = fastpath.get_shard_context()
assert ctx is not None and ctx.multi_process, "mesh did not span processes"
with open(f"out_{pid}.vcf", "w") as fp:
    fp.write(buf.getvalue())
print("proc", pid, "ok", flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_mesh_byte_parity(tmp_path):
    vcf = testing.random_vcf(n_samples=300, n_sites=150, seed=33)
    (tmp_path / "in.vcf").write_text(vcf)
    importer.import_vcf(str(tmp_path / "db"), [str(tmp_path / "in.vcf")],
                        is_vcf=True)
    (tmp_path / "db.spl").write_text(testing.random_spl(300, seed=33))

    # single-process expected output (this test process, 8 local devices)
    from bgt_tpu.query.view import main_view
    buf = io.StringIO()
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        assert main_view(["-G", "-C", "-s", ",S0001,S0003,S0004", "db"],
                         out=buf) == 0
    finally:
        os.chdir(old)
    want = buf.getvalue()
    assert want.count("\n") > 100

    port = str(_free_port())
    script = RUNNER % {"repo": str(REPO)}
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [
        subprocess.Popen([sys.executable, "-c", script, str(pid), port,
                          str(tmp_path)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         env=env)
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed processes timed out")
        outs.append((p.returncode, out.decode(), err.decode()))
    for rc, out, err in outs:
        assert rc == 0, err[-3000:]
    got0 = (tmp_path / "out_0.vcf").read_text()
    got1 = (tmp_path / "out_1.vcf").read_text()
    assert got0 == want
    assert got1 == want


SHARD_RUNNER = r"""
import os, sys
pid = int(sys.argv[1]); port = sys.argv[2]; dbdir = sys.argv[3]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["BGT_TPU_COUNT_TIER"] = "device"  # exercise the mesh, not the host tier
os.environ["BGT_TPU_TILE_SHARD"] = f"{pid}:2"
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address="127.0.0.1:" + port,
                           num_processes=2, process_id=pid)
sys.path.insert(0, %(repo)r)
import io as _io
from bgt_tpu.query import fastpath
from bgt_tpu.query.view import main_view
os.chdir(dbdir)
buf = _io.StringIO()
ret = main_view(["-G", "-C", "-s", ",S0001,S0003,S0004", "db"], out=buf)
assert ret == 0
# this process must have served the query from its column-slice shard only
stores = list(fastpath._TILE_CACHE.values())
assert stores and all(ts.is_shard for ts in stores), "full tile was opened"
assert stores[0].word_offset == (0 if pid == 0 else stores[0].n_words // 2)
with open(f"shard_out_{pid}.vcf", "w") as fp:
    fp.write(buf.getvalue())
# GT-emitting queries assemble genotypes through the mesh all_gather
# (sharded_pairs_rows_fn) — full dump and a subset (reference merge-gather seam bgt.c:829-842)
buf = _io.StringIO()
assert main_view(["-C", "db"], out=buf) == 0
with open(f"shard_gt_{pid}.vcf", "w") as fp:
    fp.write(buf.getvalue())
buf = _io.StringIO()
assert main_view(["-C", "-s", ",S0001,S0003,S0004", "db"], out=buf) == 0
with open(f"shard_gtsub_{pid}.vcf", "w") as fp:
    fp.write(buf.getvalue())
class _BinOut:  # .buffer duck-type for the -b binary stream
    def __init__(self): self.buffer = _io.BytesIO()
    def write(self, s): self.buffer.write(s.encode("latin-1"))
    def flush(self): pass
bo = _BinOut()
assert main_view(["-b", "-C", "db"], out=bo) == 0
with open(f"shard_gt_{pid}.bcf", "wb") as fp:
    fp.write(bo.buffer.getvalue())
print("proc", pid, "ok", flush=True)
"""


def test_two_process_shard_files_byte_parity(tmp_path):
    """Each process opens ONLY its on-disk column-slice shard (the full
    .gtc is deleted before the children start) and the merged counts still
    match the single-process output byte for byte."""
    from bgt_tpu.ops.tiles import TileStore
    vcf = testing.random_vcf(n_samples=300, n_sites=120, seed=44)
    (tmp_path / "in.vcf").write_text(vcf)
    importer.import_vcf(str(tmp_path / "db"), [str(tmp_path / "in.vcf")],
                        is_vcf=True)
    (tmp_path / "db.spl").write_text(testing.random_spl(300, seed=44))

    from bgt_tpu.query.view import main_view
    buf = io.StringIO()
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        assert main_view(["-G", "-C", "-s", ",S0001,S0003,S0004", "db"],
                         out=buf) == 0
    finally:
        os.chdir(old)
    want = buf.getvalue()
    buf = io.StringIO()
    os.chdir(tmp_path)
    try:
        assert main_view(["-C", "db"], out=buf) == 0
        want_gt = buf.getvalue()
        buf = io.StringIO()
        assert main_view(["-C", "-s", ",S0001,S0003,S0004", "db"],
                         out=buf) == 0
        want_gtsub = buf.getvalue()

        class _BinOut:
            def __init__(self):
                self.buffer = io.BytesIO()

            def write(self, s):
                self.buffer.write(s.encode("latin-1"))

            def flush(self):
                pass

        bo = _BinOut()
        assert main_view(["-b", "-C", "db"], out=bo) == 0
        want_bcf = bo.buffer.getvalue()
    finally:
        os.chdir(old)

    TileStore.emit_shards(str(tmp_path / "db"), n_proc=2, n_dev_total=8)
    (tmp_path / "db.gtc").unlink()  # children cannot fall back to the full tile

    port = str(_free_port())
    script = SHARD_RUNNER % {"repo": str(REPO)}
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "BGT_TPU_TILE_SHARD")}
    procs = [
        subprocess.Popen([sys.executable, "-c", script, str(pid), port,
                          str(tmp_path)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         env=env)
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed processes timed out")
        outs.append((p.returncode, out.decode(), err.decode()))
    for rc, out, err in outs:
        assert rc == 0, err[-3000:]
    assert (tmp_path / "shard_out_0.vcf").read_text() == want
    assert (tmp_path / "shard_out_1.vcf").read_text() == want
    # GT-emitting output must be byte-identical on both hosts, assembled
    # from column-slice shards only (mesh all_gather)
    assert (tmp_path / "shard_gt_0.vcf").read_text() == want_gt
    assert (tmp_path / "shard_gt_1.vcf").read_text() == want_gt
    assert (tmp_path / "shard_gtsub_0.vcf").read_text() == want_gtsub
    assert (tmp_path / "shard_gtsub_1.vcf").read_text() == want_gtsub
    # binary BCF output through the repacked-plane serializer, same bytes
    assert (tmp_path / "shard_gt_0.bcf").read_bytes() == want_bcf
    assert (tmp_path / "shard_gt_1.bcf").read_bytes() == want_bcf
