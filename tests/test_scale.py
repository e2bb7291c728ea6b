"""Scale-shaped regression: >=10^4 samples x >=10^5 sites, parity vs the
reference binary (catches Python-loop cliffs that the
small parity suites cannot see).  Opt-in: BGT_TPU_SCALE_TESTS=1 (several
minutes of generation + double import on 2 cores)."""

import hashlib
import os
import subprocess
from pathlib import Path

import pytest

from bgt_tpu import testing
from bgt_tpu.query import importer
from bgt_tpu.query.view import main_view

pytestmark = pytest.mark.skipif(
    os.environ.get("BGT_TPU_SCALE_TESTS") != "1",
    reason="set BGT_TPU_SCALE_TESTS=1 for the multi-minute scale run")

N_SAMPLES = 10_000
N_SITES = 100_000


@pytest.fixture(scope="module")
def scale_db(tmp_path_factory, ref_bgt):
    tmp = tmp_path_factory.mktemp("scale")
    vcf = tmp / "in.vcf"
    testing.cohort_vcf_to_file(str(vcf), n_samples=N_SAMPLES,
                               n_sites=N_SITES, seed=17)
    res = subprocess.run([ref_bgt, "import", "-S", "refdb", "in.vcf"],
                         cwd=tmp, capture_output=True)
    assert res.returncode == 0, res.stderr.decode()[-500:]
    importer.import_vcf(str(tmp / "ourdb"), [str(vcf)], is_vcf=True)
    for ext in (".bcf", ".pbf", ".spl"):
        ha = hashlib.md5((tmp / f"ourdb{ext}").read_bytes()).hexdigest()
        hb = hashlib.md5((tmp / f"refdb{ext}").read_bytes()).hexdigest()
        assert ha == hb, f"{ext} differs at scale"
    spl = testing.random_spl(N_SAMPLES, seed=17)
    (tmp / "refdb.spl").write_text(spl)
    (tmp / "ourdb.spl").write_text(spl)
    return tmp


def _ours_md5(d, args) -> str:
    class M:
        def __init__(self):
            self.h = hashlib.md5()

        def write(self, s):
            self.h.update(s.encode("latin-1"))
            return len(s)
    old = os.getcwd()
    os.chdir(d)
    sink = M()
    try:
        assert main_view(args + ["ourdb"], out=sink) == 0
    finally:
        os.chdir(old)
    return sink.h.hexdigest()


def _ref_md5(ref_bgt, d, args) -> str:
    h = hashlib.md5()
    with subprocess.Popen([ref_bgt, "view"] + args + ["refdb"], cwd=d,
                          stdout=subprocess.PIPE) as p:
        for blk in iter(lambda: p.stdout.read(1 << 20), b""):
            h.update(blk)
    assert p.returncode == 0
    return h.hexdigest()


@pytest.mark.parametrize("args", [
    ["-G", "-C"],
    ["-G", "-C", "-r", "11:30000000-80000000"],
    # 10^4-sample group selection
    ["-G", "-C", "-s", 'population=="CEU"', "-s", 'population=="YRI"'],
    ["-G", "-f", "AC>100"],
    ["-i", "50001", "-n", "200"],
], ids=["gc", "region", "groups", "filter", "paging"])
def test_scale_query_parity(scale_db, ref_bgt, args):
    assert _ours_md5(scale_db, args) == _ref_md5(ref_bgt, scale_db, args)
