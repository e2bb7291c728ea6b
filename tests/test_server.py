"""HTTP server behavior: parameter translation, privacy, quotas, concurrency."""

import subprocess
import threading
import urllib.request

import pytest

from bgt_tpu import testing
from bgt_tpu.query import importer
from bgt_tpu.server import server as srv


@pytest.fixture(scope="module")
def served_db(tmp_path_factory, ref_bgt):
    tmp = tmp_path_factory.mktemp("srvdb")
    vcf = testing.random_vcf(n_samples=12, n_sites=120, seed=21)
    (tmp / "in.vcf").write_text(vcf)
    importer.import_vcf(str(tmp / "db"), [str(tmp / "in.vcf")], is_vcf=True)
    (tmp / "db.spl").write_text(testing.random_spl(12, seed=21))
    cfg = srv.ServerConfig()
    cfg.port = 0
    from bgt_tpu.query.engine import BgtFile
    cfg.files = [BgtFile(str(tmp / "db"))]
    cfg.prefixes = ["db"]
    httpd = srv.make_server(cfg)
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield tmp, port, cfg
    httpd.shutdown()


def fetch(port, query):
    url = f"http://127.0.0.1:{port}/{query}"
    try:
        with urllib.request.urlopen(url) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def view_cli(tmp, args):
    import io
    import os
    from bgt_tpu.query.view import main_view
    buf = io.StringIO()
    old = os.getcwd()
    os.chdir(tmp)
    try:
        ret = main_view(args + ["db"], out=buf)
    finally:
        os.chdir(old)
    assert ret == 0
    return buf.getvalue()


def test_help_page(served_db):
    tmp, port, cfg = served_db
    status, body = fetch(port, "")
    assert status == 200
    assert "Accepted Parameters" in body


def test_basic_query_matches_cli(served_db):
    tmp, port, cfg = served_db
    status, body = fetch(port, "?C=")
    assert status == 200
    # server default is -G (no genotypes) + C
    want = view_cli(tmp, ["-G", "-C"])
    assert body == want


def test_genotype_query(served_db):
    tmp, port, cfg = served_db
    status, body = fetch(port, "?g=&C=")
    assert status == 200
    want = view_cli(tmp, ["-C"])
    assert body == want


def test_region_and_filter(served_db):
    tmp, port, cfg = served_db
    status, body = fetch(port, "?r=11:10000-100000&f=AC>0&C=")
    assert status == 200
    want = view_cli(tmp, ["-G", "-C", "-r", "11:10000-100000", "-f", "AC>0"])
    assert body == want


def test_groups_with_and_operator(served_db):
    tmp, port, cfg = served_db
    q = '?s=population=="CEU"&s=population=="YRI"&f=(AC1>0.and.AN2>0)'
    status, body = fetch(port, q)
    assert status == 200
    want = view_cli(tmp, ["-G", "-s", 'population=="CEU"', "-s", 'population=="YRI"',
                          "-f", "AC1>0&&AN2>0", "-C"])
    assert body == want


def test_table_output(served_db):
    tmp, port, cfg = served_db
    status, body = fetch(port, "?t=CHROM,POS,AC,AN")
    assert status == 200
    want = view_cli(tmp, ["-t", "CHROM,POS,AC,AN"])
    assert body == want


def test_bad_region_400(served_db):
    tmp, port, cfg = served_db
    status, body = fetch(port, "?r=nonexistent:1-2")
    assert status == 400


def test_bad_filter_400(served_db):
    tmp, port, cfg = served_db
    status, body = fetch(port, "?f=AC>)")
    assert status == 400


def test_quota_truncation(served_db):
    tmp, port, cfg = served_db
    old = cfg.max_gt
    cfg.max_gt = 100  # 12 samples -> 12 gt/site; trips after ~9 sites
    try:
        status, body = fetch(port, "?C=")
        assert status == 200
        assert body.endswith("*\n")
        n_sites = sum(1 for l in body.splitlines() if not l.startswith("#") and l != "*")
        assert 0 < n_sites < 120
    finally:
        cfg.max_gt = old


def test_n_limit(served_db):
    tmp, port, cfg = served_db
    status, body = fetch(port, "?n=5&C=")
    lines = [l for l in body.splitlines() if not l.startswith("#")]
    # reference semantics: reads until n_read > max_read, so n+1 records
    assert lines[-1] == "*"
    assert len([l for l in lines if l != "*"]) == 6


def test_mgs_forbidden(served_db):
    tmp, port, cfg = served_db
    old = cfg.min_group
    cfg.min_group = 100  # larger than any possible group
    try:
        # expression-selected groups bypass the per-name MGS gate, then fail
        # the group-size check in bgtm_test_mgs -> 403 (bgt-server.go:319-322)
        status, body = fetch(port, '?s=population=="YRI"&C=')
        assert status == 403
        # name-list selection of MGS-protected samples is silently dropped
        # instead (bgt.c:150-153): empty output, not an error
        status, body = fetch(port, "?s=,S0001,S0002&C=")
        assert status == 200
        assert all(l.startswith("#") for l in body.splitlines())
    finally:
        cfg.min_group = old


def _general_path_body(cfg, form, max_read, max_gt):
    """Independent replica of the per-site server loop (bgt-server.go:330-352)
    to pin the fastpath's quota-cutoff semantics."""
    from bgt_tpu.formats import bcf as bcflib
    from bgt_tpu.query.engine import BgtmReader, F_NO_GT, F_SET_AC
    bm = BgtmReader(cfg.files)
    bm.set_flag(F_NO_GT | F_SET_AC)
    if "f" in form:
        bm.set_flt_site(form["f"])
    if "r" in form:
        bm.set_region(form["r"])
    bm.prepare()
    out = [bm.h_out.text + "\n"]
    b = bcflib.Bcf1()
    n_read = 0
    while True:
        if n_read > max_read or bm.n_gt_read > max_gt:
            break
        if bm.read(b) < 0:
            break
        out.append(bcflib.vcf_format1(bm.h_out, b) + "\n")
        n_read += 1
    if n_read > max_read or bm.n_gt_read > max_gt:
        out.append("*\n")
    bm.close()
    return "".join(out)


@pytest.mark.parametrize("max_gt", [1, 12, 100, 101, 1200, 1201, 1440, 10**9])
def test_quota_cutoff_matches_general_path(served_db, max_gt):
    """The fastpath site cutoff reproduces the general loop byte-for-byte
    for any quota value (12 samples -> 12 gt per site read)."""
    tmp, port, cfg = served_db
    old = cfg.max_gt
    cfg.max_gt = max_gt
    try:
        status, body = fetch(port, "?C=")
        assert status == 200
        assert body == _general_path_body(cfg, {}, 2147483647, max_gt)
        # with a site filter: failed sites are read (and counted) too
        status, body = fetch(port, "?C=&f=AC>3")
        assert status == 200
        assert body == _general_path_body(cfg, {"f": "AC>3"}, 2147483647, max_gt)
    finally:
        cfg.max_gt = old


def test_vardb_allele_expression(served_db, ref_bgt):
    """a=EXPR over the server's -d variant annotation FMF
    (reference bgt-server.go:296-307 -> bgtm_set_alleles vardb source)."""
    import subprocess as sp
    import urllib.parse
    tmp, port, cfg = served_db
    res = sp.run([ref_bgt, "getalt", str(tmp / "db")], capture_output=True)
    keys = res.stdout.decode().splitlines()
    lines = [f"{k}\timpact:Z:{'HIGH' if i % 4 == 0 else 'LOW'}"
             for i, k in enumerate(keys)]
    (tmp / "anno.fmf").write_text("\n".join(lines) + "\n")
    from bgt_tpu.formats.fmf import Fmf
    old = cfg.vardb
    cfg.vardb = Fmf.read(str(tmp / "anno.fmf"))
    try:
        q = "?a=" + urllib.parse.quote('impact=="HIGH"') + "&C="
        status, body = fetch(port, q)
        assert status == 200
        want = view_cli(tmp, ["-G", "-C", "-M", "-d", "anno.fmf",
                              "-a", 'impact=="HIGH"'])
        assert body == want
        # no matching alleles -> 204
        q = "?a=" + urllib.parse.quote('impact=="NONE"') + "&C="
        status, body = fetch(port, q)
        assert status == 204
    finally:
        cfg.vardb = old


def test_genotype_dump_fastpath_stream(served_db):
    """Full-genotype server response (chunked) matches the CLI bytes."""
    tmp, port, cfg = served_db
    status, body = fetch(port, "?g=&C=&r=11:1-500000")
    assert status == 200
    want = view_cli(tmp, ["-C", "-r", "11:1-500000"])
    assert body == want


def test_concurrent_queries(served_db):
    tmp, port, cfg = served_db
    results = []

    def worker(q):
        results.append(fetch(port, q))

    threads = [threading.Thread(target=worker, args=("?C=",)) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len({body for _s, body in results}) == 1
    assert all(s == 200 for s, _b in results)


def test_server_alcnt_hapcnt(served_db, ref_bgt):
    """S/H parameters through the batched server path: output equals the
    CLI -S/-H reports, and the n-quota uses the server's check-before-read
    convention (accumulated set == emitted set, no CLI +1 quirk)."""
    tmp, port, cfg = served_db
    keys = subprocess.run([ref_bgt, "getalt", "db"], cwd=tmp,
                          capture_output=True).stdout.decode().splitlines()
    pick = ",".join(keys[1:14:2])
    for param, mode in (("S", ["-S"]), ("H", ["-H"])):
        status, body = fetch(port, f"?a=,{pick}&{param}=1")
        assert status == 200
        want = view_cli(tmp, ["-a," + pick] + mode)
        assert body == want, param
    # n-quota: replicate the general server loop's accumulation by hand
    from bgt_tpu.query.engine import BgtmReader, F_CNT_AL, F_NO_GT, F_SET_AC
    from bgt_tpu.formats import bcf as bcflib
    n_lim = 2
    bm = BgtmReader(cfg.files)
    bm.set_flag(F_NO_GT | F_CNT_AL)
    assert bm.set_alleles("," + pick, None, None) > 0
    bm.prepare()
    b = bcflib.Bcf1()
    n_read = 0
    while True:
        if n_read > n_lim or bm.n_gt_read > cfg.max_gt:
            break
        if bm.read(b) < 0:
            break
        n_read += 1
    want = ""
    if len(bm.aal) > 0:
        want = bm.alcnt_print()
    if n_read > n_lim or bm.n_gt_read > cfg.max_gt:
        want += "*\n"
    bm.close()
    status, body = fetch(port, f"?a=,{pick}&S=1&n={n_lim}")
    assert status == 200
    assert body == want


def test_response_streams_before_query_completes(served_db, monkeypatch):
    """Bytes reach the client while FastView.run is still producing: the
    first chunk must arrive over HTTP while the producer is deliberately
    blocked, proving per-chunk streaming rather than a buffered handoff
    (reference bgt-server.go:330-352)."""
    import http.client
    import threading

    tmp, port, cfg = served_db
    release = threading.Event()
    finished = threading.Event()

    class _SlowView:
        def __init__(self, bm, opt):
            pass

        def run(self, w):
            w.write("first-chunk\n")
            assert release.wait(timeout=30.0), "consumer never saw chunk 1"
            w.write("second-chunk\n")
            finished.set()

    from bgt_tpu.query import fastpath
    monkeypatch.setattr(fastpath, "FastView", _SlowView)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", "/?r=11:10000-100000&C=1")
    resp = conn.getresponse()
    # read the VCF header chunk + the first data chunk while the producer
    # is still blocked inside run()
    got = b""
    while b"first-chunk" not in got:
        got += resp.read1(65536)
    assert not finished.is_set(), "producer finished before first byte read"
    release.set()
    rest = resp.read()
    assert b"second-chunk" in rest
    assert finished.is_set()
    conn.close()


def test_client_disconnect_releases_producer(served_db, monkeypatch):
    """An abandoned connection must unblock the producer thread (the
    bounded-queue put loop checks the stop flag) instead of leaking it."""
    import http.client
    import threading
    import time as _time

    tmp, port, cfg = served_db
    state = {"aborted": False}
    started = threading.Event()

    class _Flood:
        def __init__(self, bm, opt):
            pass

        def run(self, w):
            started.set()
            try:
                while True:  # far more than the queue bound
                    w.write("x" * 65536 + "\n")
            except BaseException:
                state["aborted"] = True
                raise

    from bgt_tpu.query import fastpath
    monkeypatch.setattr(fastpath, "FastView", _Flood)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", "/?r=11:10000-100000&C=1")
    resp = conn.getresponse()
    resp.read1(1024)
    assert started.wait(timeout=10.0)
    conn.close()  # abandon mid-stream
    for _ in range(200):
        if state["aborted"]:
            break
        _time.sleep(0.05)
    assert state["aborted"], "producer still blocked after client disconnect"
