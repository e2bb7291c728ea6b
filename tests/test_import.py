"""Import/atomize byte-parity against the reference binary on synthetic VCFs."""

import subprocess
from pathlib import Path

import pytest

from bgt_tpu import testing
from bgt_tpu.query import importer

REF_DIR = Path("/root/reference")


def run_ref(ref_bgt, args, cwd, **kw):
    return subprocess.run([ref_bgt] + args, cwd=cwd, capture_output=True, **kw)


@pytest.mark.parametrize("seed,n_samples,n_sites", [(0, 8, 60), (1, 25, 200)])
def test_atomize_parity(tmp_path, ref_bgt, seed, n_samples, n_sites):
    vcf = testing.random_vcf(n_samples=n_samples, n_sites=n_sites, seed=seed)
    (tmp_path / "in.vcf").write_text(vcf)
    ref = run_ref(ref_bgt, ["atomize", "-S", "in.vcf"], tmp_path, check=True)
    import io
    buf = io.StringIO()
    importer.atomize_cli(str(tmp_path / "in.vcf"), is_vcf=True, out_fp=buf)
    assert buf.getvalue() == ref.stdout.decode()


def test_atomize_parity_ex2(tmp_path, ref_bgt):
    ref = run_ref(ref_bgt, ["atomize", "-S", "-M", str(REF_DIR / "ex2.vcf")],
                  tmp_path, check=True)
    import io
    buf = io.StringIO()
    importer.atomize_cli(str(REF_DIR / "ex2.vcf"), is_vcf=True, write_m=True,
                         out_fp=buf)
    assert buf.getvalue() == ref.stdout.decode()


def test_atomize_parity_ex3(tmp_path, ref_bgt):
    ref = run_ref(ref_bgt, ["atomize", "-S", "-M", str(REF_DIR / "ex3.vcf")],
                  tmp_path, check=True)
    import io
    buf = io.StringIO()
    importer.atomize_cli(str(REF_DIR / "ex3.vcf"), is_vcf=True, write_m=True,
                         out_fp=buf)
    assert buf.getvalue() == ref.stdout.decode()


@pytest.mark.parametrize("seed,n_samples,n_sites", [(2, 10, 80), (3, 30, 150)])
def test_import_parity(tmp_path, ref_bgt, seed, n_samples, n_sites):
    """All four database files must match the reference import byte-for-byte,
    including `.csi` (khash-order bin emission)."""
    vcf = testing.random_vcf(n_samples=n_samples, n_sites=n_sites, seed=seed,
                             with_filter=True)
    (tmp_path / "in.vcf").write_text(vcf)
    res = run_ref(ref_bgt, ["import", "-S", "refdb", "in.vcf"], tmp_path)
    assert res.returncode == 0, res.stderr.decode()
    importer.import_vcf(str(tmp_path / "ourdb"), [str(tmp_path / "in.vcf")],
                        is_vcf=True)
    for ext in (".bcf", ".pbf", ".spl", ".bcf.csi"):
        ours = (tmp_path / f"ourdb{ext}").read_bytes()
        ref = (tmp_path / f"refdb{ext}").read_bytes()
        assert ours == ref, f"{ext} differs"
    # CSI structural checks (kept: they localize a failure when bytes drift)
    from bgt_tpu.formats.csi import HtsIndex
    ours = HtsIndex.load(str(tmp_path / "ourdb.bcf.csi"))
    theirs = HtsIndex.load(str(tmp_path / "refdb.bcf.csi"))
    assert ours.n_rec == theirs.n_rec
    assert ours.ridx == theirs.ridx
    assert ours.n == theirs.n
    for i in range(ours.n):
        assert sorted(ours.bidx[i]) == sorted(theirs.bidx[i])
        for b in ours.bidx[i]:
            assert sorted(ours.bidx[i][b]) == sorted(theirs.bidx[i][b]), f"bin {b}"
            assert ours.loff[i].get(b) == theirs.loff[i].get(b), f"loff bin {b}"


def test_import_keep_filtered_parity(tmp_path, ref_bgt):
    vcf = testing.random_vcf(n_samples=6, n_sites=50, seed=4, with_filter=True)
    (tmp_path / "in.vcf").write_text(vcf)
    res = run_ref(ref_bgt, ["import", "-SF", "refdb", "in.vcf"], tmp_path)
    assert res.returncode == 0, res.stderr.decode()
    importer.import_vcf(str(tmp_path / "ourdb"), [str(tmp_path / "in.vcf")],
                        is_vcf=True, keep_filtered=True)
    assert (tmp_path / "ourdb.bcf").read_bytes() == (tmp_path / "refdb.bcf").read_bytes()
    assert (tmp_path / "ourdb.pbf").read_bytes() == (tmp_path / "refdb.pbf").read_bytes()


def test_import_from_bcf_input(tmp_path, ref_bgt):
    """BCF-format input (the reference's canonical input) imports identically."""
    from bgt_tpu import testing
    vcf = testing.random_vcf(n_samples=10, n_sites=70, seed=5)
    (tmp_path / "in.vcf").write_text(vcf)
    testing.vcf_text_to_bcf(vcf, str(tmp_path / "in.bcf"))
    res = run_ref(ref_bgt, ["import", "refdb", "in.bcf"], tmp_path)
    assert res.returncode == 0, res.stderr.decode()
    importer.import_vcf(str(tmp_path / "ourdb"), [str(tmp_path / "in.bcf")])
    for ext in (".bcf", ".pbf", ".spl"):
        assert (tmp_path / f"ourdb{ext}").read_bytes() == \
            (tmp_path / f"refdb{ext}").read_bytes(), ext
    # and VCF-input import of the same data matches the BCF-input import
    res = run_ref(ref_bgt, ["import", "-S", "refdb2", "in.vcf"], tmp_path)
    assert res.returncode == 0
    assert (tmp_path / "refdb.bcf").read_bytes() == (tmp_path / "refdb2.bcf").read_bytes()


def test_import_multi_input_append(tmp_path, ref_bgt):
    """Multiple input files append into one database (import.c:85-109)."""
    from bgt_tpu import testing
    v1 = testing.random_vcf(n_samples=5, n_sites=40, seed=8)
    # second file continues at higher positions on the same chromosome
    v2_full = testing.random_vcf(n_samples=5, n_sites=80, seed=9)
    head = [l for l in v2_full.splitlines() if l.startswith("#")]
    body = [l for l in v2_full.splitlines() if not l.startswith("#")]
    tail = [l for l in body if int(l.split("\t")[1]) > 100000]
    v2 = "\n".join(head + tail) + "\n"
    (tmp_path / "a.vcf").write_text(v1)
    (tmp_path / "b.vcf").write_text(v2)
    res = run_ref(ref_bgt, ["import", "-S", "refdb", "a.vcf", "b.vcf"], tmp_path)
    assert res.returncode == 0, res.stderr.decode()
    importer.import_vcf(str(tmp_path / "ourdb"),
                        [str(tmp_path / "a.vcf"), str(tmp_path / "b.vcf")],
                        is_vcf=True)
    for ext in (".bcf", ".pbf"):
        assert (tmp_path / f"ourdb{ext}").read_bytes() == \
            (tmp_path / f"refdb{ext}").read_bytes(), ext


def test_import_contig_list(tmp_path, ref_bgt):
    """``import -t FILE``: headerless VCF (no ##contig lines) imports via the
    supplied contig name/length list, byte-identical to the reference
    (import.c:35, vcf.c:382-401)."""
    vcf = testing.random_vcf(n_samples=6, n_sites=40, seed=7)
    lines = [ln for ln in vcf.splitlines() if not ln.startswith("##contig")]
    (tmp_path / "in.vcf").write_text("\n".join(lines) + "\n")
    (tmp_path / "ctg.txt").write_text("11\t135006516\textra ignored\n")
    res = run_ref(ref_bgt, ["import", "-t", "ctg.txt", "refdb", "in.vcf"], tmp_path)
    assert res.returncode == 0, res.stderr.decode()
    from bgt_tpu import cli
    rc = cli.main(["import", "-t", str(tmp_path / "ctg.txt"),
                   str(tmp_path / "ourdb"), str(tmp_path / "in.vcf")])
    assert rc == 0
    for ext in (".bcf", ".pbf", ".spl"):
        assert (tmp_path / f"ourdb{ext}").read_bytes() == \
            (tmp_path / f"refdb{ext}").read_bytes(), f"{ext} differs"


def test_atomize_contig_list(tmp_path, ref_bgt):
    vcf = testing.random_vcf(n_samples=4, n_sites=30, seed=8)
    lines = [ln for ln in vcf.splitlines() if not ln.startswith("##contig")]
    (tmp_path / "in.vcf").write_text("\n".join(lines) + "\n")
    (tmp_path / "ctg.txt").write_text("11 135006516\n")
    ref = run_ref(ref_bgt, ["atomize", "-t", "ctg.txt", "in.vcf"], tmp_path,
                  check=True)
    import io
    buf = io.StringIO()
    importer.atomize_cli(str(tmp_path / "in.vcf"), is_vcf=True, out_fp=buf,
                         fn_ref=str(tmp_path / "ctg.txt"))
    assert buf.getvalue() == ref.stdout.decode()


def test_native_import_used_and_matches_python(tmp_path, monkeypatch):
    """The one-pass C++ importer must actually serve text imports (no
    silent fallback) and produce byte-identical outputs to the Python
    pipeline across adversarial inputs."""
    from bgt_tpu import native
    if native.get_lib() is None:
        pytest.skip("native library unavailable")
    from bgt_tpu.query import importer as imp
    for seed, kw in [
        (21, dict(n_samples=7, n_sites=120, p_multi=0.5, p_indel=0.5)),
        (22, dict(n_samples=3, n_sites=200, p_missing=0.2, phased=False)),
        (23, dict(n_samples=12, n_sites=150, with_filter=True)),
    ]:
        vcf = testing.random_vcf(seed=seed, **kw)
        fn = tmp_path / f"in{seed}.vcf"
        fn.write_text(vcf)
        used = []
        orig = imp._native_import
        monkeypatch.setattr(imp, "_native_import",
                            lambda *a, **k: used.append(1) or orig(*a, **k))
        n1 = imp.import_vcf(str(tmp_path / f"nat{seed}"), [str(fn)],
                            is_vcf=True)
        monkeypatch.undo()
        assert used, "native importer was not attempted"
        monkeypatch.setenv("BGT_TPU_NATIVE_IMPORT", "0")
        n2 = imp.import_vcf(str(tmp_path / f"py{seed}"), [str(fn)],
                            is_vcf=True)
        monkeypatch.undo()
        assert n1 == n2
        for ext in (".bcf", ".pbf", ".spl"):
            assert (tmp_path / f"nat{seed}{ext}").read_bytes() == \
                (tmp_path / f"py{seed}{ext}").read_bytes(), (seed, ext)
        from bgt_tpu.formats.csi import HtsIndex
        a = HtsIndex.load(str(tmp_path / f"nat{seed}.bcf.csi"))
        b = HtsIndex.load(str(tmp_path / f"py{seed}.bcf.csi"))
        assert a.n_rec == b.n_rec and a.ridx == b.ridx
        for i in range(a.n):
            assert sorted(a.bidx[i]) == sorted(b.bidx[i])
            for bn in a.bidx[i]:
                assert sorted(a.bidx[i][bn]) == sorted(b.bidx[i][bn])
            assert a.loff[i] == b.loff[i]


def test_native_import_gzip_input(tmp_path):
    from bgt_tpu import native
    if native.get_lib() is None:
        pytest.skip("native library unavailable")
    import gzip as gz
    from bgt_tpu.query import importer as imp
    vcf = testing.random_vcf(n_samples=5, n_sites=80, seed=31)
    with gz.open(tmp_path / "in.vcf.gz", "wt") as fp:
        fp.write(vcf)
    (tmp_path / "in.vcf").write_text(vcf)
    n1 = imp.import_vcf(str(tmp_path / "a"), [str(tmp_path / "in.vcf.gz")],
                        is_vcf=True)
    n2 = imp.import_vcf(str(tmp_path / "b"), [str(tmp_path / "in.vcf")],
                        is_vcf=True)
    assert n1 == n2
    assert (tmp_path / "a.pbf").read_bytes() == (tmp_path / "b.pbf").read_bytes()
    assert (tmp_path / "a.bcf").read_bytes() == (tmp_path / "b.bcf").read_bytes()


@pytest.mark.parametrize("fixture", ["ex2.vcf", "ex3.vcf"])
def test_native_import_reference_fixtures(tmp_path, ref_bgt, monkeypatch, fixture):
    """The CIGAR/complex-overlap atomizer fixtures import byte-identically
    through the one-pass native importer (ex3 exercises INFO/CIGAR)."""
    from bgt_tpu import native
    if native.get_lib() is None:
        pytest.skip("native library unavailable")
    src = str(REF_DIR / fixture)
    res = run_ref(ref_bgt, ["import", "-S", "refdb", src], tmp_path)
    assert res.returncode == 0, res.stderr.decode()
    from bgt_tpu.query import importer as imp
    used = []
    orig = imp._native_import
    monkeypatch.setattr(imp, "_native_import",
                        lambda *a, **k: used.append(1) or orig(*a, **k))
    imp.import_vcf(str(tmp_path / "ourdb"), [src], is_vcf=True)
    assert used
    for ext in (".bcf", ".pbf", ".spl"):
        assert (tmp_path / f"ourdb{ext}").read_bytes() == \
            (tmp_path / f"refdb{ext}").read_bytes(), ext


def test_native_import_truncated_gzip_fails(tmp_path):
    """A truncated .vcf.gz must fail the import (the native reader must not
    treat stream truncation as clean EOF and emit a silently partial DB)."""
    from bgt_tpu import native
    if native.get_lib() is None:
        pytest.skip("native library unavailable")
    import gzip as gz
    vcf = testing.random_vcf(n_samples=5, n_sites=200, seed=41)
    with gz.open(tmp_path / "in.vcf.gz", "wt") as fp:
        fp.write(vcf)
    data = (tmp_path / "in.vcf.gz").read_bytes()
    (tmp_path / "trunc.vcf.gz").write_bytes(data[: len(data) // 2])
    calls = []
    orig = importer._native_import
    importer._native_import = \
        lambda *a, **k: (lambda r: (calls.append(r), r)[1])(orig(*a, **k))
    try:
        with pytest.raises(Exception):
            # the native path must reject the stream (returning None, its
            # partial outputs removed); the python fallback then raises on
            # the gzip error instead of any path reporting success
            importer.import_vcf(str(tmp_path / "bad"),
                                [str(tmp_path / "trunc.vcf.gz")], is_vcf=True)
    finally:
        importer._native_import = orig
    assert calls == [None], "native importer accepted a truncated stream"


def test_native_import_serves_bcf_and_appends(tmp_path, monkeypatch):
    """The native job API (open/add_text/add_bcf/finish) must serve binary
    BCF inputs and multi-file appends directly — no Python fallback — and
    match the Python pipeline byte-for-byte."""
    from bgt_tpu import native
    if native.get_lib() is None:
        pytest.skip("native library unavailable")
    from bgt_tpu.io import files
    from bgt_tpu.formats import bcf as bcflib
    from bgt_tpu.query import importer as imp

    full = testing.random_vcf(n_samples=9, n_sites=160, seed=31,
                              p_multi=0.3, p_indel=0.3)
    head = [l for l in full.splitlines() if l.startswith("#")]
    body = [l for l in full.splitlines() if l and not l.startswith("#")]
    half = len(body) // 2
    (tmp_path / "p1.vcf").write_text("\n".join(head + body[:half]) + "\n")
    (tmp_path / "p2.vcf").write_text("\n".join(head + body[half:]) + "\n")
    testing.vcf_text_to_bcf("\n".join(head + body[half:]) + "\n",
                            str(tmp_path / "p2.bcf"))

    for name, inputs in [
        ("bcfonly", ["p2.bcf"]),
        ("append", ["p1.vcf", "p2.vcf"]),
        ("mixed", ["p1.vcf", "p2.bcf"]),
    ]:
        paths = [str(tmp_path / f) for f in inputs]
        first = files.open_vcf(paths[0], None)
        h = first.header
        h0 = h.subset(None)
        if h0.id2int(bcflib.BCF_DT_ID, "GT") < 0:
            h0.append('##FORMAT=<ID=GT,Number=1,Type=String,'
                      'Description="Genotype">')
        h0.append('##INFO=<ID=_row,Number=1,Type=Integer,'
                  'Description="row number">')
        n = imp._native_import(
            str(tmp_path / f"nat_{name}"), paths, None,
            isinstance(first, files.VcfTextReader), h, h0, False, -1,
            h.n(bcflib.BCF_DT_SAMPLE))
        first.close()
        assert n is not None and n > 0, f"native path fell back on {name}"
        monkeypatch.setenv("BGT_TPU_NATIVE_IMPORT", "0")
        n2 = imp.import_vcf(str(tmp_path / f"py_{name}"), paths)
        monkeypatch.undo()
        assert n == n2
        for ext in (".bcf", ".pbf"):
            assert (tmp_path / f"nat_{name}{ext}").read_bytes() == \
                (tmp_path / f"py_{name}{ext}").read_bytes(), (name, ext)


def test_import_pb1(tmp_path, ref_bgt, monkeypatch):
    """``import -1`` emits the single-plane .pb1 byte-identically to the
    reference (import.c:24,37,74,101), on both the native and Python
    paths."""
    vcf = testing.random_vcf(n_samples=11, n_sites=90, seed=51,
                             p_multi=0.4, p_missing=0.1)
    (tmp_path / "in.vcf").write_text(vcf)
    res = run_ref(ref_bgt, ["import", "-1", "-S", "refdb", "in.vcf"],
                  tmp_path)
    assert res.returncode == 0, res.stderr.decode()
    from bgt_tpu import cli
    assert cli.main(["import", "-1", "-S", str(tmp_path / "ourdb"),
                     str(tmp_path / "in.vcf")]) == 0
    for ext in (".pbf", ".pb1", ".bcf"):
        assert (tmp_path / f"ourdb{ext}").read_bytes() == \
            (tmp_path / f"refdb{ext}").read_bytes(), ext
    monkeypatch.setenv("BGT_TPU_NATIVE_IMPORT", "0")
    assert cli.main(["import", "-1", "-S", str(tmp_path / "pydb"),
                     str(tmp_path / "in.vcf")]) == 0
    assert (tmp_path / "pydb.pb1").read_bytes() == \
        (tmp_path / "refdb.pb1").read_bytes()


def test_import_writes_sites_sidecar(tmp_path):
    """Native import emits the .sites.bin mmap sidecar identical to the
    lazy first-query build (reference import.c:117
    builds its index at import for the same reason)."""
    import numpy as np

    vcf = testing.random_vcf(n_samples=9, n_sites=120, seed=77, p_multi=0.3)
    (tmp_path / "in.vcf").write_text(vcf)
    n = importer.import_vcf(str(tmp_path / "db"), [str(tmp_path / "in.vcf")],
                            is_vcf=True)
    sidecar = tmp_path / "db.sites.bin"
    assert sidecar.exists(), "import must write the sidecar eagerly"
    from bgt_tpu.formats import sites as sites_fmt
    z = sites_fmt.load_sidecar(str(sidecar))
    assert z is not None and z["n"] == n
    z = {k: (np.array(v) if isinstance(v, np.memmap) else v)
         for k, v in z.items()}
    sidecar.unlink()

    from bgt_tpu.formats import bcf as bcflib
    from bgt_tpu.io.bgzf import BgzfReader
    from bgt_tpu.query.fastpath import SiteTable
    fp = BgzfReader(str(tmp_path / "db.bcf"))
    h0 = bcflib.BcfHeader.read_bcf(fp)
    fp.close()
    st = SiteTable(str(tmp_path / "db"), h0)  # lazy rebuild for comparison
    for k in ("rid", "pos", "rlen", "n_allele", "ref_len", "alt_len",
              "ref_off", "alt_off"):
        a, b = z[k], getattr(st, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert z["ref_cat"].tobytes() == st.ref_cat
    assert z["alt_cat"].tobytes() == st.alt_cat
    # and a legacy .sites.npz is still honored
    np.savez(str(tmp_path / "db.sites.npz"), rid=st.rid, pos=st.pos,
             rlen=np.asarray(st.rlen, np.int64),
             n_allele=st.n_allele,
             ref_len=np.asarray(st.ref_len, np.int64),
             alt_len=np.asarray(st.alt_len, np.int64),
             ref_cat=np.frombuffer(st.ref_cat, np.uint8),
             alt_cat=np.frombuffer(st.alt_cat, np.uint8))
    (tmp_path / "db.sites.bin").unlink()
    st2 = SiteTable(str(tmp_path / "db"), h0)
    assert np.array_equal(st2.pos, st.pos)
    assert st2.alt_cat == st.alt_cat


def test_csi_byte_parity_multi_contig(tmp_path, ref_bgt):
    """Hash-order .csi emission survives khash resizes/kick-outs and bin
    merges: byte parity on a 4-contig 4000-site input, through both the
    native and Python import paths (hts.c:453-476, khash.h:214-269)."""
    vcf = testing.random_vcf(n_samples=20, n_sites=4000, seed=13,
                             chroms=("1", "2", "11", "X"), p_multi=0.3)
    (tmp_path / "in.vcf").write_text(vcf)
    res = run_ref(ref_bgt, ["import", "-S", "refdb", "in.vcf"], tmp_path)
    assert res.returncode == 0, res.stderr.decode()
    importer.import_vcf(str(tmp_path / "nat"), [str(tmp_path / "in.vcf")],
                        is_vcf=True)
    want = (tmp_path / "refdb.bcf.csi").read_bytes()
    assert (tmp_path / "nat.bcf.csi").read_bytes() == want
    import os
    os.environ["BGT_TPU_NATIVE_IMPORT"] = "0"
    try:
        importer.import_vcf(str(tmp_path / "py"), [str(tmp_path / "in.vcf")],
                            is_vcf=True)
    finally:
        del os.environ["BGT_TPU_NATIVE_IMPORT"]
    assert (tmp_path / "py.bcf.csi").read_bytes() == want


def test_import_all_filtered_empty_db(tmp_path):
    """A fully-filtered input yields a 0-row database whose sidecar loads
    and queries cleanly (the mmap loader must not map past EOF)."""
    vcf = testing.random_vcf(n_samples=4, n_sites=10, seed=3,
                             with_filter=True)
    lines = []
    for ln in vcf.splitlines():
        if ln.startswith("#"):
            lines.append(ln)
            continue
        f = ln.split("\t")
        f[6] = "q10"
        lines.append("\t".join(f))
    (tmp_path / "in.vcf").write_text("\n".join(lines) + "\n")
    n = importer.import_vcf(str(tmp_path / "db"),
                            [str(tmp_path / "in.vcf")], is_vcf=True)
    assert n == 0
    import io
    import os
    from bgt_tpu.formats import bcf as bcflib
    from bgt_tpu.io.bgzf import BgzfReader
    from bgt_tpu.query.fastpath import SiteTable
    from bgt_tpu.query.view import main_view
    fp = BgzfReader(str(tmp_path / "db.bcf"))
    h0 = bcflib.BcfHeader.read_bcf(fp)
    fp.close()
    st = SiteTable(str(tmp_path / "db"), h0)
    assert st.n == 0
    buf = io.StringIO()
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        assert main_view(["-C", "db"], out=buf) == 0
    finally:
        os.chdir(old)
    assert all(ln.startswith("#") for ln in buf.getvalue().splitlines())
