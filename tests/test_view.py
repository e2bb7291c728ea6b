"""End-to-end `bgt view` byte parity against the reference binary.

Covers the five canonical test.sh pipelines (on synthetic data) plus region,
sample-subset, group, filter, allele-set, table, BED, paging and -S/-H modes.
"""

import io
import subprocess
from pathlib import Path

import pytest

from bgt_tpu import testing
from bgt_tpu.query import importer
from bgt_tpu.query.view import main_view


@pytest.fixture(scope="module")
def db(tmp_path_factory, ref_bgt):
    """One shared synthetic database imported by BOTH implementations."""
    tmp = tmp_path_factory.mktemp("viewdb")
    vcf = testing.random_vcf(n_samples=24, n_sites=300, seed=7, with_filter=True)
    (tmp / "in.vcf").write_text(vcf)
    res = subprocess.run([ref_bgt, "import", "-S", "refdb", "in.vcf"],
                         cwd=tmp, capture_output=True)
    assert res.returncode == 0, res.stderr.decode()
    importer.import_vcf(str(tmp / "ourdb"), [str(tmp / "in.vcf")], is_vcf=True)
    # metadata-extended .spl for expression queries
    spl = testing.random_spl(24, seed=7)
    (tmp / "refdb.spl").write_text(spl)
    (tmp / "ourdb.spl").write_text(spl)
    assert (tmp / "ourdb.bcf").read_bytes() == (tmp / "refdb.bcf").read_bytes()
    assert (tmp / "ourdb.pbf").read_bytes() == (tmp / "refdb.pbf").read_bytes()
    return tmp


CASES = [
    [],                                              # plain dump
    ["-C"],                                          # with AC/AN
    ["-G"],                                          # no GT
    ["-GC"],
    ["-r", "11:100000-200000"],
    ["-r", "11:100000-200000", "-C"],
    ["-s", ",S0001,S0003", "-f", "AC>0", "-r", "11:10000-300000"],
    ["-s", ",S0001,S0003,S0005", "-C"],
    ["-s", 'population=="CEU"', "-s", 'population=="YRI"',
     "-f", "AC1/AN1>=0.1&&AC2==0", "-G"],
    ["-s", 'gender=="M"', "-G", "-C"],
    ["-i", "10", "-n", "25"],
    ["-n", "0"],
    ["-f", "AN>40&&AC>2"],
    ["-t", "CHROM,POS,END,REF,ALT,AC,AN"],
    ["-s", 'population=="CEU"', "-s", 'population=="TSI"',
     "-t", "POS,AC1,AN1,AC2,AN2"],
]


def run_ours(args, cwd, dbname="ourdb"):
    buf = io.StringIO()
    errbuf = io.StringIO()
    import os
    old = os.getcwd()
    os.chdir(cwd)
    try:
        ret = main_view(args + [dbname], out=buf, err=errbuf)
    finally:
        os.chdir(old)
    assert ret == 0, errbuf.getvalue()
    return buf.getvalue()


@pytest.mark.parametrize("args", CASES, ids=[" ".join(c) or "plain" for c in CASES])
def test_view_parity(db, ref_bgt, args):
    ref = subprocess.run([ref_bgt, "view"] + args + ["refdb"], cwd=db,
                         capture_output=True)
    assert ref.returncode == 0, ref.stderr.decode()
    ours = run_ours(args, db)
    assert ours == ref.stdout.decode()


def test_view_bed_parity(db, ref_bgt):
    bed = "11\t10000\t150000\n11\t200000\t220000\n"
    (db / "t.bed").write_text(bed)
    for extra in ([], ["-e"]):
        ref = subprocess.run(
            [ref_bgt, "view", "-B", "t.bed"] + extra + ["-C", "refdb"],
            cwd=db, capture_output=True)
        assert ref.returncode == 0, ref.stderr.decode()
        ours = run_ours(["-B", "t.bed"] + extra + ["-C"], db)
        assert ours == ref.stdout.decode()


def test_view_alleles_parity(db, ref_bgt):
    # take some allele keys via getalt, query them back with -S and -H
    res = subprocess.run([ref_bgt, "getalt", "refdb"], cwd=db, capture_output=True)
    assert res.returncode == 0
    keys = res.stdout.decode().splitlines()
    pick = ",".join(keys[3:9])
    for mode in (["-C"], ["-S"], ["-H"]):
        ref = subprocess.run(
            [ref_bgt, "view", "-a," + pick] + mode + ["refdb"],
            cwd=db, capture_output=True)
        assert ref.returncode == 0, ref.stderr.decode()
        ours = run_ours(["-a," + pick] + mode, db)
        assert ours == ref.stdout.decode()


def test_graceful_cli_errors(db, tmp_path):
    """Missing/corrupt inputs die with [E::...] messages and exit code 1,
    never tracebacks (reference bgt_open, bgt.c:65-69)."""
    from bgt_tpu import cli

    def run_cli(args):
        errbuf = io.StringIO()
        import contextlib
        with contextlib.redirect_stderr(errbuf):
            rc = cli.main(args)
        return rc, errbuf.getvalue()

    rc, msg = run_cli(["view", str(tmp_path / "nonexistent")])
    assert rc == 1 and msg.startswith("[E::main_view] failed to open BGT")
    # corrupt magic
    (tmp_path / "corrupt.bcf").write_bytes(b"garbage")
    (tmp_path / "corrupt.pbf").write_bytes(b"garbage")
    rc, msg = run_cli(["view", str(tmp_path / "corrupt")])
    assert rc == 1 and msg.startswith("[E::main_view]")
    # missing BED / vardb files
    rc, msg = run_cli(["view", "-B", str(tmp_path / "no.bed"), str(db / "ourdb")])
    assert rc == 1 and "failed to open BED file" in msg
    rc, msg = run_cli(["view", "-M", "-d", str(tmp_path / "no.fmf"),
                       "-a", "x>0", str(db / "ourdb")])
    assert rc == 1 and "failed to open variant database" in msg
    # import of a missing input
    rc, msg = run_cli(["import", str(tmp_path / "o"), str(tmp_path / "no.vcf")])
    assert rc == 1 and msg.startswith("[E::main_import]")
    # pbfview of garbage
    rc, msg = run_cli(["pbfview", str(tmp_path / "corrupt.pbf")])
    assert rc == 1 and msg.startswith("[E::")


def _make_anno_fmf(db, ref_bgt) -> None:
    """Synthetic variant annotation DB: impact/csq columns per allele key."""
    if (db / "anno.fmf").exists():
        return
    res = subprocess.run([ref_bgt, "getalt", "refdb"], cwd=db, capture_output=True)
    assert res.returncode == 0
    keys = res.stdout.decode().splitlines()
    impacts = ["HIGH", "LOW", "MODERATE"]
    lines = []
    for i, k in enumerate(keys):
        lines.append(f"{k}\timpact:Z:{impacts[i % 3]}\tcsq_n:i:{i % 5}")
    (db / "anno.fmf").write_text("\n".join(lines) + "\n")


def test_annotation_join_parity(db, ref_bgt):
    """The fifth test.sh anchor: -d variant-FMF + -a kexpr over it
    (reference bgt.c:477-512, test.sh:35), streaming and -M in-memory."""
    _make_anno_fmf(db, ref_bgt)
    for expr in ['impact=="HIGH"', 'impact=="HIGH"||csq_n>3']:
        for mode in (["-CG"], ["-C"], ["-M", "-CG"]):
            ref = subprocess.run(
                [ref_bgt, "view", "-d", "anno.fmf", "-a" + expr] + mode + ["refdb"],
                cwd=db, capture_output=True)
            assert ref.returncode == 0, ref.stderr.decode()
            ours = run_ours(["-d", "anno.fmf", "-a" + expr] + mode, db)
            assert ours == ref.stdout.decode(), (expr, mode)


def test_annotation_join_S_H_parity(db, ref_bgt):
    """-d vardb feeding the -S carrier and -H haplotype counters."""
    _make_anno_fmf(db, ref_bgt)
    for mode in (["-S"], ["-H"]):
        ref = subprocess.run(
            [ref_bgt, "view", "-d", "anno.fmf", "-a", 'csq_n==1'] + mode + ["refdb"],
            cwd=db, capture_output=True)
        assert ref.returncode == 0, ref.stderr.decode()
        ours = run_ours(["-d", "anno.fmf", "-a", 'csq_n==1'] + mode, db)
        assert ours == ref.stdout.decode(), mode


def test_getalt_parity(db, ref_bgt):
    ref = subprocess.run([ref_bgt, "getalt", "refdb"], cwd=db, capture_output=True)
    buf = io.StringIO()
    from bgt_tpu.cli import main_getalt
    import os
    old = os.getcwd()
    os.chdir(db)
    try:
        main_getalt(["ourdb"], out=buf)
    finally:
        os.chdir(old)
    assert buf.getvalue() == ref.stdout.decode()


def test_multi_db_merge_parity(tmp_path, ref_bgt):
    """Two databases with different sample sets queried jointly."""
    v1 = testing.random_vcf(n_samples=8, n_sites=120, seed=11, sample_prefix="A")
    v2 = testing.random_vcf(n_samples=6, n_sites=110, seed=12, sample_prefix="B")
    (tmp_path / "a.vcf").write_text(v1)
    (tmp_path / "b.vcf").write_text(v2)
    for name in ("a", "b"):
        res = subprocess.run([ref_bgt, "import", "-S", f"ref{name}", f"{name}.vcf"],
                             cwd=tmp_path, capture_output=True)
        assert res.returncode == 0, res.stderr.decode()
        importer.import_vcf(str(tmp_path / f"our{name}"),
                            [str(tmp_path / f"{name}.vcf")], is_vcf=True)
    for args in ([], ["-C"], ["-G", "-C"], ["-r", "11:10000-120000", "-C"]):
        ref = subprocess.run([ref_bgt, "view"] + args + ["refa", "refb"],
                             cwd=tmp_path, capture_output=True)
        assert ref.returncode == 0, ref.stderr.decode()
        buf = io.StringIO()
        import os
        old = os.getcwd()
        os.chdir(tmp_path)
        try:
            ret = main_view(args + ["oura", "ourb"], out=buf)
        finally:
            os.chdir(old)
        assert ret == 0
        assert buf.getvalue() == ref.stdout.decode(), f"args {args}"


def test_multi_db_allele_set_parity(tmp_path, ref_bgt):
    """-a allele sets joint with the multi-DB merge (the fastpath allele
    prefilter must match al_present under the k-way merge)."""
    v1 = testing.random_vcf(n_samples=7, n_sites=100, seed=41, sample_prefix="A")
    v2 = testing.random_vcf(n_samples=5, n_sites=90, seed=42, sample_prefix="B")
    (tmp_path / "a.vcf").write_text(v1)
    (tmp_path / "b.vcf").write_text(v2)
    for name in ("a", "b"):
        res = subprocess.run([ref_bgt, "import", "-S", f"ref{name}", f"{name}.vcf"],
                             cwd=tmp_path, capture_output=True)
        assert res.returncode == 0, res.stderr.decode()
        importer.import_vcf(str(tmp_path / f"our{name}"),
                            [str(tmp_path / f"{name}.vcf")], is_vcf=True)
    keys = subprocess.run([ref_bgt, "getalt", "refa"], cwd=tmp_path,
                          capture_output=True).stdout.decode().splitlines()
    keys += subprocess.run([ref_bgt, "getalt", "refb"], cwd=tmp_path,
                           capture_output=True).stdout.decode().splitlines()
    pick = ",".join(keys[2:20:3])
    for args in (["-a," + pick, "-C"], ["-a," + pick, "-C", "-G"]):
        ref = subprocess.run([ref_bgt, "view"] + args + ["refa", "refb"],
                             cwd=tmp_path, capture_output=True)
        assert ref.returncode == 0, ref.stderr.decode()
        buf = io.StringIO()
        import os
        old = os.getcwd()
        os.chdir(tmp_path)
        try:
            ret = main_view(args + ["oura", "ourb"], out=buf)
        finally:
            os.chdir(old)
        assert ret == 0
        assert buf.getvalue() == ref.stdout.decode(), f"args {args}"


def test_cross_reading(db, ref_bgt):
    """The reference binary must be able to query OUR database files."""
    ref_on_ours = subprocess.run([ref_bgt, "view", "-C", "ourdb"], cwd=db,
                                 capture_output=True)
    assert ref_on_ours.returncode == 0, ref_on_ours.stderr.decode()
    ref_on_ref = subprocess.run([ref_bgt, "view", "-C", "refdb"], cwd=db,
                                capture_output=True)
    assert ref_on_ours.stdout == ref_on_ref.stdout
    # and we must query THEIR database
    ours = run_ours(["-C"], db, dbname="refdb")
    assert ours == ref_on_ref.stdout.decode()


def test_multi_db_groups_and_filters(tmp_path, ref_bgt):
    """Groups spanning DBs, filters, table output through the merged fastpath."""
    v1 = testing.random_vcf(n_samples=7, n_sites=100, seed=41, sample_prefix="A")
    v2 = testing.random_vcf(n_samples=5, n_sites=90, seed=42, sample_prefix="B")
    (tmp_path / "a.vcf").write_text(v1)
    (tmp_path / "b.vcf").write_text(v2)
    spl_a = testing.random_spl(7, seed=41, sample_prefix="A")
    spl_b = testing.random_spl(5, seed=42, sample_prefix="B")
    for name, vcf, spl in (("a", "a.vcf", spl_a), ("b", "b.vcf", spl_b)):
        res = subprocess.run([ref_bgt, "import", "-S", f"ref{name}", vcf],
                             cwd=tmp_path, capture_output=True)
        assert res.returncode == 0, res.stderr.decode()
        importer.import_vcf(str(tmp_path / f"our{name}"),
                            [str(tmp_path / f"{name}.vcf")], is_vcf=True)
        (tmp_path / f"ref{name}.spl").write_text(spl)
        (tmp_path / f"our{name}.spl").write_text(spl)
    cases = [
        ["-G", "-f", "AC>1"],
        ["-s", 'gender=="M"', "-s", 'gender=="F"', "-G"],
        ["-s", ",A0001,B0002,B0004", "-C"],
        ["-t", "CHROM,POS,REF,ALT,AC,AN"],
        ["-i", "5", "-n", "20", "-C"],
    ]
    for args in cases:
        ref = subprocess.run([ref_bgt, "view"] + args + ["refa", "refb"],
                             cwd=tmp_path, capture_output=True)
        assert ref.returncode == 0, ref.stderr.decode()
        buf = io.StringIO()
        import os
        old = os.getcwd()
        os.chdir(tmp_path)
        try:
            ret = main_view(args + ["oura", "ourb"], out=buf)
        finally:
            os.chdir(old)
        assert ret == 0
        assert buf.getvalue() == ref.stdout.decode(), f"args {args}"


def test_multi_db_duplicate_sites(tmp_path, ref_bgt):
    """The same VCF imported twice: duplicate keys pair occurrence-wise."""
    v = testing.random_vcf(n_samples=4, n_sites=40, seed=43)
    (tmp_path / "in.vcf").write_text(v)
    # concatenating the file with itself creates duplicate atoms per DB
    doubled_body = []
    header_lines = []
    for line in v.splitlines():
        (header_lines if line.startswith("#") else doubled_body).append(line)
    dup = "\n".join(header_lines + [l for l in doubled_body for _ in (0, 1)]) + "\n"
    (tmp_path / "dup.vcf").write_text(dup)
    for name, src in (("x", "in.vcf"), ("y", "dup.vcf")):
        res = subprocess.run([ref_bgt, "import", "-S", f"ref{name}", src],
                             cwd=tmp_path, capture_output=True)
        assert res.returncode == 0, res.stderr.decode()
        importer.import_vcf(str(tmp_path / f"our{name}"),
                            [str(tmp_path / src)], is_vcf=True)
    for args in ([], ["-C"], ["-G", "-C"]):
        ref = subprocess.run([ref_bgt, "view"] + args + ["refx", "refy"],
                             cwd=tmp_path, capture_output=True)
        assert ref.returncode == 0, ref.stderr.decode()
        buf = io.StringIO()
        import os
        old = os.getcwd()
        os.chdir(tmp_path)
        try:
            ret = main_view(args + ["ourx", "oury"], out=buf)
        finally:
            os.chdir(old)
        assert ret == 0
        assert buf.getvalue() == ref.stdout.decode(), f"args {args}"


def test_multi_contig_parity(tmp_path, ref_bgt):
    """Databases spanning several chromosomes: regions, filters, dumps."""
    vcf = testing.random_vcf(n_samples=10, n_sites=60, seed=71,
                             chroms=("11", "12", "X"))
    (tmp_path / "in.vcf").write_text(vcf)
    res = subprocess.run([ref_bgt, "import", "-S", "refdb", "in.vcf"],
                         cwd=tmp_path, capture_output=True)
    assert res.returncode == 0, res.stderr.decode()
    importer.import_vcf(str(tmp_path / "ourdb"), [str(tmp_path / "in.vcf")],
                        is_vcf=True)
    assert (tmp_path / "ourdb.bcf").read_bytes() == (tmp_path / "refdb.bcf").read_bytes()
    cases = [
        ["-C"],
        ["-r", "12", "-C"],                  # whole-chromosome region
        ["-r", "X:10000-200000", "-C"],
        ["-r", "11:50000-90000"],
        ["-G", "-f", "AC>0", "-r", "12:1-135006516"],
        ["-i", "30", "-n", "40", "-C"],      # paging across a contig boundary
    ]
    for args in cases:
        ref = subprocess.run([ref_bgt, "view"] + args + ["refdb"], cwd=tmp_path,
                             capture_output=True)
        assert ref.returncode == 0, ref.stderr.decode()
        ours = run_ours(args, tmp_path)
        assert ours == ref.stdout.decode(), f"args {args}"


def test_mgs_privacy_parity(tmp_path, ref_bgt):
    """_mgs-protected samples: GT suppression and name-list gating."""
    vcf = testing.random_vcf(n_samples=8, n_sites=50, seed=72)
    (tmp_path / "in.vcf").write_text(vcf)
    subprocess.run([ref_bgt, "import", "-S", "refdb", "in.vcf"], cwd=tmp_path,
                   capture_output=True, check=True)
    importer.import_vcf(str(tmp_path / "ourdb"), [str(tmp_path / "in.vcf")],
                        is_vcf=True)
    spl = []
    for i in range(8):
        mgs = "\t_mgs:i:5" if i in (2, 5) else ""
        spl.append(f"S{i:04d}\tpopulation:Z:{'CEU' if i < 4 else 'YRI'}{mgs}")
    (tmp_path / "refdb.spl").write_text("\n".join(spl) + "\n")
    (tmp_path / "ourdb.spl").write_text("\n".join(spl) + "\n")
    cases = [
        ["-C"],                               # S0002/S0005 GT suppressed
        ["-s", ",S0002,S0003", "-C"],         # protected name silently dropped
        ["-s", 'population=="CEU"', "-C"],    # expression includes protected
    ]
    for args in cases:
        ref = subprocess.run([ref_bgt, "view"] + args + ["refdb"], cwd=tmp_path,
                             capture_output=True)
        assert ref.returncode == 0, ref.stderr.decode()
        ours = run_ours(args, tmp_path)
        assert ours == ref.stdout.decode(), f"args {args}"


def test_atomize_modes_parity(tmp_path, ref_bgt):
    """bgt atomize -0 / default / -M three-way genotype policies."""
    import io as _io
    from bgt_tpu.query.importer import atomize_cli
    vcf = testing.random_vcf(n_samples=6, n_sites=60, seed=73, p_multi=0.5)
    (tmp_path / "in.vcf").write_text(vcf)
    for flags, kwargs in [
        ([], {}),
        (["-M"], {"write_m": True}),
        (["-0"], {"use_missing": False}),
    ]:
        ref = subprocess.run([ref_bgt, "atomize", "-S"] + flags + ["in.vcf"],
                             cwd=tmp_path, capture_output=True)
        assert ref.returncode == 0
        buf = _io.StringIO()
        atomize_cli(str(tmp_path / "in.vcf"), is_vcf=True, out_fp=buf, **kwargs)
        assert buf.getvalue() == ref.stdout.decode(), flags


def test_fmf_cli_parity(tmp_path, ref_bgt):
    """bgt fmf in-memory and streaming modes vs the reference binary."""
    import io as _io
    from bgt_tpu.cli import main_fmf
    fmf = ("r1\tage:i:30\tpop:Z:CEU\tflagged\n"
           "r2\tage:i:45\tpop:Z:YRI\tscore:f:0.75\n"
           "r3\tpop:Z:CEU\n"
           "r4\tage:i:0\tscore:f:-1.5\n")
    (tmp_path / "t.fmf").write_text(fmf)
    for args in (["t.fmf"], ["t.fmf", 'pop=="CEU"'], ["-n", "t.fmf", "age>35"],
                 ["-m", "t.fmf", 'age>20&&pop=="CEU"'], ["-m", "-n", "t.fmf", "score<0"]):
        ref = subprocess.run([ref_bgt, "fmf"] + args, cwd=tmp_path,
                             capture_output=True)
        assert ref.returncode == 0
        buf = _io.StringIO()
        import os as _os
        old = _os.getcwd()
        _os.chdir(tmp_path)
        try:
            assert main_fmf(args, out=buf) == 0
        finally:
            _os.chdir(old)
        assert buf.getvalue() == ref.stdout.decode(), args


def test_alcnt_hapcnt_deep_parity(db, ref_bgt):
    """-S/-H through the batched fastpath: region and
    subset interplay, group quirk, ref-allele keys, the -n read-one-extra
    quirk, and -t table mode with allele sets."""
    res = subprocess.run([ref_bgt, "getalt", "refdb"], cwd=db,
                         capture_output=True)
    keys = res.stdout.decode().splitlines()
    pick = ",".join(keys[2:40])
    cases = [
        ["-a," + pick, "-S"],
        ["-a," + pick, "-H"],
        ["-a," + pick, "-S", "-H"],
        ["-a," + pick, "-S", "-s", ",S0001,S0003,S0005"],
        ["-a," + pick, "-H", "-s", 'population=="CEU"', "-s",
         'population=="YRI"'],
        ["-a," + pick, "-S", "-r", "11:1-150000"],
        ["-a," + pick, "-S", "-n", "3"],
        ["-a," + pick, "-H", "-n", "2"],
        ["-a," + pick, "-S", "-n", "0"],
        ["-a," + pick, "-S", "-f", "AC>1"],
        ["-a," + pick, "-H", "-f", "AN>0&&AC>0"],
        ["-a," + pick, "-t", "AC,AN", "-S"],
    ]
    for args in cases:
        ref = subprocess.run([ref_bgt, "view"] + args + ["refdb"],
                             cwd=db, capture_output=True)
        assert ref.returncode == 0, (args, ref.stderr.decode())
        ours = run_ours(args, db)
        assert ours == ref.stdout.decode(), args


def test_alcnt_ref_allele_keys(db, ref_bgt):
    """-a with REF-side keys: al_present returns 2 and -S counts code 0
    carriers (bgt.c:860-869 target flip)."""
    res = subprocess.run([ref_bgt, "getalt", "refdb"], cwd=db,
                         capture_output=True)
    keys = res.stdout.decode().splitlines()
    # build ref-side keys: chrom:pos:rlen:REF from the site table
    from bgt_tpu.query import engine as eng
    import os
    old = os.getcwd()
    os.chdir(db)
    try:
        bf = eng.BgtFile("ourdb")
        refkeys = []
        import numpy as np
        from bgt_tpu.query.fastpath import get_site_table
        st = get_site_table(bf)
        for r in range(0, min(st.n, 60), 3):
            ref = st.refs[r].decode("latin-1")
            alt = st.alts[r].decode("latin-1")
            min_l = min(len(ref), len(alt))
            s = 0
            while s < min_l and ref[s] == alt[s]:
                s += 1
            refkeys.append(f"11:{int(st.pos[r]) + 1 + s}:"
                           f"{int(st.rlen[r]) - s}:{ref[s:]}")
    finally:
        os.chdir(old)
    pick = ",".join(refkeys[:12])
    for mode in (["-S"], ["-H"], ["-S", "-H"]):
        ref = subprocess.run([ref_bgt, "view", "-a," + pick] + mode + ["refdb"],
                             cwd=db, capture_output=True)
        assert ref.returncode == 0, ref.stderr.decode()
        ours = run_ours(["-a," + pick] + mode, db)
        assert ours == ref.stdout.decode(), mode


def test_alcnt_hapcnt_multidb(tmp_path, ref_bgt):
    """-S/-H across a 2-database merge (missing-fill interplay)."""
    for name, seed, n in (("a", 61, 10), ("b", 62, 14)):
        vcf = testing.random_vcf(n_samples=n, n_sites=120, seed=seed,
                                 sample_prefix=name.upper())
        (tmp_path / f"{name}.vcf").write_text(vcf)
        res = subprocess.run([ref_bgt, "import", "-S", f"ref{name}",
                              f"{name}.vcf"], cwd=tmp_path, capture_output=True)
        assert res.returncode == 0, res.stderr.decode()
        importer.import_vcf(str(tmp_path / f"our{name}"),
                            [str(tmp_path / f"{name}.vcf")], is_vcf=True)
    res = subprocess.run([ref_bgt, "getalt", "refa"], cwd=tmp_path,
                         capture_output=True)
    keys = res.stdout.decode().splitlines()
    pick = ",".join(keys[1:30:2])
    for mode in (["-S"], ["-H"], ["-S", "-n", "4"]):
        ref = subprocess.run(
            [ref_bgt, "view", "-a," + pick] + mode + ["refa", "refb"],
            cwd=tmp_path, capture_output=True)
        assert ref.returncode == 0, ref.stderr.decode()
        buf = io.StringIO()
        import os
        old = os.getcwd()
        os.chdir(tmp_path)
        try:
            ret = main_view(["-a," + pick] + mode + ["oura", "ourb"], out=buf)
        finally:
            os.chdir(old)
        assert ret == 0
        assert buf.getvalue() == ref.stdout.decode(), mode


def test_merge_lexsort_vs_dict_oracle(tmp_path, ref_bgt):
    """The vectorized union merge must equal the dict merge field-for-field
    on overlapping multi-DB row sets (including duplicate atom keys)."""
    import numpy as np
    from bgt_tpu.query import engine as eng, fastpath, view as viewmod
    dbs = []
    for name, seed, n in (("x", 71, 8), ("y", 72, 12), ("z", 73, 5)):
        vcf = testing.random_vcf(n_samples=n, n_sites=200, seed=seed,
                                 p_multi=0.4, p_indel=0.4,
                                 sample_prefix=name.upper())
        (tmp_path / f"{name}.vcf").write_text(vcf)
        importer.import_vcf(str(tmp_path / name),
                            [str(tmp_path / f"{name}.vcf")], is_vcf=True)
        dbs.append(str(tmp_path / name))
    bfiles = [eng.BgtFile(p) for p in dbs]
    bm = eng.BgtmReader(bfiles)
    bm.prepare()
    opt = viewmod.ViewOpt() if hasattr(viewmod, "ViewOpt") else None
    fv = fastpath.FastView(bm, opt)
    rng = np.random.default_rng(5)
    for trial in range(6):
        rows_per_db = []
        for ctx in fv.dbs:
            n_sites = ctx.st.n
            k = int(rng.integers(0, n_sites + 1))
            rows_per_db.append(np.sort(rng.choice(n_sites, k, replace=False))
                               .astype(np.int64))
        b = fv._merge_dict(rows_per_db)
        variants = {"lexsort": fv._merge_lexsort(rows_per_db),
                    "native": fv._merge(rows_per_db)}
        for label, a in variants.items():
            assert a is not None, label
            assert a.n == b.n, (trial, label)
            assert np.array_equal(a.pres, b.pres), (trial, label)
            for f in ("rid", "pos", "rlen", "n_allele", "ref_len", "alt_len",
                      "ref_off", "alt_off"):
                assert np.array_equal(getattr(a, f), getattr(b, f)), \
                    (trial, label, f)
            assert bytes(a.ref_cat) == b.ref_cat, (trial, label)
            assert bytes(a.alt_cat) == b.alt_cat, (trial, label)
    bm.close()


def test_al_filter_inverted_matches_walk(tmp_path, ref_bgt):
    """Small -a sets over large site counts take the probe-per-key path;
    it must select exactly the rows of the full walk (incl. region
    intersection and ref-side keys), and stay byte-parity with the
    reference."""
    import numpy as np
    vcf = testing.random_vcf(n_samples=6, n_sites=1500, seed=91,
                             p_indel=0.3, p_multi=0.3)
    (tmp_path / "in.vcf").write_text(vcf)
    res = subprocess.run([ref_bgt, "import", "-S", "refdb", "in.vcf"],
                         cwd=tmp_path, capture_output=True)
    assert res.returncode == 0
    importer.import_vcf(str(tmp_path / "ourdb"), [str(tmp_path / "in.vcf")],
                        is_vcf=True)
    keys = subprocess.run([ref_bgt, "getalt", "refdb"], cwd=tmp_path,
                          capture_output=True).stdout.decode().splitlines()
    pick = ",".join(keys[5:20:3])  # 5 keys vs 1500+ sites -> inverted path
    from bgt_tpu.query import engine as eng, fastpath
    from bgt_tpu.query.view import ViewOptions
    import os
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        bf = eng.BgtFile("ourdb")
        bm = eng.BgtmReader([bf])
        assert bm.set_alleles("," + pick, None, None) > 0
        bm.prepare()
        opt = ViewOptions()
        fv = fastpath.FastView(bm, opt)
        ctx = fv.dbs[0]
        rows = np.arange(ctx.st.n)
        assert rows.size > 64 * len(bm.h_al)
        inv = ctx._al_filter_inverted(rows)
        walk = ctx._al_filter_walk(rows)
        assert inv is not None and np.array_equal(inv, walk)
        assert inv.size > 0
        # region-limited selection intersects correctly
        sub = rows[rows % 2 == 0]
        inv2 = ctx._al_filter_inverted(sub)
        walk2 = walk[np.isin(walk, sub)]
        assert np.array_equal(inv2, walk2)
        bm.close()
    finally:
        os.chdir(old)
    for mode in (["-S"], ["-H"], ["-C"]):
        ref = subprocess.run([ref_bgt, "view", "-a," + pick] + mode + ["refdb"],
                             cwd=tmp_path, capture_output=True)
        assert ref.returncode == 0
        ours = run_ours(["-a," + pick] + mode, tmp_path)
        assert ours == ref.stdout.decode(), mode
