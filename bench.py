#!/usr/bin/env python
"""Benchmark: canonical counting query (view -GC) vs the reference binary.

Two databases (built once, cached under build/bench/):
  - 1kg11: 2,504 samples x 100k sites (the canonical 1kg-chr11 shape)
  - hrc:   32,488 samples x 30k sites (HRC-shaped: wide sample axis)

Gates (per config): import byte parity (.bcf/.pbf) and md5 byte parity of
the full `view -GC` stream against the reference binary.

Measurements: warm `view -GC` (best of 3, in-process), TRUE cold `view
-GC` (fresh subprocess, includes tile load), sample-subset `-GC -s` (the
device masked-popcount path: first = device pass + transfers, repeat =
memoized), full `view -C` genotype dump, and import time, all against the
reference binary timed on this same machine and data.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "extra"}
where value is the warm 1kg11 sites/s and vs_baseline the speedup over the
reference for that same query.
"""

import hashlib
import io
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

BENCH_DIR = REPO / "build" / "bench"

CONFIGS = {
    "1kg11": dict(n_samples=2504, n_sites=100_000, seed=1337),
    "hrc": dict(n_samples=32_488, n_sites=30_000, seed=2026),
}
PRIMARY = "1kg11"


def log(*a):
    print("[bench]", *a, file=sys.stderr, flush=True)


def ensure_ref():
    exe = REPO / "build" / "ref" / "bgt"
    if not exe.exists():
        subprocess.run(["sh", str(REPO / "tools" / "build_reference.sh")],
                       check=True, capture_output=True)
    return str(exe)


def _paths(name):
    d = BENCH_DIR / name
    return d, d / "ourdb", d / "refdb"


def ensure_db(ref_bgt: str, name: str) -> dict:
    cfg = CONFIGS[name]
    d, our, ref = _paths(name)
    d.mkdir(parents=True, exist_ok=True)
    stamp = d / f"stamp-{cfg['n_samples']}x{cfg['n_sites']}-{cfg['seed']}"
    meta = {}
    if stamp.exists():
        return json.loads(stamp.read_text())
    from bgt_tpu import testing
    from bgt_tpu.query import importer

    gen_stamp = d / f"genstamp-{cfg['n_samples']}x{cfg['n_sites']}-{cfg['seed']}"
    if not gen_stamp.exists():
        log(f"[{name}] generating cohort VCF "
            f"({cfg['n_samples']} samples x {cfg['n_sites']} sites)...")
        t0 = time.time()
        if name == PRIMARY:
            # string builder kept for byte-compat with previously cached DBs
            (d / "in.vcf").write_text(testing.cohort_vcf(
                n_samples=cfg["n_samples"], n_sites=cfg["n_sites"],
                seed=cfg["seed"]))
        else:
            testing.cohort_vcf_to_file(str(d / "in.vcf"),
                                       n_samples=cfg["n_samples"],
                                       n_sites=cfg["n_sites"], seed=cfg["seed"])
        log(f"[{name}] generated in {time.time() - t0:.0f}s "
            f"({(d / 'in.vcf').stat().st_size / 1e9:.2f} GB)")
        gen_stamp.write_text("ok")
    log(f"[{name}] importing (ours)...")
    # warm the input's page cache first: ours imports before the reference,
    # so without this the reference would be timed on a file we just warmed
    buf = bytearray(32 << 20)
    with open(d / "in.vcf", "rb", buffering=0) as fp:
        while fp.readinto(buf):
            pass
    t0 = time.time()
    n = importer.import_vcf(str(our), [str(d / "in.vcf")], is_vcf=True)
    meta["import_ours_s"] = round(time.time() - t0, 2)
    log(f"[{name}] our import: {n} rows in {meta['import_ours_s']}s")
    log(f"[{name}] importing (reference)...")
    t0 = time.time()
    subprocess.run([ref_bgt, "import", "-S", "refdb", "in.vcf"], cwd=d,
                   check=True, capture_output=True)
    meta["import_ref_s"] = round(time.time() - t0, 2)
    log(f"[{name}] reference import: {meta['import_ref_s']}s")
    for ext in (".bcf", ".pbf"):
        a = Path(str(our) + ext).read_bytes()
        b = Path(str(ref) + ext).read_bytes()
        assert a == b, f"[{name}] import {ext} parity failure"
    meta["n_rows"] = n
    stamp.write_text(json.dumps(meta))
    return meta


class _Null(io.TextIOBase):
    """Line-counting sink with a binary buffer (like a real stdout)."""

    def __init__(self):
        self.n = 0

        class B:
            def write(b, data):
                return len(data)  # timing sink: no byte scans on GB chunks

            def flush(b):
                pass

        self.buffer = B()

    def write(self, s):
        self.n += s.count("\n")
        return len(s)


class _Md5Sink(io.TextIOBase):
    def __init__(self):
        self.h = hashlib.md5()
        outer = self

        class B:
            def write(b, data):
                outer.h.update(data)
                return len(data)

            def flush(b):
                pass

        self.buffer = B()

    def write(self, s):
        self.h.update(s.encode("latin-1"))
        return len(s)


def ref_md5(ref_bgt, d, args, cache_name) -> str:
    """md5 of a reference query, cached on disk next to the database."""
    cache = d / cache_name
    if cache.exists():
        return cache.read_text().strip()
    h = hashlib.md5()
    with subprocess.Popen([ref_bgt, "view"] + args + ["refdb"], cwd=d,
                          stdout=subprocess.PIPE) as p:
        for blk in iter(lambda: p.stdout.read(1 << 20), b""):
            h.update(blk)
    assert p.returncode == 0
    digest = h.hexdigest()
    cache.write_text(digest + "\n")
    return digest


def ours_md5(d, args) -> str:
    from bgt_tpu.query.view import main_view
    sink = _Md5Sink()
    old = os.getcwd()
    os.chdir(d)
    try:
        assert main_view(args + ["ourdb"], out=sink) == 0
    finally:
        os.chdir(old)
    return sink.h.hexdigest()


def time_ref(ref_bgt, d, args, runs=3) -> float:
    best = float("inf")
    for _ in range(runs):
        t0 = time.time()
        subprocess.run([ref_bgt, "view"] + args + ["refdb"], cwd=d,
                       stdout=subprocess.DEVNULL, check=True)
        best = min(best, time.time() - t0)
    return best


def time_ours(d, args, runs=3):
    from bgt_tpu.query.view import main_view
    best = float("inf")
    n_lines = 0
    for _ in range(runs):
        sink = _Null()
        t0 = time.time()
        assert main_view(args + [str(d / "ourdb")], out=sink) == 0
        best = min(best, time.time() - t0)
        n_lines = sink.n
    return best, n_lines


def _timed_subprocess(cmd) -> float:
    t0 = time.time()
    subprocess.run(cmd, check=True, stdout=subprocess.DEVNULL,
                   stderr=subprocess.DEVNULL)
    return time.time() - t0


def time_ours_cold(d, args) -> float:
    """TRUE cold: fresh interpreter, nothing warmed (includes tile load)."""
    script = (
        "import sys, time, io, os\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        f"os.chdir({str(d)!r})\n"
        "from bgt_tpu.query.view import main_view\n"
        "class N(io.TextIOBase):\n"
        "    def write(self, s): return len(s)\n"
        "t0 = time.time()\n"
        f"assert main_view({args!r} + ['ourdb'], out=N()) == 0\n"
        "print('COLD %.3f' % (time.time() - t0))\n"
    )
    out = subprocess.run([sys.executable, "-c", script],
                         capture_output=True, text=True, check=True)
    for line in out.stdout.splitlines():
        if line.startswith("COLD "):
            return float(line.split()[1])
    raise RuntimeError("cold run produced no timing")


def bench_config(ref_bgt: str, name: str, extra: dict) -> float | None:
    d, our, ref = _paths(name)
    meta = ensure_db(ref_bgt, name)
    ex = extra.setdefault(name, {})
    ex["import_ours_s"] = meta.get("import_ours_s")
    ex["import_ref_s"] = meta.get("import_ref_s")

    if name == PRIMARY:
        # --- BCF-format input import (native BCF front-end; both engines
        # are PBWT-encode-bound here, unlike the text-parse-bound path) ---
        from bgt_tpu.query import importer as _imp
        bcf_in = d / "in_gt.bcf"
        if not bcf_in.exists():
            with open(bcf_in, "wb") as fp:
                subprocess.run([ref_bgt, "view", "-b", "-C", "refdb"],
                               cwd=d, stdout=fp, check=True)
        t0 = time.time()
        subprocess.run([ref_bgt, "import", "refdb_b", "in_gt.bcf"], cwd=d,
                       check=True, capture_output=True)
        ex["import_bcf_ref_s"] = round(time.time() - t0, 2)
        t0 = time.time()
        _imp.import_vcf(str(d / "ourdb_b"), [str(bcf_in)])
        ex["import_bcf_ours_s"] = round(time.time() - t0, 2)
        ex["parity_import_bcf"] = (
            (d / "ourdb_b.pbf").read_bytes()
            == (d / "refdb_b.pbf").read_bytes())
        log(f"[{name}] BCF-input import: ours {ex['import_bcf_ours_s']}s vs "
            f"ref {ex['import_bcf_ref_s']}s, parity "
            f"{ex['parity_import_bcf']}")

    # --- parity gate: full view -GC stream ---
    want = ref_md5(ref_bgt, d, ["-G", "-C"], "md5-gc.txt")
    got = ours_md5(d, ["-G", "-C"])
    parity = want == got
    ex["parity_gc"] = parity
    if not parity:
        log(f"[{name}] FULL -GC PARITY FAILED")
    else:
        log(f"[{name}] full -GC md5 parity OK")

    # --- the counting query ---
    runs = 3 if name == PRIMARY else 2
    t_ref = time_ref(ref_bgt, d, ["-G", "-C"], runs)
    t_warm, n_lines = time_ours(d, ["-G", "-C"], runs)
    n_sites = meta["n_rows"]
    log(f"[{name}] view -GC: ref {t_ref:.2f}s, ours warm {t_warm * 1e3:.1f}ms "
        f"({t_ref / t_warm:.0f}x), {n_sites / t_warm:,.0f} sites/s")
    ex["gc_ref_s"] = round(t_ref, 3)
    ex["gc_warm_s"] = round(t_warm, 4)
    ex["gc_speedup"] = round(t_ref / t_warm, 1)
    t_cold = time_ours_cold(d, ["-G", "-C"])
    ex["gc_cold_s"] = round(t_cold, 3)
    # the structural cold floor: a fresh interpreter importing numpy (the
    # query engine's array substrate); cold time below this is unreachable
    # for a Python CLI — recorded so the cold ratio has its context
    t_floor = min(
        _timed_subprocess([sys.executable, "-c", "import numpy"])
        for _ in range(3))
    ex["cold_floor_s"] = round(t_floor, 3)
    log(f"[{name}] view -GC TRUE cold (fresh process): {t_cold:.2f}s "
        f"({t_ref / t_cold:.1f}x ref; interpreter+numpy floor "
        f"{t_floor:.2f}s = {t_ref / t_floor:.0f}x ceiling)")

    # --- -S carrier query over a 40-allele set (the alcnt accumulator,
    # batched in the fastpath since r3; reference bgt.c:859-869) ---
    alleles = d / "alleles.txt"
    if not alleles.exists():
        keys = subprocess.run([ref_bgt, "getalt", "refdb"], cwd=d,
                              capture_output=True,
                              check=True).stdout.decode().splitlines()
        alleles.write_text("\n".join(keys[10:90:2]) + "\n")
    s_args = ["-a", "alleles.txt", "-S", "-H"]
    want = ref_md5(ref_bgt, d, s_args, "md5-alhap.txt")
    t0 = time.time()
    got = ours_md5(d, s_args)
    t_ours_s = time.time() - t0
    t0 = time.time()
    got = ours_md5(d, s_args)  # warm repeat (site table cached)
    t_ours_s = min(t_ours_s, time.time() - t0)
    ex["parity_alcnt"] = got == want
    parity = parity and got == want
    t_ref_s = time_ref(ref_bgt, d, s_args, 1)
    ex["alcnt_ref_s"] = round(t_ref_s, 3)
    ex["alcnt_ours_s"] = round(t_ours_s, 3)
    log(f"[{name}] -S/-H carrier query (40 alleles): ours {t_ours_s:.2f}s vs "
        f"ref {t_ref_s:.2f}s ({t_ref_s / max(t_ours_s, 1e-9):.1f}x), "
        f"parity {ex['parity_alcnt']}")

    # --- sample-subset query: deferred to one shared device subprocess
    # (one JAX process per card: the subprocess runs before this process
    # first uses the device) ---
    subset = d / "subset.txt"
    if not subset.exists():
        names = [l.split("\t")[0] for l in
                 (d / "refdb.spl").read_text().splitlines() if l]
        subset.write_text("\n".join(names[::3]) + "\n")
    sub_args = ["-G", "-C", "-s", str(subset)]
    ex["_subset_want"] = ref_md5(ref_bgt, d, sub_args, "md5-subset.txt")
    ex["subset_ref_s"] = round(time_ref(ref_bgt, d, sub_args, 1), 3)

    # --- annotation-driven query (1kg11 only): the reference's third
    # headline (tex/bgt.tex:214-217, "dominated by the FMF scan") ---
    if name == PRIMARY:
        anno = d / "anno.fmf"
        if not anno.exists():
            keys = subprocess.run([ref_bgt, "getalt", "refdb"], cwd=d,
                                  capture_output=True,
                                  check=True).stdout.decode().splitlines()
            imp = ["HIGH", "LOW", "MODERATE", "MODIFIER"]
            with open(anno, "w") as fp:
                for i, k in enumerate(keys):
                    fp.write(f"{k}\timpact:Z:{imp[i % 4]}\tcsq:i:{i % 23}\n")
                for i in range(5_000_000):  # genome-scale filler rows
                    fp.write(f"99:{i + 1}:1:N\timpact:Z:{imp[(i + 1) % 4]}"
                             f"\tcsq:i:{i % 23}\n")
        anno_args = ["-d", "anno.fmf", "-a", 'impact=="HIGH"&&csq>11', "-G", "-C"]
        want = ref_md5(ref_bgt, d, anno_args, "md5-anno.txt")
        best = float("inf")
        for _ in range(2):  # first run pays page faults on the 245MB FMF
            t0 = time.time()
            got = ours_md5(d, anno_args)
            best = min(best, time.time() - t0)
        ex["anno_ours_s"] = round(best, 2)
        ex["parity_anno"] = got == want
        parity = parity and got == want
        t_ref_anno = time_ref(ref_bgt, d, anno_args, 1)
        ex["anno_ref_s"] = round(t_ref_anno, 2)
        log(f"[{name}] annotation join (5.1M-row FMF scan): ours "
            f"{ex['anno_ours_s']}s vs ref {t_ref_anno:.2f}s "
            f"({t_ref_anno / max(ex['anno_ours_s'], 1e-9):.1f}x), parity "
            f"{ex['parity_anno']}")

    # --- binary BCF dump (view -b): native batched record emission ---
    want = ref_md5(ref_bgt, d, ["-b"], "md5-bcf.txt")
    got = ours_md5(d, ["-b"])
    ex["parity_bcf"] = want == got
    parity = parity and want == got
    t_ref_bcf = time_ref(ref_bgt, d, ["-b"], 1)
    t_bcf, _ = time_ours(d, ["-b"], 2)
    ex["bcf_ref_s"] = round(t_ref_bcf, 2)
    ex["bcf_ours_s"] = round(t_bcf, 2)
    log(f"[{name}] view -b (binary): ours {t_bcf:.2f}s vs ref "
        f"{t_ref_bcf:.2f}s ({t_ref_bcf / t_bcf:.1f}x), parity {ex['parity_bcf']}")

    # --- full genotype dump ---
    t_ref_dump = time_ref(ref_bgt, d, ["-C"], 1)
    t_dump, _ = time_ours(d, ["-C"], 3)  # run 1 faults the memmapped planes
    ex["dump_ref_s"] = round(t_ref_dump, 2)
    ex["dump_ours_s"] = round(t_dump, 2)
    log(f"[{name}] full -C dump: ours {t_dump:.2f}s vs ref {t_ref_dump:.2f}s "
        f"({t_ref_dump / t_dump:.1f}x)")

    if not parity:
        return None
    return (n_sites / t_warm, t_ref / t_warm)


def measure_subsets(extra: dict) -> bool:
    """Run every config's subset query in ONE timeout-guarded subprocess
    (its first measurement includes the process's device start-up)."""
    _assert_card_free()
    jobs = [(name, str(BENCH_DIR / name),
             ["-G", "-C", "-s", str(BENCH_DIR / name / "subset.txt")])
            for name in extra if "_subset_want" in extra[name]]
    if not jobs:
        return True
    script = (
        "import sys, time, json, io, os, hashlib\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from bgt_tpu.query.view import main_view\n"
        "from bgt_tpu.query import fastpath\n"
        "class M(io.TextIOBase):\n"
        "    def __init__(self):\n"
        "        self.h = hashlib.md5()\n"
        "    def write(self, s):\n"
        "        self.h.update(s.encode('latin-1')); return len(s)\n"
        f"for name, d, args in {jobs!r}:\n"
        "    os.chdir(d)\n"
        "    def q():\n"
        "        m = M(); t0 = time.time()\n"
        "        assert main_view(args + ['ourdb'], out=m) == 0\n"
        "        return time.time() - t0, m.h.hexdigest()\n"
        "    t_first, md5 = q()\n"
        "    t_rep, _ = q()\n"
        "    fastpath._COUNT_MEMO.clear()\n"
        "    t_dev, _ = q()\n"
        "    print('SUBSET ' + json.dumps({'name': name, 'md5': md5,"
        " 'first_s': t_first, 'repeat_s': t_rep, 'device_s': t_dev}),"
        " flush=True)\n"
    )
    ok = True
    try:
        out = subprocess.run([sys.executable, "-c", script], timeout=900,
                             capture_output=True, text=True, check=True)
        stdout = out.stdout
    except subprocess.TimeoutExpired as e:
        stdout = (e.stdout or b"").decode() if isinstance(e.stdout, bytes) \
            else (e.stdout or "")
        log(f"subset device subprocess timed out; partial results kept")
        ok = False
    except subprocess.CalledProcessError as e:
        log(f"subset device subprocess failed: {e.stderr[-500:]}")
        return False
    for line in stdout.splitlines():
        if not line.startswith("SUBSET "):
            continue
        res = json.loads(line[7:])
        ex = extra[res["name"]]
        ex["parity_subset"] = res["md5"] == ex.pop("_subset_want")
        ex["subset_first_s"] = round(res["first_s"], 3)
        ex["subset_repeat_s"] = round(res["repeat_s"], 4)
        ex["subset_device_s"] = round(res["device_s"], 4)
        log(f"[{res['name']}] subset -GC: ref {ex['subset_ref_s']}s, ours "
            f"device {ex['subset_device_s']}s, memoized "
            f"{ex['subset_repeat_s']}s (first-in-process {ex['subset_first_s']}s)")
        if not ex["parity_subset"]:
            ok = False
    for ex in extra.values():
        ex.pop("_subset_want", None)
    return ok


HRC_FULL_CFGS = {
    # true-HRC sample width, 1M sites: the on-disk tile (16.8 GB) exceeds
    # any single chip's HBM budget, so subset counts stream row chunks
    "full": dict(n_samples=32488, n_sites=1_000_000, seed=2601),
    # true-HRC site count (39.2M rows, tex/bgt.tex:187-191): proves the
    # site table, vectorized CSI build, and RNI paging at the real scale
    "site39m": dict(n_samples=1, n_sites=39_200_000, seed=2602),
}


def _file_cmp(a: Path, b: Path, chunk: int = 1 << 24) -> bool:
    if a.stat().st_size != b.stat().st_size:
        return False
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x = fa.read(chunk)
            if not x:
                return True
            if x != fb.read(chunk):
                return False


def bench_hrc_full(ref_bgt: str, extra: dict) -> None:
    """True-HRC-scale proof (round-3 verdict #3): 32,488-sample width with
    a > HBM tile, and a 39.2M-row site table.  Database builds (input
    synthesis, both imports, tile build, byte parity) run ONCE and are
    stamped; queries are measured every run."""
    import hashlib
    import io

    from bgt_tpu import testing
    from bgt_tpu.query import importer
    from bgt_tpu.query.view import main_view

    d = BENCH_DIR / "hrc_full"
    d.mkdir(parents=True, exist_ok=True)
    ex = extra.setdefault("hrc_full", {})
    region = "11:10000001-20000000"

    class M(io.TextIOBase):
        def __init__(self):
            self.h = hashlib.md5()
            self.lines = 0

        def write(self, s):
            self.h.update(s.encode("latin-1"))
            self.lines += s.count("\n")
            return len(s)

    for name, cfg in HRC_FULL_CFGS.items():
        sub = ex.setdefault(name, {})
        sub["shape"] = f"{cfg['n_samples']}x{cfg['n_sites']}"
        stamp = d / f"stamp-{name}-{cfg['n_samples']}x{cfg['n_sites']}-{cfg['seed']}"
        our = d / f"{name}_ourdb"
        if stamp.exists():
            sub.update(json.loads(stamp.read_text()))
        else:
            meta = {}
            inp = d / f"{name}_in.bcf"
            if not inp.exists():
                log(f"[hrc_full:{name}] generating input BCF "
                    f"({cfg['n_samples']} x {cfg['n_sites']})...")
                t0 = time.time()
                testing.synth_gt_bcf_to_file(
                    str(inp) + ".tmp", n_samples=cfg["n_samples"],
                    n_sites=cfg["n_sites"], seed=cfg["seed"])
                os.replace(str(inp) + ".tmp", inp)
                meta["gen_s"] = round(time.time() - t0, 1)
                log(f"[hrc_full:{name}] generated in {meta['gen_s']}s "
                    f"({inp.stat().st_size / 1e9:.2f} GB)")
            log(f"[hrc_full:{name}] importing (ours)...")
            t0 = time.time()
            n = importer.import_vcf(str(our), [str(inp)])
            dt = time.time() - t0
            meta["n_rows"] = n
            meta["import_ours_s"] = round(dt, 1)
            meta["import_gt_per_s_m"] = round(
                n * 2 * cfg["n_samples"] / dt / 1e6, 1)
            log(f"[hrc_full:{name}] our import: {n} rows in {dt:.0f}s "
                f"({meta['import_gt_per_s_m']}M gt/s)")
            log(f"[hrc_full:{name}] building device tile (GTC)...")
            t0 = time.time()
            from bgt_tpu.ops.tiles import TileStore
            ts = TileStore.open_or_build(str(our))
            meta["gtc_build_s"] = round(time.time() - t0, 1)
            meta["gtc_bytes"] = int(ts.plane0.nbytes * 2)
            del ts
            log(f"[hrc_full:{name}] importing (reference)...")
            t0 = time.time()
            subprocess.run([ref_bgt, "import", f"{name}_refdb",
                            f"{name}_in.bcf"], cwd=d, check=True,
                           capture_output=True)
            meta["import_ref_s"] = round(time.time() - t0, 1)
            same = all(_file_cmp(Path(str(our) + e),
                                 d / f"{name}_refdb{e}")
                       for e in (".pbf", ".bcf"))
            meta["parity_import"] = same
            log(f"[hrc_full:{name}] ref import {meta['import_ref_s']}s, "
                f"byte parity {same}")
            stamp.write_text(json.dumps(meta))
            sub.update(meta)

        # ---- per-run query measurements ----
        args = (["-G", "-C", "-r", region] if name == "full"
                else ["-G", "-r", region])
        old = os.getcwd()
        os.chdir(d)
        try:
            m = M()
            t0 = time.time()
            assert main_view(args + [f"{name}_ourdb"], out=m) == 0
            sub["q_region_first_s"] = round(time.time() - t0, 2)
            md5, n_lines = m.h.hexdigest(), m.lines
            best = float("inf")
            for _ in range(3):
                m = M()
                t0 = time.time()
                assert main_view(args + [f"{name}_ourdb"], out=m) == 0
                best = min(best, time.time() - t0)
            sub["q_region_warm_s"] = round(best, 3)
            sub["q_region_sites"] = n_lines
            if name == "full":
                sub["q_region_gt_per_s_m"] = round(
                    n_lines * 2 * cfg["n_samples"] / best / 1e6, 1)
            # reference md5 + timing on the same region (md5 cached)
            cache = d / f"md5-{name}-region.txt"
            if cache.exists():
                want = cache.read_text().strip()
            else:
                h = hashlib.md5()
                with subprocess.Popen(
                        [ref_bgt, "view"] + args + [f"{name}_refdb"],
                        cwd=d, stdout=subprocess.PIPE) as p:
                    for blk in iter(lambda: p.stdout.read(1 << 20), b""):
                        h.update(blk)
                want = h.hexdigest()
                cache.write_text(want + "\n")
            sub["parity_region"] = want == md5
            t0 = time.time()
            subprocess.run([ref_bgt, "view"] + args + [f"{name}_refdb"],
                           cwd=d, check=True, stdout=subprocess.DEVNULL)
            sub["q_region_ref_s"] = round(time.time() - t0, 2)
            log(f"[hrc_full:{name}] region query: ours "
                f"{sub['q_region_warm_s']}s vs ref {sub['q_region_ref_s']}s"
                f" ({n_lines} sites, parity {sub['parity_region']})")
            if name == "site39m":
                # RNI paging deep into the 39.2M-record stream
                m = M()
                t0 = time.time()
                assert main_view(["-G", "-i", "30000000", "-n", "100",
                                  f"{name}_ourdb"], out=m) == 0
                sub["q_paging_s"] = round(time.time() - t0, 3)
            if name == "full":
                # subset counts with the > HBM tile: the device tier has
                # to stream row chunks (fastpath.stream_counts)
                spl = d / "full_subset.txt"
                if not spl.exists():
                    spl.write_text("".join(
                        f"S{i:05d}\n"
                        for i in range(0, cfg["n_samples"], 8)))
                sargs = ["-G", "-C", "-s", str(spl), "-r", region]
                m = M()
                t0 = time.time()
                assert main_view(sargs + [f"{name}_ourdb"], out=m) == 0
                sub["q_subset_first_s"] = round(time.time() - t0, 2)
                m = M()
                t0 = time.time()
                assert main_view(sargs + [f"{name}_ourdb"], out=m) == 0
                sub["q_subset_warm_s"] = round(time.time() - t0, 3)
                scache = d / "md5-full-subset.txt"
                if scache.exists():
                    swant = scache.read_text().strip()
                else:
                    h = hashlib.md5()
                    with subprocess.Popen(
                            [ref_bgt, "view"] + sargs + ["full_refdb"],
                            cwd=d, stdout=subprocess.PIPE) as p:
                        for blk in iter(lambda: p.stdout.read(1 << 20),
                                        b""):
                            h.update(blk)
                    swant = h.hexdigest()
                    scache.write_text(swant + "\n")
                sub["parity_subset"] = swant == m.h.hexdigest()
                t0 = time.time()
                subprocess.run([ref_bgt, "view"] + sargs + ["full_refdb"],
                               cwd=d, check=True, stdout=subprocess.DEVNULL)
                sub["q_subset_ref_s"] = round(time.time() - t0, 2)
                log(f"[hrc_full:full] subset (4061 samples): ours "
                    f"{sub['q_subset_warm_s']}s vs ref "
                    f"{sub['q_subset_ref_s']}s, parity "
                    f"{sub['parity_subset']}")
        finally:
            os.chdir(old)


# Published HBM peak by JAX device_kind, GB/s, for roofline shares
# (NVIDIA H100 SXM data sheet: 80 GB HBM3 at 3.35 TB/s).  Shared with
# tools/probe_roofline.py.
HBM_PEAK_GBS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
}


def hbm_peak_gbs(device_kind: str) -> float:
    """Peak HBM rate of a device kind; a kind not in the table is an
    error, never a default."""
    try:
        return HBM_PEAK_GBS[device_kind]
    except KeyError:
        raise KeyError(f"no HBM peak recorded for device kind "
                       f"{device_kind!r}") from None


def _assert_card_free() -> None:
    """A JAX process reserves most of a card's memory when its backend
    starts, so a device child must start before this process has one."""
    xb = sys.modules.get("jax._src.xla_bridge")
    assert xb is None or not xb.backends_are_initialized(), (
        "bench.py already holds the device; a device child would fail")


def bench_multidb(ref_bgt: str, extra: dict) -> None:
    """Multi-database (bgtm) merge queries at bench scale: the 1kg cohort
    split into two half-sample databases and queried jointly — the
    reference's own scaling axis (bgt.c:797-878; the paper's merge-speed
    claim, tex/bgt.tex:233-235).  Builds are stamped; queries + parity run
    every time."""
    import hashlib

    from bgt_tpu.query import importer
    from bgt_tpu.query.view import main_view

    src = BENCH_DIR / PRIMARY / "in.vcf"
    if not src.exists():
        return
    d = BENCH_DIR / "multidb"
    d.mkdir(parents=True, exist_ok=True)
    ex = extra.setdefault("multidb", {})
    stamp = d / "stamp-split-1kg"
    if stamp.exists():
        ex.update(json.loads(stamp.read_text()))
    else:
        import numpy as np
        meta = {}
        log("[multidb] splitting the 1kg cohort into two sample halves...")
        t0 = time.time()
        n_first = CONFIGS[PRIMARY]["n_samples"] // 2
        cut_col = 9 + n_first  # fixed VCF cols + first half's samples
        with open(src, "rb") as fin, \
                open(d / "a.vcf", "wb") as fa, open(d / "b.vcf", "wb") as fb:
            for line in fin:
                if line.startswith(b"##"):
                    fa.write(line)
                    fb.write(line)
                    continue
                tabs = np.nonzero(
                    np.frombuffer(line, np.uint8) == 9)[0]
                head_end = int(tabs[8])
                cut = int(tabs[cut_col - 1])
                fa.write(line[:cut])
                fa.write(b"\n")
                fb.write(line[:head_end])
                fb.write(line[cut:])
        meta["split_s"] = round(time.time() - t0, 1)
        for half in ("a", "b"):
            t0 = time.time()
            importer.import_vcf(str(d / f"our_{half}"),
                                [str(d / f"{half}.vcf")], is_vcf=True)
            meta[f"import_ours_{half}_s"] = round(time.time() - t0, 1)
            t0 = time.time()
            subprocess.run([ref_bgt, "import", "-S", f"ref_{half}",
                            f"{half}.vcf"], cwd=d, check=True,
                           capture_output=True)
            meta[f"import_ref_{half}_s"] = round(time.time() - t0, 1)
            same = all(_file_cmp(d / f"our_{half}{e}", d / f"ref_{half}{e}")
                       for e in (".bcf", ".pbf", ".bcf.csi"))
            meta[f"parity_import_{half}"] = same
        stamp.write_text(json.dumps(meta))
        ex.update(meta)

    class M(io.TextIOBase):
        def __init__(self):
            self.h = hashlib.md5()

        def write(self, s):
            self.h.update(s.encode("latin-1"))
            return len(s)

    region = "11:10000000-60000000"
    queries = {
        "merge_gc": ["-G", "-C"],
        "merge_region_flt": ["-G", "-C", "-r", region, "-f", "AC>10"],
    }
    old = os.getcwd()
    os.chdir(d)
    try:
        for qname, args in queries.items():
            m = M()
            t0 = time.time()
            assert main_view(args + ["our_a", "our_b"], out=m) == 0
            first = time.time() - t0
            m = M()
            t0 = time.time()
            assert main_view(args + ["our_a", "our_b"], out=m) == 0
            ex[f"q_{qname}_first_s"] = round(first, 3)
            ex[f"q_{qname}_warm_s"] = round(time.time() - t0, 3)
            h = hashlib.md5()
            t0 = time.time()
            with subprocess.Popen(
                    [ref_bgt, "view"] + args + ["ref_a", "ref_b"],
                    stdout=subprocess.PIPE) as p:
                for blk in iter(lambda: p.stdout.read(1 << 20), b""):
                    h.update(blk)
            ex[f"q_{qname}_ref_s"] = round(time.time() - t0, 3)
            ex[f"parity_{qname}"] = h.hexdigest() == m.h.hexdigest()
            log(f"[multidb] {qname}: ours {ex[f'q_{qname}_warm_s']}s vs "
                f"ref {ex[f'q_{qname}_ref_s']}s, parity "
                f"{ex[f'parity_{qname}']}")
    finally:
        os.chdir(old)


def measure_device_kernel(extra: dict) -> None:
    """Measured device bandwidth of the count kernel at the bench shape.

    Two measurements per configuration:

    - device-side: K vs 2K iterations inside one jitted ``fori_loop``
      (mask perturbed per iteration so XLA cannot hoist the body); the
      difference isolates per-iteration device time with zero dispatch
      cost.  This is the number compared against the HBM roofline.
    - round-trip: one dispatch + readback through np.asarray — what a
      cold un-memoized query pays.

    Also records an HBM proxy (popcount+reduce over one plane, same loop
    method), the nominal chip peak, and roofline fractions.
    """
    import functools

    import numpy as np
    try:
        import jax
        import jax.numpy as jnp

        from bgt_tpu.ops import counts as counts_ops
        from bgt_tpu.ops.tiles import TileStore
        dev = jax.devices()[0]
        ex = extra.setdefault("device_kernel", {})
        ex["backend"] = dev.platform
        ex["device_kind"] = dev.device_kind
        peak = hbm_peak_gbs(dev.device_kind)
        ex["hbm_peak_gbs"] = peak
        ts = TileStore.open_or_build(str(BENCH_DIR / "hrc" / "ourdb"))
        p0 = jax.device_put(np.asarray(ts.plane0), dev)
        p1 = jax.device_put(np.asarray(ts.plane1), dev)
        p0.block_until_ready()
        rng = np.random.default_rng(0)
        plane_bytes = ts.plane0.nbytes * 2
        K = 20

        def loop_iter_s(body_fn, *args):
            """Per-iteration device seconds via the K/2K fori_loop delta."""
            def loop(k, *a):
                def body(i, acc):
                    return acc + body_fn(i, *a)
                return jax.lax.fori_loop(0, k, body, jnp.int32(0))
            lo = jax.jit(functools.partial(loop, K))
            hi = jax.jit(functools.partial(loop, 2 * K))
            jax.block_until_ready(lo(*args))
            jax.block_until_ready(hi(*args))
            bl = bh = float("inf")
            for _ in range(3):
                t0 = time.time()
                jax.block_until_ready(lo(*args))
                bl = min(bl, time.time() - t0)
                t0 = time.time()
                jax.block_until_ready(hi(*args))
                bh = min(bh, time.time() - t0)
            return max(bh - bl, 1e-9) / K

        # HBM proxy: popcount+reduce over one plane
        def proxy_body(i, a):
            return jax.lax.population_count(a ^ i.astype(jnp.uint32)) \
                .view(jnp.int32).sum(dtype=jnp.int32)
        t = loop_iter_s(proxy_body, p0)
        ex["hbm_proxy_gbs"] = round(ts.plane0.nbytes / t / 1e9, 1)

        for label, masks in (
                ("1mask", ts.all_mask()[None, :]),
                ("32mask", rng.integers(0, 2**32, (32, ts.plane0.shape[1]),
                                        dtype=np.uint32))):
            dm = jax.device_put(masks, dev)
            np.asarray(counts_ops.count_codes(p0, p1, dm))  # compile warm
            # round-trip: dispatch + device compute + readback
            best = float("inf")
            for _ in range(5):
                t0 = time.time()
                np.asarray(counts_ops.count_codes(p0, p1, dm))
                best = min(best, time.time() - t0)
            ex[f"s_per_call_{label}"] = round(best, 5)
            ex[f"count_bw_gbs_{label}"] = round(plane_bytes / best / 1e9, 1)

            def count_body(i, a, b, m):
                return counts_ops.count_codes(a, b, m ^ i.astype(jnp.uint32)) \
                    .sum(dtype=jnp.int32)
            per = loop_iter_s(count_body, p0, p1, dm)
            ex[f"s_per_call_{label}_device"] = round(per, 6)
            ex[f"count_bw_gbs_{label}_device"] = round(
                plane_bytes / per / 1e9, 1)
            ex[f"roofline_frac_{label}"] = round(
                plane_bytes / per / 1e9 / peak, 3)
        ex["rows"] = ts.n_rows
        ex["sites_per_s_1mask"] = round(ts.n_rows / ex["s_per_call_1mask"])
        # un-memoized device subset rate: genotype-count throughput of the
        # device-side kernel (a cold subset query additionally pays one
        # round trip, s_per_call_1mask)
        ex["gt_per_s_device_m"] = round(
            ts.n_rows * ts.m / ex["s_per_call_1mask_device"] / 1e6, 1)
        log(f"device kernel [{dev.platform} {dev.device_kind}]: "
            f"{ex['count_bw_gbs_1mask_device']} GB/s device-side "
            f"(roofline {ex.get('roofline_frac_1mask')}, proxy "
            f"{ex['hbm_proxy_gbs']} GB/s, peak {peak}; "
            f"{ex['count_bw_gbs_1mask']} GB/s round-trip, 1 mask), "
            f"{ex['count_bw_gbs_32mask_device']} GB/s (32 masks), "
            f"{ex['gt_per_s_device_m']}M gt/s un-memoized")
    except Exception as e:  # noqa: BLE001 - must not kill the bench
        extra["device_kernel"] = {"error": str(e)[:200]}


def run_device_tests(extra: dict) -> None:
    """The gpu-marked parity suite (tests/test_device_gpu.py) on the
    card, in a child started before this process uses the device."""
    _assert_card_free()
    env = dict(os.environ, BGT_TPU_REQUIRE_GPU="1")
    t0 = time.time()
    try:
        res = subprocess.run(
            [sys.executable, "-m", "pytest", "-x", "-q", "-m", "gpu",
             str(REPO / "tests" / "test_device_gpu.py")],
            env=env, capture_output=True, text=True, timeout=900)
        passed = res.returncode == 0
        tail = (res.stdout or "").strip().splitlines()[-1:] or [""]
        extra["device_tests"] = {"passed": passed,
                                 "seconds": round(time.time() - t0, 1),
                                 "summary": tail[0][:160]}
        log(f"device tests: {'PASS' if passed else 'FAIL'} ({tail[0][:80]})")
    except subprocess.TimeoutExpired:
        extra["device_tests"] = {"passed": False, "summary": "timeout"}
        log("device tests: TIMEOUT")


def main():
    ref_bgt = ensure_ref()
    extra: dict = {}
    primary = bench_config(ref_bgt, PRIMARY, extra)
    try:
        bench_config(ref_bgt, "hrc", extra)
    except Exception as e:  # noqa: BLE001 - secondary config must not kill the bench
        log(f"hrc config failed: {e}")
        extra["hrc"] = {"error": str(e)}
    if not measure_subsets(extra):
        if primary is not None and not extra[PRIMARY].get("parity_subset", True):
            primary = None
    run_device_tests(extra)
    measure_device_kernel(extra)
    # true-HRC-scale block (one-time stamped builds + per-run queries)
    if os.environ.get("BGT_TPU_BENCH_FULL", "1") != "0":
        try:
            bench_hrc_full(ref_bgt, extra)
        except Exception as e:  # noqa: BLE001 - must not kill the bench
            log(f"hrc_full failed: {e}")
            extra.setdefault("hrc_full", {})["error"] = str(e)[:300]
    try:
        bench_multidb(ref_bgt, extra)
    except Exception as e:  # noqa: BLE001 - must not kill the bench
        log(f"multidb failed: {e}")
        extra.setdefault("multidb", {})["error"] = str(e)[:300]
    # scaling methodology block (tools/bench_scaling.py; BASELINE.md:29)
    try:
        out = subprocess.run([sys.executable,
                              str(REPO / "tools" / "bench_scaling.py")],
                             capture_output=True, text=True, timeout=1200)
        for line in out.stdout.splitlines():
            if line.startswith("{"):
                extra["scaling"] = json.loads(line)["scaling"]
                eff = extra["scaling"].get("processes", {}).get("2", {})
                log(f"scaling: 2-process efficiency "
                    f"{eff.get('efficiency', 'n/a')} (software-overhead "
                    f"measure on virtual CPU devices)")
                break
    except Exception as e:  # noqa: BLE001 - methodology block is best-effort
        extra["scaling"] = {"error": str(e)[:200]}
    value, vs = (0.0, 0.0) if primary is None else primary
    print(json.dumps({
        "metric": "sites/s, warm view -GC (2504 samples x 105730 sites)",
        "value": round(value, 1),
        "unit": "sites/s",
        "vs_baseline": round(vs, 3),
        "extra": extra,
    }))


if __name__ == "__main__":
    main()
