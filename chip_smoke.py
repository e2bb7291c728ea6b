#!/usr/bin/env python
"""Run the single-database query path once on a CUDA GPU and check it.

    python chip_smoke.py                # one card, phases 1-6 below
    python chip_smoke.py --four-cards   # the sample-column meshes on 4 cards

Phases (one card): (1) a fresh build of the native host library on this
machine (it is compiled with -march=native, so a copied one is never
reused), then the ``gpu``-marked tests in a child process, before this
process touches the card; (2) environment: JAX version, devices, the
card's name and power limit; (3) data: a seeded 32,488-sample (HRC r1 width) x 150,000-site cohort,
imported with ``bgt import`` and given a population FMF; (4) kernels: the
count kernel over the whole device-resident tile at 1, 2 and 32 masks
against a numpy popcount oracle, and the decode / GT-pair kernels on a row
sample; (5) server: six queries to ``bgt server`` (in this process, on a
thread) with the device count tier forced, each byte-compared with the
per-site reader loop on a ~10k-site region, plus one whole-database subset
query checked against the oracle; (6) the same subset queries through the
streamed tier, with the device budget set below the tile size.

150,000 sites is the size of the paper's 10 Mbp HRC region query; a tile
that fills the card is the benchmark's job.  The four-card run cuts the
cohort to 20,000 sites: it compares meshes with one device, and the mesh
choice depends on the width alone.

The last line of stdout is one JSON object, printed only when every phase
passed.  Without a GPU the script exits non-zero; it has no CPU mode.  The
phases are functions, so tests run them on the CPU at a tiny size.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.parse
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402

from bgt_tpu import native, testing  # noqa: E402

HRC_SAMPLES = 32_488
N_SITES = 150_000
FOUR_CARD_SITES = 20_000
REF_SITES = 10_000
SEED = 2026
CHROM = "11"
POPULATIONS = ("AFR", "AMR", "EAS", "EUR", "SAS")
WORK = REPO / "build" / "smoke"


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def _run(cmd, timeout: float, **kw) -> subprocess.CompletedProcess:
    res = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=timeout, **kw)
    check(res.returncode == 0,
          f"{' '.join(map(str, cmd))} exited {res.returncode}:\n"
          f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    return res


# --- phase 1 -----------------------------------------------------------------

def build_native() -> None:
    """Build libbgt_host.so here (-march=native: never reuse a copied one)."""
    t0 = time.time()
    native._SO.unlink(missing_ok=True)
    _run(["sh", str(REPO / "tools" / "build_native.sh")], timeout=600)
    check(native.get_lib() is not None, "native host library did not load")
    log(f"native library built in {time.time() - t0:.1f} s")


def run_gpu_tests() -> None:
    """The gpu-marked tests in a child (skips there count as failures)."""
    t0 = time.time()
    res = _run([sys.executable, "-m", "pytest", "-q", "-m", "gpu",
                "-p", "no:cacheprovider", str(REPO / "tests")],
               timeout=900, cwd=REPO,
               env=dict(os.environ, BGT_TPU_REQUIRE_GPU="1"))
    log(f"gpu-marked tests: {res.stdout.strip().splitlines()[-1]} "
        f"({time.time() - t0:.1f} s)")


# --- phase 2 -----------------------------------------------------------------

def card_lines() -> list[str]:
    res = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], timeout=60)
    return res.stdout.strip().splitlines()


def environment(n_cards: int):
    """Print what runs where; the first JAX device must be a GPU."""
    import jax
    log(f"jax {jax.__version__}, python {sys.version.split()[0]}")
    devs = jax.devices()
    log(f"devices: {devs}")
    for line in card_lines():
        print(line, flush=True)
    check(devs[0].platform == "gpu",
          f"JAX found no GPU: first device is {devs[0].platform}")
    check(len(devs) >= n_cards, f"need {n_cards} GPUs, JAX sees {len(devs)}")
    return devs[0]


# --- phase 3 -----------------------------------------------------------------

def populations(n_samples: int, seed: int) -> np.ndarray:
    """Population index of each synthesised sample (seeded)."""
    rng = np.random.default_rng(seed + 1)
    return rng.integers(0, len(POPULATIONS), n_samples)


def make_database(workdir: Path, n_samples: int, n_sites: int,
                  seed: int) -> str:
    """Seeded cohort BCF -> ``bgt import`` -> population FMF; returns the
    database prefix."""
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    bcf = workdir / "in.bcf"
    t0 = time.time()
    testing.synth_gt_bcf_to_file(str(bcf), n_samples=n_samples,
                                 n_sites=n_sites, seed=seed, chrom=CHROM)
    log(f"synthesised {n_samples} x {n_sites} in {time.time() - t0:.1f} s "
        f"({bcf.stat().st_size / 1e9:.2f} GB BCF)")
    prefix = str(workdir / "db")
    t0 = time.time()
    _run([sys.executable, "-m", "bgt_tpu.cli", "import", prefix, str(bcf)],
         timeout=1800, cwd=REPO)
    log(f"bgt import in {time.time() - t0:.1f} s")
    bcf.unlink()
    pops = populations(n_samples, seed)
    with open(prefix + ".spl", "w") as fp:
        for i, p in enumerate(pops):
            fp.write(f"S{i:05d}\tpopulation:Z:{POPULATIONS[p]}\n")
    return prefix


# --- phase 4 -----------------------------------------------------------------

def numpy_counts(p0, p1, masks: np.ndarray, chunk: int = 4096) -> np.ndarray:
    """(rows, groups, 4) code counts by numpy popcount (row-chunk threads)."""
    n = p0.shape[0]
    out = np.empty((n, masks.shape[0], 4), np.int32)
    tot = np.bitwise_count(masks).sum(axis=1, dtype=np.int32)

    def work(lo: int) -> None:
        a = np.asarray(p0[lo: lo + chunk])
        b = np.asarray(p1[lo: lo + chunk])
        ab = a & b
        for gi, m in enumerate(masks):
            n10 = np.bitwise_count(a & m).sum(axis=1, dtype=np.int32)
            n11 = np.bitwise_count(b & m).sum(axis=1, dtype=np.int32)
            nb = np.bitwise_count(ab & m).sum(axis=1, dtype=np.int32)
            c1 = n10 - nb
            c2 = n11 - nb
            out[lo: lo + chunk, gi] = np.stack(
                [tot[gi] - c1 - c2 - nb, c1, c2, nb], axis=1)

    with ThreadPoolExecutor(os.cpu_count() or 1) as ex:
        list(ex.map(work, range(0, n, chunk)))
    return out


def numpy_codes(p0: np.ndarray, p1: np.ndarray) -> np.ndarray:
    b0 = np.unpackbits(p0.view(np.uint8), axis=1, bitorder="little")
    b1 = np.unpackbits(p1.view(np.uint8), axis=1, bitorder="little")
    return (b1 << 1) | b0


def check_kernels(prefix: str, groups=(1, 2, 32), sample_rows: int = 256,
                  seed: int = SEED) -> None:
    """Count, decode and GT-pair kernels on the resident tile vs numpy."""
    import jax.numpy as jnp

    from bgt_tpu.ops import counts as counts_ops
    from bgt_tpu.query import engine, fastpath

    bf = engine.BgtFile(prefix)
    t0 = time.time()
    ts = fastpath.get_tiles(bf)
    log(f"GTC tile {ts.n_rows} x {ts.plane0.shape[1]} words "
        f"({2 * ts.plane0.nbytes / 1e9:.2f} GB) in {time.time() - t0:.1f} s")
    t0 = time.time()
    dt = fastpath.get_device_tiles(bf)
    check(dt is not None, "the tile did not fit the device budget")
    log(f"planes resident on {dt.p0.devices()} in {time.time() - t0:.1f} s")
    rng = np.random.default_rng(seed)
    words = ts.plane0.shape[1]
    for g in groups:
        masks = rng.integers(0, 2**32, (g, words), dtype=np.uint32)
        dm = jnp.asarray(masks)
        t0 = time.time()
        compiled = counts_ops.count_codes.lower(dt.p0, dt.p1, dm).compile()
        t_compile = time.time() - t0
        t0 = time.time()
        got = np.asarray(compiled(dt.p0, dt.p1, dm))
        t_run = time.time() - t0
        want = numpy_counts(ts.plane0, ts.plane1, masks)
        check(np.array_equal(got, want), f"count_codes differs at g={g}")
        lo = ts.n_rows // 3
        n = min(4096, ts.n_rows - lo)
        got_r = np.asarray(counts_ops.count_codes_range(
            dt.p0, dt.p1, dm, lo, n))
        check(np.array_equal(got_r, want[lo: lo + n]),
              f"count_codes_range differs at g={g}")
        log(f"count_codes g={g}: exact over {ts.n_rows} rows; compile "
            f"{t_compile:.2f} s, first call {t_run:.3f} s; "
            f"{compiled.memory_analysis()}")

    n = min(sample_rows, ts.n_rows)
    lo = int(rng.integers(0, ts.n_rows - n + 1))
    codes = numpy_codes(np.asarray(ts.plane0[lo: lo + n]),
                        np.asarray(ts.plane1[lo: lo + n]))
    got = np.asarray(counts_ops.decode_codes(dt.p0[lo: lo + n],
                                             dt.p1[lo: lo + n]))
    check(np.array_equal(got, codes), "decode_codes differs")
    samples = np.sort(rng.choice(ts.m // 2, size=min(512, ts.m // 2),
                                 replace=False))
    cols = np.stack([2 * samples, 2 * samples + 1], axis=1).reshape(-1)
    got = np.asarray(counts_ops.gt_pair_idx_range(
        dt.p0, dt.p1, jnp.asarray(cols.astype(np.int32)), lo, n))
    sub = codes[:, cols]
    check(np.array_equal(got, (sub[:, 0::2] << 2) | sub[:, 1::2]),
          "gt_pair_idx_range differs")
    got = np.asarray(counts_ops.gather_codes_range(
        dt.p0, dt.p1, jnp.asarray(cols.astype(np.int32)), lo, n, cols.size))
    check(np.array_equal(got, sub), "gather_codes_range differs")
    log(f"decode / GT-pair / gather kernels exact on rows [{lo}, {lo + n})")


# --- phases 5 and 6 ----------------------------------------------------------

@contextlib.contextmanager
def serving(prefix: str):
    """``bgt server`` on the database, on a thread of this process."""
    from bgt_tpu.query.engine import BgtFile
    from bgt_tpu.server import server as srv

    cfg = srv.ServerConfig()
    cfg.port = 0
    cfg.files = [BgtFile(prefix)]
    cfg.prefixes = [os.path.basename(prefix)]
    httpd = srv.make_server(cfg)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield cfg, httpd.server_address[1]
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join()


def fetch(port: int, pairs) -> bytes:
    url = f"http://127.0.0.1:{port}/?{urllib.parse.urlencode(pairs)}"
    with urllib.request.urlopen(url, timeout=900) as resp:
        check(resp.status == 200, f"{pairs}: HTTP {resp.status}")
        return resp.read()


def reference_body(files, pairs, max_gt: int = 10_000_000) -> bytes:
    """The response by the per-site reader loop (bgt-server.go:330-352 and
    view.c:148-156): it decodes the PBF row by row and never touches the
    tile store or the device."""
    from bgt_tpu.formats import bcf as bcflib
    from bgt_tpu.query.engine import (F_CNT_AL, F_CNT_HAP, F_NO_GT,
                                      F_SET_AC, BgtmReader)
    from bgt_tpu.query.view import format_gt_fast

    form: dict[str, list[str]] = {}
    for k, v in pairs:
        form.setdefault(k, []).append(v)
    flag = F_NO_GT
    if "g" in form:
        flag &= ~F_NO_GT
    if "C" in form or "s" in form:
        flag |= F_SET_AC
    if "S" in form:
        flag |= F_CNT_AL
    if "H" in form:
        flag |= F_CNT_HAP
    vcf_out = not flag & (F_CNT_AL | F_CNT_HAP) and "t" not in form
    bm = BgtmReader(files)
    bm.set_flag(flag)
    if "f" in form:
        check(bm.set_flt_site(form["f"][0]) == 0, "reference: bad filter")
    if "r" in form:
        check(bm.set_region(form["r"][0]) >= 0, "reference: bad region")
    if "t" in form:
        check(bm.set_table(form["t"][0]) >= 0, "reference: bad table")
    if "a" in form:
        check(bm.set_alleles(form["a"][0], None, None) > 0,
              "reference: no alleles")
    for s in form.get("s", []):
        check(bm.add_group(s) >= 0, f"reference: bad group {s}")
    bm.prepare()
    out = [bm.h_out.text + "\n"] if vcf_out else []
    b = bcflib.Bcf1()
    while bm.n_gt_read <= max_gt and bm.read(b) >= 0:
        if not vcf_out:
            if bm.fields:
                out.append(bm.tbl_line + "\n")
        elif flag & F_NO_GT or b.n_sample == 0:
            out.append(bcflib.vcf_format1(bm.h_out, b) + "\n")
        else:
            ns = b.n_sample
            b.n_sample = 0
            head = bcflib.vcf_format1(bm.h_out, b)
            b.n_sample = ns
            keep = bm.mgs <= 1 if (bm.mgs > 1).any() else None
            cells = format_gt_fast(bm.a[0], bm.a[1], keep)
            out.append(head + "\tGT" + cells.decode("latin-1") + "\n")
    if not vcf_out and len(bm.aal) > 0:
        if flag & F_CNT_HAP:
            out.append(bm.hapcnt_print())
        if flag & F_CNT_AL:
            out.append(bm.alcnt_print())
    if bm.n_gt_read > max_gt:
        out.append("*\n")
    bm.close()
    return "".join(out).encode("latin-1")


def region_queries(prefix: str, n_ref_sites: int) -> dict[str, list]:
    """The six checked queries, on a region of ~n_ref_sites sites."""
    from bgt_tpu.query import engine, fastpath

    bf = engine.BgtFile(prefix)
    st = fastpath.get_site_table(bf)
    lo = st.n // 4
    hi = min(st.n, lo + n_ref_sites) - 1
    region = f"{CHROM}:{int(st.pos[lo]) + 1}-{int(st.pos[hi]) + 1}"
    # -S lists samples carrying every allele: take the region's two most
    # common alt alleles so that some do
    ac = fastpath.get_tiles(bf).rowstats[lo: hi + 1, 1]
    picks = lo + np.sort(np.argsort(ac, kind="stable")[-2:])
    alleles = ",".join(f"{CHROM}:{int(st.pos[r]) + 1}:{len(st.ref_s(r))}:"
                       f"{st.alt_s(r)}" for r in picks)
    a, b, c = (f'(population=="{p}")' for p in POPULATIONS[:3])
    r = ("r", region)
    return {
        "all_samples_C": [("C", "1"), r],
        "subset": [("s", a), r],
        "two_groups_filter": [("s", b), ("s", c),
                              ("f", "(AC1/AN1>=0.1&&AC2==0)"), r],
        "table": [("t", "CHROM,POS,AC,AN"), r],
        "gt_quota": [("g", "1"), r],
        "carriers": [("a", "," + alleles), ("S", "1"), r],
    }


@contextlib.contextmanager
def count_passes():
    """Count device count passes: resident-tile kernels and streamed
    chunks (the server runs in this process, so wrapping sees them)."""
    from bgt_tpu.ops import counts as counts_ops
    from bgt_tpu.query import fastpath

    seen = {"resident": 0, "streamed": 0}
    orig_range, orig_stream = counts_ops.count_codes_range, fastpath.stream_counts

    def count_range(*a, **k):
        seen["resident"] += 1
        return orig_range(*a, **k)

    def stream(*a, **k):
        seen["streamed"] += 1
        return orig_stream(*a, **k)

    counts_ops.count_codes_range, fastpath.stream_counts = count_range, stream
    try:
        yield seen
    finally:
        counts_ops.count_codes_range = orig_range
        fastpath.stream_counts = orig_stream


@contextlib.contextmanager
def env_set(**env):
    old = {k: os.environ.get(k) for k in env}
    os.environ.update({k: str(v) for k, v in env.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def whole_db_subset(port: int, cfg, prefix: str, seed: int) -> None:
    """A whole-database subset table query against the numpy oracle (with
    the server's genotype quota lifted, as ``bgt server -m`` does)."""
    from bgt_tpu.query import engine, fastpath

    ts = fastpath.get_tiles(engine.BgtFile(prefix))
    pop = POPULATIONS[3]
    samples = np.nonzero(populations(ts.m // 2, seed) == 3)[0]
    cols = np.stack([2 * samples, 2 * samples + 1], axis=1).reshape(-1)
    want = numpy_counts(ts.plane0, ts.plane1, ts.pack_mask(cols)[None, :])
    quota, cfg.max_gt = cfg.max_gt, ts.n_rows * ts.m
    try:
        body = fetch(port, [("s", f'(population=="{pop}")'),
                            ("t", "CHROM,POS,AC,AN")]).decode()
    finally:
        cfg.max_gt = quota
    table = np.array([line.split("\t")[2:4] for line in body.splitlines()],
                     dtype=np.int64)
    check(table.shape == (ts.n_rows, 2),
          f"whole-database table has {table.shape[0]} of {ts.n_rows} rows")
    c = want[:, 0]
    check(np.array_equal(table[:, 0], c[:, 1]), "whole-database AC differs")
    check(np.array_equal(table[:, 1], c[:, 0] + c[:, 1] + c[:, 3]),
          "whole-database AN differs")


def check_server(prefix: str, n_ref_sites: int = REF_SITES,
                 seed: int = SEED) -> dict[str, tuple[list, bytes]]:
    """Six region queries byte-equal to the per-site loop, one whole-
    database subset equal to the oracle, subsets counted on the device.
    Returns each query with its checked answer."""
    from bgt_tpu.query import fastpath

    queries = region_queries(prefix, n_ref_sites)
    fastpath._COUNT_MEMO.clear()
    answers = {}
    with env_set(BGT_TPU_COUNT_TIER="device"), serving(prefix) as (cfg, port), \
            count_passes() as seen:
        for name, pairs in queries.items():
            t0 = time.time()
            got = fetch(port, pairs)
            t_srv = time.time() - t0
            t0 = time.time()
            want = reference_body(cfg.files, pairs)
            t_ref = time.time() - t0
            check(got == want, f"server response {name} differs from the "
                  f"per-site reference ({len(got)} vs {len(want)} bytes)")
            answers[name] = (pairs, got)
            log(f"server {name}: {len(got)} bytes identical "
                f"(server {t_srv:.2f} s, per-site reference {t_ref:.2f} s)")
        check(seen["resident"] >= 2,
              f"subset queries ran {seen['resident']} device count passes")
        check(any(v is not None for v in fastpath._DEVICE_CACHE.values()),
              "the planes are not device-resident")
        whole_db_subset(port, cfg, prefix, seed)
        log(f"whole-database subset matches the oracle; "
            f"{seen['resident']} resident device count passes")
    return answers


def check_streamed(prefix: str, answers: dict[str, tuple[list, bytes]],
                   seed: int = SEED) -> None:
    """The subset queries again with a device budget below the tile."""
    from bgt_tpu.query import engine, fastpath

    ts = fastpath.get_tiles(engine.BgtFile(prefix))
    with fastpath._CACHE_LOCK:
        fastpath._DEVICE_CACHE.clear()
        fastpath._COUNT_MEMO.clear()
    with env_set(BGT_TPU_COUNT_TIER="device",
                 BGT_TPU_HBM_BUDGET=ts.plane0.nbytes), \
            serving(prefix) as (cfg, port), count_passes() as seen:
        for name in ("subset", "two_groups_filter"):
            pairs, want = answers[name]
            check(fetch(port, pairs) == want, f"streamed {name} differs")
        whole_db_subset(port, cfg, prefix, seed)
        check(seen["streamed"] >= 3 and seen["resident"] == 0,
              f"streamed tier not used: {seen}")
        check(all(v is None for v in fastpath._DEVICE_CACHE.values()),
              "the tile became resident despite the budget")
    log(f"streamed tier: {seen['streamed']} passes, answers identical")


# --- four cards --------------------------------------------------------------

def check_four_cards(prefix: str, n_ref_sites: int = REF_SITES) -> None:
    """Subset and two-group queries through the sample-column meshes,
    byte-equal to one device, then the multichip dry run."""
    import jax

    import __graft_entry__
    from bgt_tpu.query import fastpath

    queries = region_queries(prefix, n_ref_sites)
    names = ("subset", "two_groups_filter")

    def answers(**env):
        fastpath.reset_shard_context()
        with fastpath._CACHE_LOCK:
            fastpath._DEVICE_CACHE.clear()
            fastpath._COUNT_MEMO.clear()
        with env_set(BGT_TPU_COUNT_TIER="device", **env), \
                serving(prefix) as (_cfg, port):
            out = {n: fetch(port, queries[n]) for n in names}
            sc = fastpath.get_shard_context()
            kinds = sorted({e.kind for e in sc._planes.values()}) if sc else []
        return out, kinds

    one, kinds = answers(BGT_TPU_SHARD="0")
    check(kinds == [], f"one-device run used a mesh: {kinds}")
    for label, env, kind in (("1-axis sample-column", {}, "s"),
                             ("2-axis 2x2", {"BGT_TPU_MESH2": "2x2"}, "rs")):
        got, kinds = answers(BGT_TPU_SHARD_MIN_ROWS="0", **env)
        check(kinds == [kind], f"{label}: executors {kinds}, want {kind}")
        for n in names:
            check(got[n] == one[n], f"{label} mesh: {n} differs")
        log(f"{label} mesh on {len(jax.devices())} cards: "
            f"{', '.join(names)} identical to one device")
    fastpath.reset_shard_context()
    __graft_entry__.dryrun_multichip(4)
    log("dryrun_multichip(4) OK")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card mesh path and its "
                    "one-device comparison")
    args = ap.parse_args(argv)
    if shutil.which("nvidia-smi") is None:
        print("chip_smoke: no NVIDIA GPU here (nvidia-smi not found)",
              file=sys.stderr)
        return 1
    n_cards = 4 if args.four_cards else 1
    sites = FOUR_CARD_SITES if args.four_cards else N_SITES
    t_start = time.time()
    build_native()
    if not args.four_cards:
        run_gpu_tests()
    dev = environment(n_cards)
    prefix = make_database(WORK, HRC_SAMPLES, sites, SEED)
    if args.four_cards:
        check_four_cards(prefix)
    else:
        check_kernels(prefix)
        answers = check_server(prefix)
        check_streamed(prefix, answers)
    import jax
    log(f"all phases passed in {time.time() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
