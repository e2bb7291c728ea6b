"""Synthetic VCF generation for parity tests and benchmarks.

The canonical bgt demo data (1kg chr11:1-1M) cannot be downloaded in this
environment, so tests generate random cohort VCFs with the same structural
features (multi-allelics, indels, missing genotypes, phased diploid GT) and
compare our pipeline byte-for-byte against the reference binary built from
/root/reference.
"""

from __future__ import annotations

import numpy as np

BASES = "ACGT"


def random_vcf(
    n_samples: int = 20,
    n_sites: int = 100,
    seed: int = 0,
    chroms=("11",),
    chrom_len: int = 135006516,
    p_multi: float = 0.15,
    p_indel: float = 0.2,
    p_missing: float = 0.03,
    phased: bool = True,
    with_filter: bool = False,
    sample_prefix: str = "S",
) -> str:
    rng = np.random.default_rng(seed)
    samples = [f"{sample_prefix}{i:04d}" for i in range(n_samples)]
    lines = [
        "##fileformat=VCFv4.1",
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
    ]
    if with_filter:
        lines.append('##FILTER=<ID=q10,Description="Quality below 10">')
    for c in chroms:
        lines.append(f"##contig=<ID={c},length={chrom_len}>")
    lines.append("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                 + "\t".join(samples))

    sep = "|" if phased else "/"
    for c in chroms:
        pos = 10000
        for _ in range(n_sites):
            pos += int(rng.integers(1, 2000))
            ref_len = 1
            is_indel = rng.random() < p_indel
            if is_indel:
                ref_len = int(rng.integers(1, 6))
            ref = "".join(BASES[i] for i in rng.integers(0, 4, ref_len))
            n_alt = 1
            if rng.random() < p_multi:
                n_alt = int(rng.integers(2, 4))
            alts = []
            tries = 0
            while len(alts) < n_alt and tries < 20:
                tries += 1
                kind = rng.random()
                if not is_indel and kind < 0.7:  # SNP on first base
                    a = BASES[int(rng.integers(0, 4))]
                    if a != ref[0] and len(ref) == 1 and a not in alts:
                        alts.append(a)
                elif kind < 0.85:  # insertion
                    ins = "".join(BASES[i] for i in rng.integers(0, 4, rng.integers(1, 4)))
                    a = ref[0] + ins + ref[1:]
                    if a != ref and a not in alts:
                        alts.append(a)
                else:  # deletion / complex
                    keep = int(rng.integers(0, max(1, ref_len)))
                    a = ref[0] + ref[ref_len - keep:] if keep else ref[0]
                    if a != ref and a not in alts:
                        alts.append(a)
            if not alts:
                alts = [ref[0] + "T"]
            n_allele = len(alts) + 1
            # vectorized GT cell assembly: (n_samples, 4) bytes "a|b\t"
            a1 = rng.integers(0, n_allele, n_samples).astype(np.uint8) + ord("0")
            a2 = rng.integers(0, n_allele, n_samples).astype(np.uint8) + ord("0")
            a1[rng.random(n_samples) < p_missing] = ord(".")
            a2[rng.random(n_samples) < p_missing] = ord(".")
            cells = np.empty((n_samples, 4), dtype=np.uint8)
            cells[:, 0] = a1
            cells[:, 1] = ord(sep)
            cells[:, 2] = a2
            cells[:, 3] = ord("\t")
            gt_str = cells.tobytes()[:-1].decode("latin-1")
            qual = "%g" % float(np.round(rng.random() * 200, 1))
            flt = "PASS"
            if with_filter and rng.random() < 0.1:
                flt = "q10"
            lines.append(
                f"{c}\t{pos}\t.\t{ref}\t{','.join(alts)}\t{qual}\t{flt}\t.\tGT\t"
                + gt_str
            )
    return "\n".join(lines) + "\n"


def cohort_vcf(
    n_samples: int = 2504,
    n_sites: int = 20000,
    seed: int = 0,
    chrom: str = "11",
    chrom_len: int = 135006516,
    n_founders: int = 64,
    switch_rate: float = 0.002,
    p_multi: float = 0.1,
    p_indel: float = 0.15,
    p_missing: float = 0.002,
) -> str:
    """LD-structured cohort: sample haplotypes are founder mosaics.

    Real cohorts have long shared haplotype stretches, which is what makes
    the PBWT+RLE layout compress (reference tex/bgt.tex:132-133).  Each of
    the 2*n_samples haplotypes copies one of ``n_founders`` founder
    haplotypes, switching founders between consecutive sites with
    probability ``switch_rate`` — the columns are then strongly correlated
    and runs are long, like the 1kg data.
    """
    rng = np.random.default_rng(seed)
    n_hap = 2 * n_samples
    # founder alleles per site: mostly biallelic with realistic freq spectrum
    freqs = rng.beta(0.2, 0.8, size=n_sites)
    founder = (rng.random((n_sites, n_founders)) < freqs[:, None]).astype(np.uint8)
    # founder choice paths for each haplotype
    fid = np.empty((n_sites, n_hap), dtype=np.int32)
    fid[0] = rng.integers(0, n_founders, n_hap)
    switches = rng.random((n_sites - 1, n_hap)) < switch_rate
    jumps = rng.integers(0, n_founders, (n_sites - 1, n_hap)).astype(np.int32)
    cur = fid[0].copy()
    for i in range(1, n_sites):
        sw = switches[i - 1]
        cur = np.where(sw, jumps[i - 1], cur)
        fid[i] = cur
    gts = founder[np.arange(n_sites)[:, None], fid]  # (sites, haps) 0/1
    miss = rng.random((n_sites, n_hap)) < p_missing

    samples = [f"S{i:04d}" for i in range(n_samples)]
    lines = [
        "##fileformat=VCFv4.1",
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
        f"##contig=<ID={chrom},length={chrom_len}>",
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
        + "\t".join(samples),
    ]
    positions = np.sort(rng.choice(
        np.arange(10_000, chrom_len - 10_000), size=n_sites, replace=False))
    cells = np.empty((n_hap // 2, 4), dtype=np.uint8)
    cells[:, 1] = ord("|")
    cells[:, 3] = ord("\t")
    for i in range(n_sites):
        pos = int(positions[i])
        is_indel = rng.random() < p_indel
        if is_indel:
            rl = int(rng.integers(2, 5))
            ref = "".join(BASES[k] for k in rng.integers(0, 4, rl))
            alt = ref[0]
        else:
            r = int(rng.integers(0, 4))
            ref = BASES[r]
            alt = BASES[(r + 1 + int(rng.integers(0, 3))) % 4]
            if alt == ref:
                alt = BASES[(r + 1) % 4]
        alts = [alt]
        row = gts[i] + ord("0")
        if rng.random() < p_multi and not is_indel:
            a2 = BASES[(BASES.index(ref) + 2) % 4]
            if a2 not in (ref, alt):
                alts.append(a2)
                promote = (gts[i] == 1) & (rng.random(n_hap) < 0.3)
                row = np.where(promote, ord("2"), row).astype(np.uint8)
        row = np.where(miss[i], ord("."), row).astype(np.uint8)
        cells[:, 0] = row[0::2]
        cells[:, 2] = row[1::2]
        gt_str = cells.tobytes()[:-1].decode("latin-1")
        lines.append(f"{chrom}\t{pos}\t.\t{ref}\t{','.join(alts)}\t100\tPASS\t.\tGT\t"
                     + gt_str)
    return "\n".join(lines) + "\n"


def cohort_vcf_to_file(path: str,
                       n_samples: int = 32488,
                       n_sites: int = 30000,
                       seed: int = 0,
                       chrom: str = "11",
                       chrom_len: int = 135006516,
                       n_founders: int = 64,
                       switch_rate: float = 0.002,
                       p_multi: float = 0.1,
                       p_indel: float = 0.15,
                       p_missing: float = 0.002,
                       chunk_sites: int = 2000) -> None:
    """HRC-scale LD-structured cohort streamed to ``path`` in site chunks.

    Same generative model as :func:`cohort_vcf` (founder-mosaic haplotypes)
    but chunked so tens of thousands of samples never materialize a
    multi-GB string or a (sites, haps) int32 path matrix at once.
    """
    rng = np.random.default_rng(seed)
    n_hap = 2 * n_samples
    samples = [f"S{i:05d}" for i in range(n_samples)]
    positions = np.sort(rng.choice(
        np.arange(10_000, chrom_len - 10_000), size=n_sites, replace=False))
    cur = rng.integers(0, n_founders, n_hap).astype(np.int32)
    cells = np.empty((n_samples, 4), dtype=np.uint8)
    cells[:, 1] = ord("|")
    cells[:, 3] = ord("\t")
    with open(path, "w") as fp:
        fp.write("##fileformat=VCFv4.1\n"
                 '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n'
                 f"##contig=<ID={chrom},length={chrom_len}>\n"
                 "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                 + "\t".join(samples) + "\n")
        for lo in range(0, n_sites, chunk_sites):
            hi = min(lo + chunk_sites, n_sites)
            k = hi - lo
            freqs = rng.beta(0.2, 0.8, size=k)
            founder = (rng.random((k, n_founders))
                       < freqs[:, None]).astype(np.uint8)
            switches = rng.random((k, n_hap)) < switch_rate
            jumps = rng.integers(0, n_founders, (k, n_hap)).astype(np.int32)
            lines = []
            for i in range(k):
                if lo + i > 0:
                    cur = np.where(switches[i], jumps[i], cur)
                g = founder[i][cur]
                miss = rng.random(n_hap) < p_missing
                pos = int(positions[lo + i])
                is_indel = rng.random() < p_indel
                if is_indel:
                    rl = int(rng.integers(2, 5))
                    ref = "".join(BASES[j] for j in rng.integers(0, 4, rl))
                    alt = ref[0]
                else:
                    r = int(rng.integers(0, 4))
                    ref = BASES[r]
                    alt = BASES[(r + 1 + int(rng.integers(0, 3))) % 4]
                    if alt == ref:
                        alt = BASES[(r + 1) % 4]
                alts = [alt]
                row = g + ord("0")
                if rng.random() < p_multi and not is_indel:
                    a2 = BASES[(BASES.index(ref) + 2) % 4]
                    if a2 not in (ref, alt):
                        alts.append(a2)
                        promote = (g == 1) & (rng.random(n_hap) < 0.3)
                        row = np.where(promote, ord("2"), row).astype(np.uint8)
                row = np.where(miss, ord("."), row).astype(np.uint8)
                cells[:, 0] = row[0::2]
                cells[:, 2] = row[1::2]
                gt_str = cells.tobytes()[:-1].decode("latin-1")
                lines.append(
                    f"{chrom}\t{pos}\t.\t{ref}\t{','.join(alts)}\t100\tPASS"
                    f"\t.\tGT\t" + gt_str)
            fp.write("\n".join(lines) + "\n")


def vcf_text_to_bcf(vcf_text: str, out_path: str) -> None:
    """Convert VCF text to a BCF2 file (for BCF-input import tests)."""
    from .formats import bcf as bcflib
    from .io.bgzf import BgzfWriter

    lines = vcf_text.splitlines()
    hdr_lines = [l for l in lines if l.startswith("#")]
    h = bcflib.BcfHeader.from_text("\n".join(hdr_lines))
    with BgzfWriter(out_path) as out:
        h.write_bcf(out)
        b = bcflib.Bcf1()
        for line in lines:
            if line.startswith("#") or not line:
                continue
            bcflib.vcf_parse1(line, h, b)
            b.write(out)


def random_spl(n_samples: int, seed: int = 0, sample_prefix: str = "S",
               populations=("CEU", "YRI", "CHB", "TSI")) -> str:
    """Sample metadata in FMF with population and gender keys."""
    rng = np.random.default_rng(seed + 1)
    lines = []
    for i in range(n_samples):
        pop = populations[int(rng.integers(0, len(populations)))]
        gender = "M" if rng.random() < 0.5 else "F"
        lines.append(f"{sample_prefix}{i:04d}\tpopulation:Z:{pop}\tgender:Z:{gender}")
    return "\n".join(lines) + "\n"


def _bernoulli_cells(rng, k: int, n: int, p: float):
    """(row, col) index arrays, sorted by row, of the cells of a k x n grid
    hit by independent Bernoulli(p) events — drawn sparsely (a count, then
    positions) instead of one uniform per cell.  A cell drawn twice counts
    once, a negligible bias at the small rates used here."""
    flat = np.sort(rng.integers(0, k * n, rng.binomial(k * n, p)))
    return flat // n, flat % n


def synth_gt_bcf_to_file(path: str,
                         n_samples: int,
                         n_sites: int,
                         seed: int = 0,
                         chrom: str = "11",
                         chrom_len: int = 135006516,
                         n_founders: int = 64,
                         switch_rate: float = 0.002,
                         p_missing: float = 0.002,
                         chunk_sites: int = 2048,
                         log_every: int = 0) -> None:
    """LD-structured cohort written DIRECTLY as a genotyped BCF.

    The text-VCF generators cannot reach true HRC scale (32,488 samples x
    millions of sites is hundreds of GB of text); this one synthesizes the
    founder-mosaic genotype codes per chunk, packs them into bit planes,
    and serializes biallelic-SNP records through the native BCF emitter
    into a BGZF stream — generation runs at deflate speed.  The output is
    a standard GT BCF accepted by both importers (ours and the
    reference's)."""
    import numpy as np
    from . import native
    from .formats import bcf as bcflib
    from .io.bgzf import BgzfWriter
    from .ops.tiles import TileStore

    if native.get_lib() is None:
        raise RuntimeError("synth_gt_bcf_to_file needs the native library")
    rng = np.random.default_rng(seed)
    n_hap = 2 * n_samples
    samples = [f"S{i:05d}" for i in range(n_samples)]
    text = ("##fileformat=VCFv4.1\n"
            '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n'
            f"##contig=<ID={chrom},length={chrom_len}>\n"
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
            + "\t".join(samples) + "\n")
    h = bcflib.BcfHeader.from_text(text)
    gt_id = h.id2int(bcflib.BCF_DT_ID, "GT")
    assert gt_id >= 0

    # ascending unique positions via random gaps scaled into the contig
    span = chrom_len - 20_000
    # mean gap ~0.75*span/n_sites keeps the cumsum comfortably inside the
    # contig (relative sd shrinks as 1/sqrt(n))
    max_gap = max(2, 3 * span // (2 * n_sites))
    gaps = rng.integers(1, max_gap, n_sites)
    pos = 10_000 + np.cumsum(gaps)
    assert int(pos[-1]) < chrom_len, "positions overflow the contig"
    refs = rng.integers(0, 4, n_sites).astype(np.int64)
    alts = (refs + rng.integers(1, 4, n_sites)) % 4
    base = np.frombuffer(b"ACGT", np.uint8)

    cur = rng.integers(0, n_founders, n_hap).astype(np.int32)
    cols = np.arange(n_hap, dtype=np.int64)
    import os
    with open(path, "wb") as raw:
        out = BgzfWriter(raw, level=1, threads=min(os.cpu_count() or 1, 8))
        h.write_bcf(out)
        for lo in range(0, n_sites, chunk_sites):
            hi = min(lo + chunk_sites, n_sites)
            k = hi - lo
            freqs = rng.beta(0.2, 0.8, size=k)
            founder = (rng.random((k, n_founders))
                       < freqs[:, None]).astype(np.uint8)
            sw_site, sw_hap = _bernoulli_cells(rng, k, n_hap, switch_rate)
            jumps = rng.integers(0, n_founders, sw_site.size).astype(np.int32)
            bounds = np.searchsorted(sw_site, np.arange(k + 1))
            codes = np.empty((k, n_hap), dtype=np.uint8)
            for i in range(k):
                if lo + i > 0:
                    sl = slice(bounds[i], bounds[i + 1])
                    cur[sw_hap[sl]] = jumps[sl]
                codes[i] = founder[i][cur]
            miss_site, miss_hap = _bernoulli_cells(rng, k, n_hap, p_missing)
            codes[miss_site, miss_hap] = 2
            ts = TileStore.from_codes(codes)
            zeros = np.zeros(k, dtype=np.int64)
            chunks = native.emit_bcf_records(
                np.zeros(k, np.int32), pos[lo:hi], np.ones(k, np.int64),
                base[refs[lo:hi]].tobytes(),
                np.arange(k, dtype=np.int64), np.ones(k, np.int32),
                base[alts[lo:hi]].tobytes(),
                np.arange(k, dtype=np.int64), np.ones(k, np.int32),
                np.full(k, 2, np.int32), np.full(k, -1, np.int64),
                0, 1, zeros, zeros, zeros, None, None, None,
                -1, -1, -1, [], [], gt_id,
                (ts.plane0, ts.plane1, cols))
            for c in chunks:
                out.write(memoryview(c))
            if log_every and (lo // chunk_sites) % log_every == 0:
                import sys
                print(f"[synth] {hi}/{n_sites} sites", file=sys.stderr,
                      flush=True)
        out.close()
