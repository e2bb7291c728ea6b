"""``bgt import`` / ``bgt atomize`` / ``bgt bcfidx``: build a BGT database.

Produces the reference's exact on-disk layout (reference import.c:8-120):
``PREFIX.pbf`` (2-plane PBWT matrix, shift=13), ``PREFIX.bcf`` (site-only
records carrying INFO/_row), ``PREFIX.bcf.csi`` (CSI + RNI record index) and
``PREFIX.spl`` (sample names).  The site BCF is byte-identical to reference
output for the same input.
"""

from __future__ import annotations

import sys

import numpy as np

from ..core.atomize import AtomBuffer, atom_to_bcf
from ..formats import bcf as bcflib
from ..formats.csi import HtsIndex
from ..formats.pbf import PbfWriter
from ..io import files
from ..io.bgzf import BgzfReader, BgzfWriter

PBF_SHIFT = 13


def build_bcf_index(fn: str, min_shift: int = 14) -> None:
    """bcf_index_build: CSI + RNI over a site BCF (vcf.c:1002-1038)."""
    fp = BgzfReader(fn)
    h = bcflib.BcfHeader.read_bcf(fp)
    max_len = 0
    for _name, ii in h.ids[bcflib.BCF_DT_CTG]:
        max_len = max(max_len, ii.info[0])
    max_len += 256
    n_lvls, s = 0, 1 << min_shift
    while max_len > s:
        n_lvls += 1
        s <<= 3
    idx = HtsIndex(h.n(bcflib.BCF_DT_CTG), min_shift, n_lvls, offset0=fp.tell())
    b = bcflib.Bcf1()
    while b.read(fp) >= 0:
        idx.push(b.rid, b.pos, b.pos + b.rlen, fp.tell(), True)
    idx.finish(fp.tell())
    fp.close()
    idx.save(fn)


def _ht_type(hdr, key: str) -> int:
    ii = hdr.dicts[bcflib.BCF_DT_ID].get(key)
    if ii is None or ii.info[bcflib.BCF_HL_INFO] == 15:
        return -1
    return (ii.info[bcflib.BCF_HL_INFO] >> 4) & 0xF


def _native_import(prefix: str, inputs: list[str], is_vcf: bool | None,
                   first_text: bool, h, h0, keep_filtered: bool, clevel: int,
                   n_samples: int, gen_pb1: bool = False) -> int | None:
    """One-pass native import (parse+atomize+write in C++) over any mix of
    text-VCF and binary-BCF inputs, appended in order (reference
    import.c:45,85-109); returns n rows or None when the native path is
    unavailable/inapplicable (caller falls back to the Python pipeline;
    partial outputs are removed natively)."""
    import os

    from .. import native
    if native.get_lib() is None:
        return None
    data = h0.raw[: h0.l_text].encode("latin-1")
    import struct
    blob = b"BCF\x02\x02" + struct.pack("<i", len(data)) + data
    row_kid = h0.id2int(bcflib.BCF_DT_ID, "_row")
    job = native.import_open(f"{prefix}.pbf", f"{prefix}.bcf", blob,
                             n_samples, clevel, row_kid, PBF_SHIFT,
                             f"{prefix}.pb1" if gen_pb1 else None)
    if job is None:
        return None
    # in-job CSI builder: bin/linear/RNI state advances per emitted record
    # in C++ (the vectorized Python pass cost ~12 s at 39.2M rows)
    max_len = 0
    for _name, ii in h0.ids[bcflib.BCF_DT_CTG]:
        max_len = max(max_len, ii.info[0])
    max_len += 256
    n_lvls, s = 0, 1 << 14
    while max_len > s:
        n_lvls += 1
        s <<= 3
    n_ctg = h0.n(bcflib.BCF_DT_CTG)
    native.import_csi_init(job, n_ctg, 14, n_lvls)
    # the output header's contig order (identical to the first input's):
    # text records resolve contigs by NAME against this list; BCF records
    # remap their file-local rid through it
    out_ctg = {name: i for i, (name, _ii)
               in enumerate(h0.ids[bcflib.BCF_DT_CTG])}
    out_contigs = [name for name, _ii in h0.ids[bcflib.BCF_DT_CTG]]
    ok = True
    for j, fn in enumerate(inputs):
        if j == 0:
            src_h, src_text = h, first_text
        else:
            try:
                src = files.open_vcf(fn, is_vcf)
            except (OSError, ValueError):
                ok = False
                break
            src_h = src.header
            src_text = isinstance(src, files.VcfTextReader)
            src.close()
            if src_h.n(bcflib.BCF_DT_SAMPLE) != n_samples:
                ok = False
                break
        if src_text:
            filters = [(name, ii.id) for name, ii
                       in src_h.ids[bcflib.BCF_DT_ID]]
            ok = native.import_add_text(
                job, fn, out_contigs, filters, keep_filtered,
                _ht_type(src_h, "END") == bcflib.BCF_HT_INT,
                _ht_type(src_h, "CIGAR") == bcflib.BCF_HT_STR)
        else:
            gt_kid = src_h.id2int(bcflib.BCF_DT_ID, "GT")
            if gt_kid < 0:
                ok = False
                break
            cigar_kid = (src_h.id2int(bcflib.BCF_DT_ID, "CIGAR")
                         if _ht_type(src_h, "CIGAR") == bcflib.BCF_HT_STR
                         else -1)
            rid_map = np.array(
                [out_ctg.get(name, -1) for name, _ii
                 in src_h.ids[bcflib.BCF_DT_CTG]], dtype=np.int32)
            # PASS is dictionary id 0 in any spec-conforming header, but a
            # legal nonstandard header may place it elsewhere — resolve it
            # (vcf.c guarantees the implicit definition; a header where PASS
            # is genuinely absent falls back to the Python importer)
            pass_fid = src_h.id2int(bcflib.BCF_DT_ID, "PASS")
            if pass_fid < 0 and not keep_filtered:
                ok = False
                break
            ok = native.import_add_bcf(job, fn, rid_map, gt_kid, cigar_kid,
                                       pass_fid, keep_filtered)
        if not ok:
            break
    if not ok:
        native.import_abort(job)  # finish then removes the partial outputs
    res = native.import_finish(job)
    if not ok or res is None:
        return None
    try:
        return _finish_native_import(prefix, res, n_ctg, n_lvls)
    finally:
        res.free()


def _finish_native_import(prefix: str, res, n_ctg: int,
                          n_lvls: int) -> int | None:
    import os
    n, rid, pos, voff0 = res.n, res.rid, res.pos, res.voff0
    sites, csi = res.sites, res.csi
    # CSI + RNI directly from the writer's record offsets (no re-read).
    # Preferred source: the in-job C++ builder (csi); fallback: the
    # vectorized push_batch over the returned record columns.  A CSI
    # failure here (e.g. atoms out of order across a multi-file append)
    # must not leave an unindexed half-built database: remove the outputs
    # and let the caller fall back to the Python importer.
    idx = HtsIndex(n_ctg, 14, n_lvls, offset0=voff0)
    try:
        if csi is not None:
            _assemble_csi(idx, csi)
        elif n:
            idx.push_batch(rid, pos, res.end, res.voff)
        idx.finish(os.path.getsize(f"{prefix}.bcf") << 16)
        idx.save(f"{prefix}.bcf")
    except Exception:
        for suf in (".bcf", ".bcf.csi", ".pbf", ".pb1"):
            try:
                os.remove(prefix + suf)
            except OSError:
                pass
        return None
    # site-table sidecar: the importer has every site in hand, so pay the
    # .sites.bin write now instead of a cold-query re-scan of the BCF
    # (the reference builds its index at import for the
    # same reason, import.c:117).  Written AFTER the .bcf/.csi so its mtime
    # passes the freshness check; best-effort (the lazy build remains).
    try:
        from ..formats import sites as sites_fmt
        sites_fmt.write_sidecar(
            prefix + ".sites.bin", rid, pos, sites["rlen"],
            sites["n_allele"], sites["ref_len"], sites["alt_len"],
            sites["ref_cat"], sites["alt_cat"])
    except OSError:
        pass
    return n


def _assemble_csi(idx: HtsIndex, csi: dict) -> None:
    """Load the native in-job CSI builder's runs/linear/RNI data into a
    fresh :class:`HtsIndex`, leaving exactly the state push_batch leaves so
    ``finish()`` closes the final bin and the pseudo-bin of the last contig
    (same contract, ~12 s cheaper at 39.2M rows)."""
    for i, (run_bin, run_u, run_v, lidx) in enumerate(csi["ctg"]):
        d = idx.bidx[i]
        bins = run_bin.tolist()
        # the khash layout replay needs the FULL put sequence, duplicates
        # included (they drive resize timing) — the native builder records
        # one entry per insert_to_b
        idx._bin_order[i] = bins
        for b, u, v in zip(bins, run_u.tolist(), run_v.tolist()):
            lst = d.get(b)
            if lst is None:
                lst = d[b] = []
            lst.append((u, v))
        idx.lidx[i] = lidx.tolist()
    idx.ridx = csi["ridx"].astype(np.int64).tolist()
    idx.n_rec = csi["n_rec"]
    idx.n = max(idx.n, csi["n_ctg"])
    idx._save_tid = csi["save_tid"]
    idx._save_bin = csi["save_bin"] if csi["save_bin"] >= 0 else -1
    idx._save_off = csi["save_off"]
    idx._off_beg = csi["off_beg"]
    idx._n_mapped = csi["n_mapped"]
    idx._n_unmapped = csi["n_unmapped"]


def import_vcf(prefix: str, inputs: list[str], is_vcf: bool | None = None,
               keep_filtered: bool = False, clevel: int = -1,
               fn_ref: str | None = None, gen_pb1: bool = False) -> int:
    """Import VCF/BCF file(s) into a BGT database at ``prefix``."""
    first = files.open_vcf(inputs[0], is_vcf, fn_ref)
    h = first.header
    n_samples = h.n(bcflib.BCF_DT_SAMPLE)
    assert n_samples > 0, "input must have samples"

    h0 = h.subset(None)
    if h0.id2int(bcflib.BCF_DT_ID, "GT") < 0:
        h0.append('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">')
    h0.append('##INFO=<ID=_row,Number=1,Type=Integer,Description="row number">')

    with open(f"{prefix}.spl", "w") as fp:
        for s in h.samples:
            fp.write(s + "\n")

    import os
    if (fn_ref is None
            and os.environ.get("BGT_TPU_NATIVE_IMPORT", "1") != "0"):
        n = _native_import(prefix, inputs, is_vcf,
                           isinstance(first, files.VcfTextReader),
                           h, h0, keep_filtered, clevel, n_samples,
                           gen_pb1)
        if n is not None:
            first.close()
            return n

    ab = AtomBuffer(h, first, keep_filtered)

    from .. import native
    pbf = None
    try:
        pbf = native.NativePbfWriter(f"{prefix}.pbf", n_samples * 2, 2, PBF_SHIFT)
    except (RuntimeError, OSError):
        pbf = PbfWriter(f"{prefix}.pbf", n_samples * 2, 2, PBF_SHIFT)
    pbf1 = None
    if gen_pb1:  # single-plane .pb1 (import -1, reference import.c:74,101)
        try:
            pbf1 = native.NativePbfWriter(f"{prefix}.pb1", n_samples * 2, 1,
                                          PBF_SHIFT)
        except (RuntimeError, OSError):
            pbf1 = PbfWriter(f"{prefix}.pb1", n_samples * 2, 1, PBF_SHIFT)
    out = BgzfWriter(f"{prefix}.bcf", clevel)
    h0.write_bcf(out)

    # The PBWT encode runs on a worker thread consuming row batches: the
    # ctypes call releases the GIL, so parsing/atomizing the next records
    # overlaps encoding (the reference is strictly sequential, import.c:92-103)
    import queue
    import threading

    batch_rows = 256
    q: queue.Queue = queue.Queue(maxsize=4)
    worker_err: list = []

    def encode_worker():
        while True:
            item = q.get()
            if item is None:
                return
            try:
                if isinstance(pbf, PbfWriter):
                    for row in item:
                        pbf.write_row([row & 1, row >> 1])
                else:
                    pbf.write_codes(item)
                if pbf1 is not None:
                    bit1 = (item == 1).astype(np.uint8)
                    if isinstance(pbf1, PbfWriter):
                        for row in bit1:
                            pbf1.write_row([row])
                    else:
                        pbf1.write_codes(bit1)
            except Exception as e:  # noqa: BLE001 - re-raised on main thread
                worker_err.append(e)
                return

    wt = threading.Thread(target=encode_worker, daemon=True)
    wt.start()

    n = 0
    b = bcflib.Bcf1()
    pend: list = []
    try:
        for j, fn in enumerate(inputs):
            if j > 0:
                src = files.open_vcf(fn, is_vcf, fn_ref)
                ab = AtomBuffer(src.header, src, keep_filtered)
            for a in ab:
                atom_to_bcf(a, b, write_m=True, id_gt=-1)
                b.append_info_ints(h0, "_row", [n])
                pend.append(np.asarray(a.gt, dtype=np.uint8))
                if len(pend) >= batch_rows:
                    if worker_err:
                        raise worker_err[0]
                    q.put(np.vstack(pend))
                    pend = []
                b.n_sample = 0  # bcf_subset(h0, b, 0, 0)
                b.indiv = bytearray()
                b.write(out)
                n += 1
    finally:
        if pend and not worker_err:
            q.put(np.vstack(pend))
        q.put(None)
        wt.join()
    if worker_err:
        raise worker_err[0]
    out.close()
    pbf.close()
    if pbf1 is not None:
        pbf1.close()
    build_bcf_index(f"{prefix}.bcf", 14)
    return n


def atomize_cli(fn: str, is_vcf: bool | None = None, bcf_out: bool = False,
                write_m: bool = False, use_missing: bool = True,
                out_fp=None, fn_ref: str | None = None) -> int:
    """``bgt atomize``: stream atomized records to stdout (import.c:135-190)."""
    src = files.open_vcf(fn, is_vcf, fn_ref)
    h = src.header
    ab = AtomBuffer(h, src, keep_filtered=False)
    out_fp = out_fp or sys.stdout
    # header is written BEFORE the GT line may be appended (import.c:171-177)
    if bcf_out:
        out = BgzfWriter(out_fp.buffer if hasattr(out_fp, "buffer") else out_fp)
        h.write_bcf(out)
    else:
        out_fp.write(h.vcf_text())
    if h.id2int(bcflib.BCF_DT_ID, "GT") < 0:
        h.append('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">')
    id_gt = h.id2int(bcflib.BCF_DT_ID, "GT")
    b = bcflib.Bcf1()
    n = 0
    for a in ab:
        atom_to_bcf(a, b, write_m, id_gt, use_missing)
        if bcf_out:
            b.write(out)
        else:
            out_fp.write(bcflib.vcf_format1(h, b) + "\n")
        n += 1
    if bcf_out:
        out.close()
    return n
