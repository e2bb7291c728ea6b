// Native host runtime for bgt_tpu: the sequential hot loops that feed the
// device compute path.  Implements the PBF (positional-BWT + RLE) codec for
// import (encode) and device-tile building (decode), against the on-disk
// format documented in bgt_tpu/formats/pbf.py (byte-compatible with the
// reference implementation's pbwt.c container).
//
// Build: tools/build_native.sh -> build/lib/libbgt_host.so
// Bindings: ctypes (bgt_tpu/native.py); everything falls back to the
// vectorized-numpy paths when the library is absent.

#include <cctype>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <deque>
#include <mutex>
#include <string>
#include <string_view>
#include <thread>
#include <chrono>
#include <unordered_map>
#include <vector>

#include <algorithm>
#include <atomic>
#include <fcntl.h>
#include <unistd.h>

#include <zlib.h>

namespace {

// ---------------------------------------------------------------------------
// RLE: byte = (len<<1|bit) for len<16, else one byte per nonzero nibble of
// the 32-bit length, high nibble first: ((pos<<4|nibble)<<1|bit).
// ---------------------------------------------------------------------------

inline size_t rle_emit_run(uint8_t* out, uint32_t len, int bit) {
    if (len < 16) {
        *out = (uint8_t)(len << 1 | bit);
        return 1;
    }
    uint8_t* q = out;
    for (int pos = 7; pos >= 0; --pos) {
        uint32_t nib = (len >> (4 * pos)) & 0xFu;
        if (nib) *q++ = (uint8_t)((((uint32_t)pos << 4 | nib) << 1) | bit);
    }
    return (size_t)(q - out);
}

inline uint32_t rle_run_len(uint8_t v) {
    uint32_t t = v >> 1;
    return (t & 0xFu) << (4 * (t >> 4));
}

struct PbwtPlane {
    int32_t m;
    std::vector<int32_t> S;     // current permutation
    std::vector<int32_t> Snew;  // scratch
    std::vector<uint8_t> u;     // transformed row scratch
    std::vector<uint8_t> rle;   // rle scratch

    explicit PbwtPlane(int32_t m_) : m(m_), S(m_), Snew(m_), u(m_) {
        for (int32_t j = 0; j < m; ++j) S[j] = j;
        rle.resize((size_t)m * 2 + 16);
    }

    // encode one row of 0/1 bits given in original column order
    // returns rle length (bytes stay in this->rle)
    int32_t encode(const uint8_t* bits) {
        int32_t n1 = 0;
        for (int32_t j = 0; j < m; ++j) {
            uint8_t b = bits[S[j]] ? 1 : 0;
            u[j] = b;
            n1 += b;
        }
        // stable partition S by u
        int32_t p0 = 0, p1 = m - n1;
        for (int32_t j = 0; j < m; ++j) {
            if (u[j]) Snew[p1++] = S[j];
            else Snew[p0++] = S[j];
        }
        S.swap(Snew);
        // run-length encode u
        uint8_t* out = rle.data();
        size_t o = 0;
        uint32_t len = 1;
        uint8_t last = u[0];
        for (int32_t j = 1; j < m; ++j) {
            if (u[j] == last) {
                ++len;
            } else {
                o += rle_emit_run(out + o, len, last);
                len = 1;
                last = u[j];
            }
        }
        o += rle_emit_run(out + o, len, last);
        return (int32_t)o;
    }

    // decode one RLE row; sets bits (bit j of out_words for column j) for
    // 1-valued columns.  out_words must be zeroed by the caller.
    void decode_to_bits(const uint8_t* rle_in, int32_t l, uint32_t* out_words) {
        // count ones
        int64_t n1 = 0;
        for (int32_t i = 0; i < l; ++i)
            if (rle_in[i] & 1) n1 += rle_run_len(rle_in[i]);
        if (n1 == 0) return;  // all zero, S unchanged
        if (n1 == m) {        // all one, S unchanged
            for (int32_t j = 0; j < m; ++j)
                out_words[(uint32_t)j >> 5] |= 1u << (j & 31);
            return;
        }
        int32_t p0 = 0, p1 = (int32_t)(m - n1);
        int32_t s = 0;
        for (int32_t i = 0; i < l; ++i) {
            int32_t run = (int32_t)rle_run_len(rle_in[i]);
            int bit = rle_in[i] & 1;
            const int32_t* src = S.data() + s;
            if (bit) {
                for (int32_t k = 0; k < run; ++k) {
                    uint32_t idx = (uint32_t)src[k];
                    out_words[idx >> 5] |= 1u << (idx & 31);
                }
                memcpy(Snew.data() + p1, src, (size_t)run * 4);
                p1 += run;
            } else {
                memcpy(Snew.data() + p0, src, (size_t)run * 4);
                p0 += run;
            }
            s += run;
        }
        S.swap(Snew);
    }
};

bool write_all(FILE* fp, const void* buf, size_t n) {
    return fwrite(buf, 1, n, fp) == n;
}

}  // namespace

// ---------------------------------------------------------------------------
// Streaming PBF writer
// ---------------------------------------------------------------------------

struct PbfWriterHandle {
    FILE* fp;
    int32_t m, g, shift;
    int64_t n;
    std::vector<PbwtPlane*> planes;
    std::vector<uint64_t> idx;
    std::vector<uint8_t> bits;  // plane-bit scratch
};

extern "C" {

void* bgt_pbf_writer_open(const char* path, int32_t m, int32_t g, int32_t shift) {
    FILE* fp = fopen(path, "wb");
    if (!fp) return nullptr;
    auto* h = new PbfWriterHandle();
    h->fp = fp;
    h->m = m;
    h->g = g;
    h->shift = shift;
    h->n = 0;
    for (int i = 0; i < g; ++i) h->planes.push_back(new PbwtPlane(m));
    h->bits.resize((size_t)m);
    fwrite("PBF\1", 1, 4, fp);
    int32_t v[3] = {m, g, shift};
    fwrite(v, 4, 3, fp);
    return h;
}

// codes: n_rows * m genotype codes; plane k takes bit k of each code.
// Large batches encode the two planes in parallel (their PBWT chains are
// independent; only the per-row output interleaving is shared) — the
// import consumer feeds 256-row batches.
int64_t bgt_pbf_writer_write(void* hv, const uint8_t* codes, int64_t n_rows) {
    auto* h = (PbfWriterHandle*)hv;
    int64_t r = 0;
    while (r < n_rows) {
        // segment ends at the next S-checkpoint boundary
        int64_t until_ck = (1ll << h->shift) - (h->n & ((1ll << h->shift) - 1));
        if ((h->n & ((1ll << h->shift) - 1)) == 0) {
            h->idx.push_back((uint64_t)ftello(h->fp));
            fputc('S', h->fp);
            for (auto* pl : h->planes)
                if (!write_all(h->fp, pl->S.data(), (size_t)h->m * 4))
                    return -1;
            until_ck = 1ll << h->shift;
        }
        int64_t seg = std::min(n_rows - r, until_ck);
        // plane-parallel encode only when a third core exists: on 2-core
        // hosts the import's parse thread owns the second core and a third
        // worker just thrashes (measured 3.6s -> 5.6s on the 1kg shape)
        static const bool par = std::thread::hardware_concurrency() >= 3;
        if (par && h->g == 2 && seg >= 16) {
            // per-plane encode of the whole segment, worker + main
            struct Enc {
                std::vector<uint8_t> rle;
                std::vector<int32_t> lens;
            } enc[2];
            auto run = [&](int k) {
                auto* pl = h->planes[k];
                std::vector<uint8_t> bits((size_t)h->m);
                Enc& e = enc[k];
                e.lens.resize(seg);
                for (int64_t i = 0; i < seg; ++i) {
                    const uint8_t* row = codes + (r + i) * h->m;
                    for (int32_t j = 0; j < h->m; ++j)
                        bits[j] = (row[j] >> k) & 1;
                    int32_t l = pl->encode(bits.data());
                    e.lens[i] = l;
                    e.rle.insert(e.rle.end(), pl->rle.data(),
                                 pl->rle.data() + l);
                }
            };
            std::thread t0(run, 0);
            run(1);
            t0.join();
            size_t o0 = 0, o1 = 0;
            for (int64_t i = 0; i < seg; ++i) {
                fputc('B', h->fp);
                if (!write_all(h->fp, &enc[0].lens[i], 4)) return -1;
                if (!write_all(h->fp, enc[0].rle.data() + o0,
                               (size_t)enc[0].lens[i]))
                    return -1;
                o0 += enc[0].lens[i];
                if (!write_all(h->fp, &enc[1].lens[i], 4)) return -1;
                if (!write_all(h->fp, enc[1].rle.data() + o1,
                               (size_t)enc[1].lens[i]))
                    return -1;
                o1 += enc[1].lens[i];
            }
            h->n += seg;
            r += seg;
            continue;
        }
        for (int64_t i = 0; i < seg; ++i) {
            const uint8_t* row = codes + (r + i) * h->m;
            fputc('B', h->fp);
            for (int k = 0; k < h->g; ++k) {
                auto* pl = h->planes[k];
                for (int32_t j = 0; j < h->m; ++j)
                    h->bits[j] = (row[j] >> k) & 1;
                int32_t l = pl->encode(h->bits.data());
                if (!write_all(h->fp, &l, 4)) return -1;
                if (!write_all(h->fp, pl->rle.data(), (size_t)l)) return -1;
            }
            ++h->n;
        }
        r += seg;
    }
    return h->n;
}

int bgt_pbf_writer_close(void* hv) {
    auto* h = (PbfWriterHandle*)hv;
    uint64_t off = (uint64_t)ftello(h->fp);
    fputc('I', h->fp);
    int32_t n_idx = (int32_t)h->idx.size();
    write_all(h->fp, &h->n, 8);
    write_all(h->fp, &n_idx, 4);
    write_all(h->fp, h->idx.data(), h->idx.size() * 8);
    write_all(h->fp, &off, 8);
    int ret = fclose(h->fp);
    for (auto* pl : h->planes) delete pl;
    delete h;
    return ret;
}

// ---------------------------------------------------------------------------
// One-shot PBF -> GTC (packed tile) conversion
// ---------------------------------------------------------------------------

// GTC layout v2 (bgt_tpu/ops/tiles.py): "GTC\2" + int64 n_rows + int32 m +
// int32 n_words; then plane0 rows then plane1 rows, uint32 LE words with
// column j at word j>>5 bit j&31; then the materialized all-columns
// aggregate: n_rows x 4 int32 genotype-code counts [cnt0,cnt1,cnt2,cnt3]
// per row (the reference recomputes these per query, bgt.c:735-757; here
// they are an index built once at tile time so the all-samples AC/AN query
// never touches the genotype matrix again).
//
// The build streams: n_rows comes from the PBF footer (or a record-walk
// when the footer is absent), so each plane block is pwritten straight to
// its final offset and peak memory is O(block), independent of matrix size
// (the reference likewise never materializes the matrix, pbwt.c:313-337).

namespace {

// count 'B' records without decoding (for footer-less, pipe-written PBFs)
int64_t pbf_scan_rows(FILE* in, int32_t m, int32_t g) {
    int64_t n = 0;
    for (;;) {
        int t = fgetc(in);
        if (t == 'S') {
            if (fseeko(in, (off_t)g * m * 4, SEEK_CUR) != 0) return -1;
            t = fgetc(in);
        }
        if (t != 'B') break;
        for (int k = 0; k < g; ++k) {
            int32_t l;
            if (fread(&l, 4, 1, in) != 1) return -1;
            if (fseeko(in, l, SEEK_CUR) != 0) return -1;
        }
        ++n;
    }
    return n;
}

bool pwrite_all(int fd, const void* buf, size_t n, int64_t off) {
    const char* p = (const char*)buf;
    while (n) {
        ssize_t w = pwrite(fd, p, n, (off_t)off);
        if (w <= 0) return false;
        p += w;
        off += w;
        n -= (size_t)w;
    }
    return true;
}

}  // namespace

int64_t bgt_gtc_from_pbf(const char* pbf_path, const char* gtc_path,
                         int32_t col_align) {
    FILE* in = fopen(pbf_path, "rb");
    if (!in) return -1;
    char magic[4];
    if (fread(magic, 1, 4, in) != 4 || memcmp(magic, "PBF\1", 4) != 0) {
        fclose(in);
        return -2;
    }
    int32_t m, g, shift;
    if (fread(&m, 4, 1, in) != 1 || fread(&g, 4, 1, in) != 1 ||
        fread(&shift, 4, 1, in) != 1 || g != 2) {
        fclose(in);
        return -3;
    }
    if (col_align < 32) col_align = 1024;
    int32_t n_words = (m + col_align - 1) / col_align * (col_align / 32);

    // total rows: footer 'I' record via the trailing offset, else a walk
    off_t data_pos = ftello(in);
    int64_t n_rows = -1;
    if (fseeko(in, -8, SEEK_END) == 0) {
        uint64_t foff;
        if (fread(&foff, 8, 1, in) == 1 && foff != (uint64_t)-1 &&
            fseeko(in, (off_t)foff, SEEK_SET) == 0) {
            int64_t nr;
            if (fgetc(in) == 'I' && fread(&nr, 8, 1, in) == 1) n_rows = nr;
        }
    }
    if (n_rows < 0) {
        fseeko(in, data_pos, SEEK_SET);
        n_rows = pbf_scan_rows(in, m, g);
        if (n_rows < 0) {
            fclose(in);
            return -2;
        }
    }
    fseeko(in, data_pos, SEEK_SET);

    const int64_t hdr = 4 + 8 + 4 + 4;
    const int64_t row_bytes = (int64_t)n_words * 4;
    const int64_t plane_bytes = n_rows * row_bytes;
    const int64_t stats_off = hdr + 2 * plane_bytes;
    int fd = open(gtc_path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
    if (fd < 0) {
        fclose(in);
        return -4;
    }
    {
        char h[20];
        memcpy(h, "GTC\2", 4);
        memcpy(h + 4, &n_rows, 8);
        memcpy(h + 12, &m, 4);
        memcpy(h + 16, &n_words, 4);
        if (!pwrite_all(fd, h, 20, 0)) {
            close(fd);
            fclose(in);
            return -5;
        }
    }

    // Build strategy (r5 rewrite): parse the framing from a bounded
    // sliding-window buffer with pointer arithmetic (the old per-row
    // stdio walk cost tens of seconds of call overhead at 39.2M rows),
    // then decode the two planes' independent PBWT chains on two threads
    // per block — halves the wide-matrix decode on a 2-core host.  The
    // window refills only BETWEEN blocks (row refs point into it), so
    // memory stays O(block), preserving the bounded-memory guarantee
    // (tests/test_tiles_shard.py::test_native_build_bounded_memory).
    std::vector<PbwtPlane*> planes;
    for (int k = 0; k < g; ++k) planes.push_back(new PbwtPlane(m));
    int rc = 0;
    try {
        // worst-case bytes one row can occupy: 'S' + 2 S arrays + 'B' +
        // 2 * (len + rle payload); the encoder's own rle bound is 2m+16
        const size_t max_row_need =
            2 + 2 * (size_t)m * 4 + 2 * (4 + 2 * (size_t)m + 16) + 64;
        std::vector<uint8_t> fbuf(std::max((size_t)4 << 20,
                                           2 * max_row_need));
        size_t blo = 0, bhi = 0;  // valid window [blo, bhi)
        bool eof = false;
        auto refill = [&]() {
            if (blo > 0) {
                memmove(fbuf.data(), fbuf.data() + blo, bhi - blo);
                bhi -= blo;
                blo = 0;
            }
            while (!eof && bhi < fbuf.size()) {
                size_t got = fread(fbuf.data() + bhi, 1,
                                   fbuf.size() - bhi, in);
                bhi += got;
                if (got == 0) eof = true;
            }
        };

        int64_t block_rows = (8 << 20) / row_bytes;
        if (block_rows < 16) block_rows = 16;
        if (block_rows > n_rows && n_rows > 0) block_rows = n_rows;
        std::vector<uint32_t> blk0((size_t)block_rows * n_words, 0u);
        std::vector<uint32_t> blk1((size_t)block_rows * n_words, 0u);
        std::vector<int32_t> sblk((size_t)block_rows * 4);
        struct RowRef {
            const uint8_t* s[2];    // per-plane S checkpoint data (or null)
            const uint8_t* rle[2];
            int32_t l[2];
        };
        std::vector<RowRef> refs((size_t)block_rows);
        bool threaded = std::thread::hardware_concurrency() >= 2;

        int64_t r = 0;
        while (r < n_rows) {
            refill();
            const uint8_t* base = fbuf.data();
            size_t pos = blo, end = bhi;
            int64_t nb_rows = 0;
            int64_t want = std::min(block_rows, n_rows - r);
            while (nb_rows < want) {
                // stop the block while a refill could still complete a row
                if (!eof && end - pos < max_row_need) break;
                RowRef& rr = refs[(size_t)nb_rows];
                if (pos >= end) {
                    rc = -2;
                    goto out;
                }
                if (base[pos] == 'S') {
                    ++pos;
                    if (end - pos < 2 * (size_t)m * 4) {
                        rc = -2;
                        goto out;
                    }
                    rr.s[0] = base + pos;
                    rr.s[1] = base + pos + (size_t)m * 4;
                    pos += 2 * (size_t)m * 4;
                } else {
                    rr.s[0] = rr.s[1] = nullptr;
                }
                if (pos >= end || base[pos] != 'B') {
                    rc = -2;
                    goto out;
                }
                ++pos;
                for (int k = 0; k < 2; ++k) {
                    if (end - pos < 4) {
                        rc = -2;
                        goto out;
                    }
                    int32_t l;
                    memcpy(&l, base + pos, 4);
                    pos += 4;
                    if (l < 0 || (size_t)l > 2 * (size_t)m + 16 ||
                        end - pos < (size_t)l) {
                        rc = -2;
                        goto out;
                    }
                    rr.rle[k] = base + pos;
                    rr.l[k] = l;
                    pos += (size_t)l;
                }
                ++nb_rows;
            }
            if (nb_rows == 0) {  // no progress possible: truncated input
                rc = -2;
                goto out;
            }
            blo = pos;
            memset(blk0.data(), 0, (size_t)nb_rows * row_bytes);
            memset(blk1.data(), 0, (size_t)nb_rows * row_bytes);
            // decode: plane 1 on a worker, plane 0 on this thread
            auto decode_plane = [&](int k, uint32_t* blk) {
                PbwtPlane* pl = planes[k];
                for (int64_t i = 0; i < nb_rows; ++i) {
                    const RowRef& rr = refs[(size_t)i];
                    if (rr.s[k])
                        memcpy(pl->S.data(), rr.s[k], (size_t)m * 4);
                    pl->decode_to_bits(rr.rle[k], rr.l[k],
                                       blk + i * n_words);
                }
            };
            if (threaded) {
                try {
                    std::thread t1(decode_plane, 1, blk1.data());
                    decode_plane(0, blk0.data());
                    t1.join();
                } catch (const std::system_error&) {
                    // thread creation can fail under a hard RLIMIT_DATA
                    // (the stack mmap counts): decode sequentially
                    threaded = false;
                }
            }
            if (!threaded) {
                decode_plane(0, blk0.data());
                decode_plane(1, blk1.data());
            }
            for (int64_t i = 0; i < nb_rows; ++i) {
                const uint32_t* w0 = blk0.data() + i * n_words;
                const uint32_t* w1 = blk1.data() + i * n_words;
                int32_t n10 = 0, n11 = 0, nbb = 0;
                for (int32_t w = 0; w < n_words; ++w) {
                    n10 += __builtin_popcount(w0[w]);
                    n11 += __builtin_popcount(w1[w]);
                    nbb += __builtin_popcount(w0[w] & w1[w]);
                }
                int32_t cnt1 = n10 - nbb, cnt2 = n11 - nbb;
                int32_t* s = sblk.data() + i * 4;
                s[0] = m - cnt1 - cnt2 - nbb;
                s[1] = cnt1;
                s[2] = cnt2;
                s[3] = nbb;
            }
            if (!pwrite_all(fd, blk0.data(), (size_t)nb_rows * row_bytes,
                            hdr + r * row_bytes) ||
                !pwrite_all(fd, blk1.data(), (size_t)nb_rows * row_bytes,
                            hdr + plane_bytes + r * row_bytes) ||
                !pwrite_all(fd, sblk.data(), (size_t)nb_rows * 16,
                            stats_off + r * 16)) {
                rc = -5;
                goto out;
            }
            r += nb_rows;
        }
    } catch (const std::bad_alloc&) {
        rc = -6;
    }
out:
    fclose(in);
    for (auto* pl : planes) delete pl;
    if (close(fd) != 0 && rc == 0) rc = -6;
    return rc == 0 ? n_rows : rc;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// VCF line assembly
// ---------------------------------------------------------------------------

namespace {

inline char* put_int(char* p, int64_t v) {
    if (v < 0) {
        *p++ = '-';
        v = -v;
    }
    char tmp[24];
    int n = 0;
    do {
        tmp[n++] = (char)('0' + v % 10);
        v /= 10;
    } while (v);
    while (n) *p++ = tmp[--n];
    return p;
}

inline char* put_mem(char* p, const char* s, size_t n) {
    memcpy(p, s, n);
    return p + n;
}

}  // namespace

extern "C" {

// Assemble `n` VCF site lines into out_buf; returns bytes written (<0 if the
// buffer is too small).  Per site i:
//   chrom \t pos1 \t . \t REF \t ALT[,<M>] \t 0 \t . \t INFO [\tGT cells] \n
// INFO: [END=..;]AN=..;AC=..[,acm][;ANg=..;ACg=..[,acmg]]*   or "."
//
// chroms: concatenated contig names with offsets per site (chrom_off[i],
// chrom_len[i]); ref/alt similarly.  n_allele>2 appends ",<M>" and makes AC
// two-valued.  end_val[i] >= 0 emits END=end_val.  info_on=0 emits "." (or
// just END).  n_groups>1 appends per-group AN#/AC#.
//
// Genotype output, two mutually exclusive sources:
//  - gt_cells: n * gt_width prebuilt bytes appended verbatim after "\tGT";
//  - gt_p0/gt_p1: n x gt_words packed bit-plane rows (GTC layout) with
//    gt_cols listing 2*n_gt_pairs haplotype columns; cells are generated
//    inline ("\t<c>/<c>" with code chars 0,1,.,2), which is the zero-copy
//    path for full-matrix dumps.
namespace {

struct EmitArgs {
    const char* chrom_bytes; const int64_t* chrom_off; const int32_t* chrom_len;
    const int64_t* pos1;
    const char* ref_bytes; const int64_t* ref_off; const int32_t* ref_len;
    const char* alt_bytes; const int64_t* alt_off; const int32_t* alt_len;
    const int32_t* n_allele; const int64_t* end_val;
    int32_t info_on; int32_t n_groups;
    const int64_t* an; const int64_t* ac; const int64_t* ac_m;
    const int64_t* gan; const int64_t* gac; const int64_t* gac_m;
    const char* gt_cells; int64_t gt_width;
    const uint32_t* gt_p0; const uint32_t* gt_p1; int64_t gt_words;
    const int32_t* gt_cols; int64_t n_gt_pairs;
};

// emit sites [lo, hi) into out_buf (cap out_cap); returns bytes or -1
int64_t emit_range(const EmitArgs& A, int64_t lo, int64_t hi,
                   char* out_buf, int64_t out_cap) {
    static const char code_char[4] = {'0', '1', '.', '2'};
    // identity-column fast path: one (plane0 byte, plane1 byte) lookup
    // emits 4 diploid "\tX/Y" text cells (16 bytes) at once
    static const char* kGtTextLut = [] {
        char* t = new char[65536 * 16];
        for (unsigned idx = 0; idx < 65536; ++idx) {
            unsigned b0 = idx & 0xff, b1 = idx >> 8;
            char* e = t + (size_t)idx * 16;
            for (int k = 0; k < 4; ++k) {
                unsigned c0 = ((b0 >> (2 * k)) & 1u) |
                              (((b1 >> (2 * k)) & 1u) << 1);
                unsigned c1 = ((b0 >> (2 * k + 1)) & 1u) |
                              (((b1 >> (2 * k + 1)) & 1u) << 1);
                e[k * 4 + 0] = '\t';
                e[k * 4 + 1] = code_char[c0];
                e[k * 4 + 2] = '/';
                e[k * 4 + 3] = code_char[c1];
            }
        }
        return t;
    }();
    bool gt_cols_identity = true;
    for (int64_t k = 0; k < 2 * A.n_gt_pairs; ++k)
        if (A.gt_cols && A.gt_cols[k] != k) {
            gt_cols_identity = false;
            break;
        }
    const char* chrom_bytes = A.chrom_bytes;
    const int64_t* chrom_off = A.chrom_off;
    const int32_t* chrom_len = A.chrom_len;
    const int64_t* pos1 = A.pos1;
    const char* ref_bytes = A.ref_bytes;
    const int64_t* ref_off = A.ref_off;
    const int32_t* ref_len = A.ref_len;
    const char* alt_bytes = A.alt_bytes;
    const int64_t* alt_off = A.alt_off;
    const int32_t* alt_len = A.alt_len;
    const int32_t* n_allele = A.n_allele;
    const int64_t* end_val = A.end_val;
    int32_t info_on = A.info_on;
    int32_t n_groups = A.n_groups;
    const int64_t* an = A.an;
    const int64_t* ac = A.ac;
    const int64_t* ac_m = A.ac_m;
    const int64_t* gan = A.gan;
    const int64_t* gac = A.gac;
    const int64_t* gac_m = A.gac_m;
    const char* gt_cells = A.gt_cells;
    int64_t gt_width = A.gt_width;
    const uint32_t* gt_p0 = A.gt_p0;
    const uint32_t* gt_p1 = A.gt_p1;
    int64_t gt_words = A.gt_words;
    const int32_t* gt_cols = A.gt_cols;
    int64_t n_gt_pairs = A.n_gt_pairs;
    if (gt_p0) gt_width = 4 * n_gt_pairs;
    char* p = out_buf;
    char* lim = out_buf + out_cap - 1;
    for (int64_t i = lo; i < hi; ++i) {
        // worst-case bound per line (numbers ~20B each)
        int64_t bound = chrom_len[i] + ref_len[i] + alt_len[i] + 64 +
                        (int64_t)(n_groups + 1) * 96 + (gt_width ? gt_width + 3 : 0);
        if (p + bound > lim) return -1;
        p = put_mem(p, chrom_bytes + chrom_off[i], chrom_len[i]);
        *p++ = '\t';
        p = put_int(p, pos1[i]);
        p = put_mem(p, "\t.\t", 3);
        p = put_mem(p, ref_bytes + ref_off[i], ref_len[i]);
        *p++ = '\t';
        p = put_mem(p, alt_bytes + alt_off[i], alt_len[i]);
        bool multi = n_allele[i] > 2;
        if (multi) p = put_mem(p, ",<M>", 4);
        p = put_mem(p, "\t0\t.\t", 5);
        bool any = false;
        if (end_val[i] >= 0) {
            p = put_mem(p, "END=", 4);
            p = put_int(p, end_val[i]);
            any = true;
        }
        if (info_on) {
            if (any) *p++ = ';';
            p = put_mem(p, "AN=", 3);
            p = put_int(p, an[i]);
            p = put_mem(p, ";AC=", 4);
            p = put_int(p, ac[i]);
            if (multi) {
                *p++ = ',';
                p = put_int(p, ac_m[i]);
            }
            for (int32_t g = 0; n_groups > 1 && g < n_groups; ++g) {
                p = put_mem(p, ";AN", 3);
                p = put_int(p, g + 1);
                *p++ = '=';
                p = put_int(p, gan[i * n_groups + g]);
                p = put_mem(p, ";AC", 3);
                p = put_int(p, g + 1);
                *p++ = '=';
                p = put_int(p, gac[i * n_groups + g]);
                if (multi) {
                    *p++ = ',';
                    p = put_int(p, gac_m[i * n_groups + g]);
                }
            }
            any = true;
        }
        if (!any) *p++ = '.';
        if (gt_cells) {
            p = put_mem(p, "\tGT", 3);
            p = put_mem(p, gt_cells + i * gt_width, gt_width);
        } else if (gt_p0) {
            p = put_mem(p, "\tGT", 3);
            const uint32_t* r0 = gt_p0 + i * gt_words;
            const uint32_t* r1 = gt_p1 + i * gt_words;
            if (gt_cols_identity) {
                int64_t nb = n_gt_pairs >> 2;  // 4 sample pairs per byte
                const uint8_t* b0 = (const uint8_t*)r0;
                const uint8_t* b1 = (const uint8_t*)r1;
                for (int64_t k = 0; k < nb; ++k) {
                    memcpy(p, kGtTextLut +
                               ((size_t)b0[k] | ((size_t)b1[k] << 8)) * 16,
                           16);
                    p += 16;
                }
                for (int64_t s = nb * 4; s < n_gt_pairs; ++s) {
                    uint32_t j0 = (uint32_t)(2 * s), j1 = j0 + 1;
                    unsigned c0 = ((r0[j0 >> 5] >> (j0 & 31)) & 1u) |
                                  (((r1[j0 >> 5] >> (j0 & 31)) & 1u) << 1);
                    unsigned c1 = ((r0[j1 >> 5] >> (j1 & 31)) & 1u) |
                                  (((r1[j1 >> 5] >> (j1 & 31)) & 1u) << 1);
                    *p++ = '\t';
                    *p++ = code_char[c0];
                    *p++ = '/';
                    *p++ = code_char[c1];
                }
            } else {
                for (int64_t s = 0; s < n_gt_pairs; ++s) {
                    uint32_t j0 = (uint32_t)gt_cols[2 * s];
                    uint32_t j1 = (uint32_t)gt_cols[2 * s + 1];
                    unsigned c0 = ((r0[j0 >> 5] >> (j0 & 31)) & 1u) |
                                  (((r1[j0 >> 5] >> (j0 & 31)) & 1u) << 1);
                    unsigned c1 = ((r0[j1 >> 5] >> (j1 & 31)) & 1u) |
                                  (((r1[j1 >> 5] >> (j1 & 31)) & 1u) << 1);
                    *p++ = '\t';
                    *p++ = code_char[c0];
                    *p++ = '/';
                    *p++ = code_char[c1];
                }
            }
        }
        *p++ = '\n';
    }
    return (int64_t)(p - out_buf);
}

}  // namespace

int64_t bgt_emit_vcf_lines(
    int64_t n,
    const char* chrom_bytes, const int64_t* chrom_off, const int32_t* chrom_len,
    const int64_t* pos1,
    const char* ref_bytes, const int64_t* ref_off, const int32_t* ref_len,
    const char* alt_bytes, const int64_t* alt_off, const int32_t* alt_len,
    const int32_t* n_allele, const int64_t* end_val,
    int32_t info_on, int32_t n_groups,
    const int64_t* an, const int64_t* ac, const int64_t* ac_m,
    const int64_t* gan, const int64_t* gac, const int64_t* gac_m,  // n x G
    const char* gt_cells, int64_t gt_width,
    const uint32_t* gt_p0, const uint32_t* gt_p1, int64_t gt_words,
    const int32_t* gt_cols, int64_t n_gt_pairs,
    char* out_buf, int64_t out_cap) {
    EmitArgs A{chrom_bytes, chrom_off, chrom_len, pos1,
               ref_bytes, ref_off, ref_len, alt_bytes, alt_off, alt_len,
               n_allele, end_val, info_on, n_groups, an, ac, ac_m,
               gan, gac, gac_m, gt_cells, gt_width,
               gt_p0, gt_p1, gt_words, gt_cols, n_gt_pairs};
    return emit_range(A, 0, n, out_buf, out_cap);
}

// Multithreaded variant: sites are split at chunk_bounds[0..n_chunks] and
// chunk c is emitted at out_buf + chunk_offs[c] (capacity = next offset or
// out_cap); chunk_lens[c] receives the bytes written (-1 on overflow).
// Returns 0, or -1 if any chunk overflowed.  The caller concatenates the
// chunk slices (scatter-gather) — no compaction pass over the ~GB output.
int64_t bgt_emit_vcf_lines_mt(
    int64_t n,
    const char* chrom_bytes, const int64_t* chrom_off, const int32_t* chrom_len,
    const int64_t* pos1,
    const char* ref_bytes, const int64_t* ref_off, const int32_t* ref_len,
    const char* alt_bytes, const int64_t* alt_off, const int32_t* alt_len,
    const int32_t* n_allele, const int64_t* end_val,
    int32_t info_on, int32_t n_groups,
    const int64_t* an, const int64_t* ac, const int64_t* ac_m,
    const int64_t* gan, const int64_t* gac, const int64_t* gac_m,
    const char* gt_cells, int64_t gt_width,
    const uint32_t* gt_p0, const uint32_t* gt_p1, int64_t gt_words,
    const int32_t* gt_cols, int64_t n_gt_pairs,
    char* out_buf, int64_t out_cap,
    int32_t n_chunks, const int64_t* chunk_bounds, const int64_t* chunk_offs,
    int64_t* chunk_lens) {
    EmitArgs A{chrom_bytes, chrom_off, chrom_len, pos1,
               ref_bytes, ref_off, ref_len, alt_bytes, alt_off, alt_len,
               n_allele, end_val, info_on, n_groups, an, ac, ac_m,
               gan, gac, gac_m, gt_cells, gt_width,
               gt_p0, gt_p1, gt_words, gt_cols, n_gt_pairs};
    (void)n;
    std::vector<std::thread> workers;
    workers.reserve(n_chunks);
    for (int32_t c = 0; c < n_chunks; ++c) {
        int64_t cap = (c + 1 < n_chunks ? chunk_offs[c + 1] : out_cap)
                      - chunk_offs[c];
        workers.emplace_back([&, c, cap]() {
            chunk_lens[c] = emit_range(A, chunk_bounds[c], chunk_bounds[c + 1],
                                       out_buf + chunk_offs[c], cap);
        });
    }
    for (auto& t : workers) t.join();
    for (int32_t c = 0; c < n_chunks; ++c)
        if (chunk_lens[c] < 0) return -1;
    return 0;
}

// ---------------------------------------------------------------------------
// VCF diploid GT section parser (import hot loop)
// ---------------------------------------------------------------------------

// Parse a tab-separated GT sample section of uniform 3-char diploid cells
// "a|b" / "a/b" / "." alleles into packed BCF GT bytes ((allele+1)<<1|phase,
// '.' -> phase bit only).  Returns the number of samples, or -1 when the
// section is irregular (caller falls back to the general parser).
int64_t bgt_parse_gt_cells(const char* s, int64_t len, int32_t n_allele,
                           uint8_t* out) {
    if (len % 4 != 3) return -1;
    int64_t n = (len + 1) / 4;
    for (int64_t i = 0; i < n; ++i) {
        const char* c = s + 4 * i;
        if (i + 1 < n && c[3] != '\t') return -1;
        char a1 = c[0], sep = c[1], a2 = c[2];
        unsigned phased;
        if (sep == '|') phased = 1;
        else if (sep == '/') phased = 0;
        else return -1;
        uint8_t x1, x2;
        if (a1 == '.') x1 = 0;
        else if (a1 >= '0' && a1 < '0' + n_allele) x1 = (uint8_t)((a1 - '0' + 1) << 1);
        else return -1;
        if (a2 == '.') x2 = (uint8_t)phased;
        else if (a2 >= '0' && a2 < '0' + n_allele)
            x2 = (uint8_t)(((a2 - '0' + 1) << 1) | phased);
        else return -1;
        out[2 * i] = x1;
        out[2 * i + 1] = x2;
    }
    return n;
}

// Translate packed BCF GT bytes through an allele map into 2-bit genotype
// codes (bcf_atom_gen_at's inner loop): c = (gt>>1)-1; c<0 -> 2 else tr[c].
// Returns 1 if any code 3 (<M>) was produced.
int32_t bgt_translate_gt(const uint8_t* gt, int64_t n, const uint8_t* tr,
                         int32_t n_allele, uint8_t* codes) {
    (void)n_allele;
    int32_t has_multi = 0;
    for (int64_t i = 0; i < n; ++i) {
        int c = (gt[i] >> 1) - 1;
        uint8_t v = c < 0 ? 2 : tr[c];
        codes[i] = v;
        has_multi |= (v == 3);
    }
    return has_multi;
}

const char* bgt_host_version(void) { return "bgt_host 0.1"; }

}  // extern "C"

// ---------------------------------------------------------------------------
// Columnar FMF scan: the annotation-query hot loop
// ---------------------------------------------------------------------------
//
// The reference streams `name<TAB>key:T:value...` rows and re-binds + re-
// evaluates a kexpr per row (fmf.c fms_read; tex/bgt.tex:214-217 reports a
// 100M-line scan dominating a 12s query).  Here the scan extracts only the
// keys an expression references into columnar arrays at parse speed; the
// expression then evaluates once, vectorized, on the Python side.
//
// Per requested key, per row: vtype (0=absent, 1=int, 2=real, 3=str),
// int64/double value, interned string id.  Token syntax mirrors the
// reference exactly: "key" alone = flag (binds nothing); "key:<t><any>v"
// with >=2 chars after ':' = typed, value starts 2 chars after the type
// char; 'i' -> strtol(,0), 'f' -> strtod, anything else -> string.  The
// LAST occurrence of a key in a row wins.

namespace {

struct SvHash {
    using is_transparent = void;
    size_t operator()(std::string_view s) const {
        return std::hash<std::string_view>{}(s);
    }
};

struct SvEq {
    using is_transparent = void;
    bool operator()(std::string_view a, std::string_view b) const {
        return a == b;
    }
};

struct FmfCol {
    std::vector<uint8_t> vtype;
    std::vector<int64_t> iv;
    std::vector<double> rv;
    std::vector<int32_t> sid;
    // transparent lookup: no per-token heap allocation on the hot path
    std::unordered_map<std::string, int32_t, SvHash, SvEq> intern;
    std::string uniq_cat;
    std::vector<int64_t> uniq_off;  // n_uniq + 1 offsets
};

struct FmfScan {
    int64_t n_rows = 0;
    std::string name_cat;
    std::vector<int64_t> name_off;
    std::vector<int32_t> name_len;
    std::vector<int64_t> line_off;  // uncompressed byte offset of each row
    std::vector<int32_t> line_len;
    std::vector<std::string> keys;
    std::vector<FmfCol> cols;
};

inline int32_t fmf_intern(FmfCol& c, const char* s, size_t n) {
    // annotation columns typically hold a handful of distinct values: a
    // linear memcmp scan beats hashing until the set grows (then the
    // transparent-lookup hash map takes over)
    if (c.uniq_off.empty()) c.uniq_off.push_back(0);
    size_t n_uniq = c.uniq_off.size() - 1;
    if (n_uniq <= 24 && c.intern.empty()) {
        const char* cat = c.uniq_cat.data();
        for (size_t i = 0; i < n_uniq; ++i) {
            size_t len = (size_t)(c.uniq_off[i + 1] - c.uniq_off[i]);
            if (len == n && memcmp(cat + c.uniq_off[i], s, n) == 0)
                return (int32_t)i;
        }
        if (n_uniq < 24) {
            c.uniq_cat.append(s, n);
            c.uniq_off.push_back((int64_t)c.uniq_cat.size());
            return (int32_t)n_uniq;
        }
        // overflow: seed the hash map from the linear set
        for (size_t i = 0; i < n_uniq; ++i)
            c.intern.emplace(
                std::string(c.uniq_cat.data() + c.uniq_off[i],
                            (size_t)(c.uniq_off[i + 1] - c.uniq_off[i])),
                (int32_t)i);
    }
    auto it = c.intern.find(std::string_view(s, n));
    if (it != c.intern.end()) return it->second;
    int32_t id = (int32_t)(c.uniq_off.size() - 1);
    c.intern.emplace(std::string(s, n), id);
    c.uniq_cat.append(s, n);
    c.uniq_off.push_back((int64_t)c.uniq_cat.size());
    return id;
}

// parse one line [p, p+len) (no trailing newline)
inline void fmf_scan_line(FmfScan* h, const char* p, size_t len, int64_t off) {
    size_t nk = h->keys.size();
    const char* end = p + len;
    const char* tab = (const char*)memchr(p, '\t', len);
    size_t name_n = tab ? (size_t)(tab - p) : len;
    h->name_off.push_back((int64_t)h->name_cat.size());
    h->name_cat.append(p, name_n);
    h->name_len.push_back((int32_t)name_n);
    h->line_off.push_back(off);
    h->line_len.push_back((int32_t)len);
    for (size_t k = 0; k < nk; ++k) {
        auto& c = h->cols[k];
        c.vtype.push_back(0);
        c.iv.push_back(0);
        c.rv.push_back(0.0);
        c.sid.push_back(-1);
    }
    const char* q = tab ? tab + 1 : end;
    while (q < end) {
        const char* t_end = (const char*)memchr(q, '\t', (size_t)(end - q));
        if (!t_end) t_end = end;
        const char* colon = (const char*)memchr(q, ':', (size_t)(t_end - q));
        size_t key_n = colon ? (size_t)(colon - q) : (size_t)(t_end - q);
        for (size_t k = 0; k < nk; ++k) {
            const std::string& key = h->keys[k];
            if (key.size() != key_n || memcmp(key.data(), q, key_n) != 0)
                continue;
            // typed only when >= 2 chars follow the colon (fmf.c token rule)
            if (colon && t_end - colon >= 3) {
                char tc = colon[1];
                const char* val = colon + 3;
                size_t val_n = (size_t)(t_end - val);
                auto& c = h->cols[k];
                size_t r = c.vtype.size() - 1;
                if (tc == 'i' || tc == 'f') {
                    char nbuf[64];  // NUL-terminate for strto* on the stack
                    size_t cn = val_n < 63 ? val_n : 63;
                    memcpy(nbuf, val, cn);
                    nbuf[cn] = 0;
                    if (tc == 'i') {
                        c.vtype[r] = 1;
                        c.iv[r] = strtol(nbuf, nullptr, 0);
                        c.rv[r] = (double)c.iv[r];
                    } else {
                        c.vtype[r] = 2;
                        c.rv[r] = strtod(nbuf, nullptr);
                        c.iv[r] = (int64_t)c.rv[r];
                    }
                } else {
                    c.vtype[r] = 3;
                    c.sid[r] = fmf_intern(c, val, val_n);
                }
            }
            break;
        }
        q = t_end + 1;
    }
    ++h->n_rows;
}

}  // namespace

extern "C" {

// merge a worker shard into dst (columns appended with string ids remapped
// through dst's intern tables; names/offsets concatenated)
void fmf_scan_merge(FmfScan* dst, FmfScan* src) {
    int64_t name_base = (int64_t)dst->name_cat.size();
    dst->name_cat += src->name_cat;
    dst->name_len.insert(dst->name_len.end(), src->name_len.begin(),
                         src->name_len.end());
    for (int64_t o : src->name_off) dst->name_off.push_back(o + name_base);
    dst->line_off.insert(dst->line_off.end(), src->line_off.begin(),
                         src->line_off.end());
    dst->line_len.insert(dst->line_len.end(), src->line_len.begin(),
                         src->line_len.end());
    for (size_t k = 0; k < dst->cols.size(); ++k) {
        auto& a = dst->cols[k];
        auto& b = src->cols[k];
        // remap src string ids into dst's intern space
        std::vector<int32_t> remap;
        if (!b.uniq_off.empty()) {
            size_t nb = b.uniq_off.size() - 1;
            remap.resize(nb);
            for (size_t i = 0; i < nb; ++i)
                remap[i] = fmf_intern(a, b.uniq_cat.data() + b.uniq_off[i],
                                      (size_t)(b.uniq_off[i + 1] - b.uniq_off[i]));
        }
        size_t base = a.vtype.size();
        a.vtype.insert(a.vtype.end(), b.vtype.begin(), b.vtype.end());
        a.iv.insert(a.iv.end(), b.iv.begin(), b.iv.end());
        a.rv.insert(a.rv.end(), b.rv.begin(), b.rv.end());
        a.sid.insert(a.sid.end(), b.sid.begin(), b.sid.end());
        for (size_t i = base; i < a.sid.size(); ++i)
            if (a.sid[i] >= 0) a.sid[i] = remap[(size_t)a.sid[i]];
    }
    dst->n_rows += src->n_rows;
}

// scan [beg, end) of a plain file (beg/end on line boundaries)
void fmf_scan_range(FmfScan* h, const char* path, int64_t beg, int64_t end) {
    FILE* fp = fopen(path, "rb");
    if (!fp) return;
    fseeko(fp, beg, SEEK_SET);
    size_t est = (size_t)((end - beg) / 32) + 16;
    h->name_off.reserve(est);
    h->name_len.reserve(est);
    h->line_off.reserve(est);
    h->line_len.reserve(est);
    h->name_cat.reserve((size_t)((end - beg) / 4) + 16);
    for (auto& c : h->cols) {
        c.vtype.reserve(est);
        c.iv.reserve(est);
        c.rv.reserve(est);
        c.sid.reserve(est);
    }
    std::vector<char> buf(1 << 22);
    size_t have = 0;
    int64_t base_off = beg;
    int64_t remaining = end - beg;
    for (;;) {
        size_t want = buf.size() - have;
        if ((int64_t)want > remaining) want = (size_t)remaining;
        long got = (long)fread(buf.data() + have, 1, want, fp);
        if (got < 0) break;
        remaining -= got;
        have += (size_t)got;
        size_t start = 0;
        for (;;) {
            const char* nl = (const char*)memchr(buf.data() + start, '\n',
                                                 have - start);
            if (!nl) break;
            size_t len = (size_t)(nl - (buf.data() + start));
            if (len)
                fmf_scan_line(h, buf.data() + start, len,
                              base_off + (int64_t)start);
            start = (size_t)(nl - buf.data()) + 1;
        }
        if (got == 0 || remaining == 0) {
            if (have > start)
                fmf_scan_line(h, buf.data() + start, have - start,
                              base_off + (int64_t)start);
            break;
        }
        if (start == 0 && have == buf.size()) {
            buf.resize(buf.size() * 2);
            continue;
        }
        memmove(buf.data(), buf.data() + start, have - start);
        base_off += (int64_t)start;
        have -= start;
    }
    fclose(fp);
}

// keys: n_keys NUL-separated key names; n_threads: parallel shards for
// plain files (<=1 sequential; sharded parsing wins on many-core hosts but
// the merge pass loses on 2-core boxes, so the caller chooses).
// Returns a scan handle or NULL.
void* bgt_fmf_scan(const char* path, const char* keys, int32_t n_keys,
                   int32_t n_threads) {
    // plain files read via fread (zlib's gz layer costs ~2x on uncompressed
    // input); gzip via gzread
    FILE* raw = fopen(path, "rb");
    if (!raw) return nullptr;
    int c0 = fgetc(raw), c1 = fgetc(raw);
    bool is_gz = (c0 == 0x1f && c1 == 0x8b);
    gzFile gz = nullptr;
    if (is_gz) {
        fclose(raw);
        raw = nullptr;
        gz = gzopen(path, "rb");
        if (!gz) return nullptr;
        gzbuffer(gz, 1 << 20);
    } else {
        rewind(raw);
    }
    auto* h = new FmfScan();
    const char* kp = keys;
    for (int32_t k = 0; k < n_keys; ++k) {
        h->keys.emplace_back(kp);
        kp += h->keys.back().size() + 1;
    }
    h->cols.resize(n_keys);
    if (!is_gz) {  // pre-size from the file length (~40 B/row estimate)
        fseeko(raw, 0, SEEK_END);
        int64_t sz = ftello(raw);
        rewind(raw);
        // large plain files scan in parallel shards split on line
        // boundaries; string ids are remapped at merge
        int n_shards = (sz > (16 << 20) && n_threads > 1)
                           ? (n_threads < 16 ? n_threads : 16) : 1;
        if (n_shards > 1) {
            std::vector<int64_t> bounds(n_shards + 1, 0);
            bounds[n_shards] = sz;
            char probe[1 << 16];
            for (int i = 1; i < n_shards; ++i) {
                int64_t target = sz * i / n_shards;
                fseeko(raw, target, SEEK_SET);
                size_t got = fread(probe, 1, sizeof probe, raw);
                const char* nl = (const char*)memchr(probe, '\n', got);
                bounds[i] = nl ? target + (nl - probe) + 1 : sz;
            }
            fclose(raw);
            bool mono = true;
            for (int i = 0; i < n_shards; ++i)
                if (bounds[i] > bounds[i + 1]) mono = false;
            if (mono) {
                std::vector<FmfScan> shards(n_shards);
                for (auto& sh : shards) {
                    sh.keys = h->keys;
                    sh.cols.resize(n_keys);
                }
                std::vector<std::thread> ts;
                for (int i = 0; i < n_shards; ++i)
                    ts.emplace_back(fmf_scan_range, &shards[i], path,
                                    bounds[i], bounds[i + 1]);
                for (auto& t : ts) t.join();
                for (auto& sh : shards) fmf_scan_merge(h, &sh);
                return h;
            }
            raw = fopen(path, "rb");  // fall back to the sequential scan
            if (!raw) {
                delete h;
                return nullptr;
            }
        }
        size_t est = (size_t)(sz / 32) + 16;
        h->name_off.reserve(est);
        h->name_len.reserve(est);
        h->line_off.reserve(est);
        h->line_len.reserve(est);
        h->name_cat.reserve((size_t)(sz / 4) + 16);
        for (auto& c : h->cols) {
            c.vtype.reserve(est);
            c.iv.reserve(est);
            c.rv.reserve(est);
            c.sid.reserve(est);
        }
    }
    std::vector<char> buf(1 << 22);
    size_t have = 0;
    int64_t base_off = 0;
    for (;;) {
        long got = is_gz
            ? (long)gzread(gz, buf.data() + have, (unsigned)(buf.size() - have))
            : (long)fread(buf.data() + have, 1, buf.size() - have, raw);
        if (got < 0) {
            if (gz) gzclose(gz);
            if (raw) fclose(raw);
            delete h;
            return nullptr;
        }
        have += (size_t)got;
        size_t start = 0;
        for (;;) {
            const char* nl = (const char*)memchr(buf.data() + start, '\n',
                                                 have - start);
            if (!nl) break;
            size_t len = (size_t)(nl - (buf.data() + start));
            if (len)
                fmf_scan_line(h, buf.data() + start, len,
                              base_off + (int64_t)start);
            start = (size_t)(nl - buf.data()) + 1;
        }
        if (got == 0) {  // EOF: flush a trailing unterminated line
            if (have > start)
                fmf_scan_line(h, buf.data() + start, have - start,
                              base_off + (int64_t)start);
            break;
        }
        if (start == 0 && have == buf.size()) {
            buf.resize(buf.size() * 2);  // one line longer than the buffer
            continue;
        }
        memmove(buf.data(), buf.data() + start, have - start);
        base_off += (int64_t)start;
        have -= start;
    }
    if (gz) gzclose(gz);
    if (raw) fclose(raw);
    return h;
}

int64_t bgt_fmf_scan_nrows(void* hv) { return ((FmfScan*)hv)->n_rows; }

void bgt_fmf_scan_names(void* hv, const char** cat, const int64_t** off,
                        const int32_t** len) {
    auto* h = (FmfScan*)hv;
    *cat = h->name_cat.data();
    *off = h->name_off.data();
    *len = h->name_len.data();
}

void bgt_fmf_scan_lines(void* hv, const int64_t** off, const int32_t** len) {
    auto* h = (FmfScan*)hv;
    *off = h->line_off.data();
    *len = h->line_len.data();
}

void bgt_fmf_scan_col(void* hv, int32_t k, const uint8_t** vtype,
                      const int64_t** iv, const double** rv,
                      const int32_t** sid) {
    auto& c = ((FmfScan*)hv)->cols[k];
    *vtype = c.vtype.data();
    *iv = c.iv.data();
    *rv = c.rv.data();
    *sid = c.sid.data();
}

int32_t bgt_fmf_scan_uniq(void* hv, int32_t k, const char** cat,
                          const int64_t** off) {
    auto& c = ((FmfScan*)hv)->cols[k];
    if (c.uniq_off.empty()) c.uniq_off.push_back(0);
    *cat = c.uniq_cat.data();
    *off = c.uniq_off.data();
    return (int32_t)(c.uniq_off.size() - 1);
}

void bgt_fmf_scan_free(void* hv) { delete (FmfScan*)hv; }

}  // extern "C"

// ---------------------------------------------------------------------------
// Batched allele-spec parsing (bgt_al_parse, reference bgt.c:975-1020)
// ---------------------------------------------------------------------------
//
// Canonicalizes "chr:1basedPos:refLenOrSeq:seq" specs (with left/right
// normalization against the optional ref sequence) into the key format
// "chr:pos:rlen:al" used by the allele-set hash.  The -d annotation path
// can select hundreds of thousands of alleles; parsing them per-Python-call
// dominated the join, so this runs the whole batch in one native pass.

namespace {

struct AlBatch {
    std::string key_cat;
    std::vector<int64_t> key_off;  // n+1
    std::vector<int64_t> pos;      // 0-based normalized position
    std::vector<int32_t> rlen;
    std::vector<int32_t> chrom_len;
};

inline bool al_parse_one(const char* s, size_t n, AlBatch& out) {
    const char* end = s + n;
    const char* colon = (const char*)memchr(s, ':', n);
    if (!colon) return false;
    size_t chrom_n = (size_t)(colon - s);
    const char* p = colon + 1;
    if (p >= end || !isdigit((unsigned char)*p)) return false;
    int64_t pos = 0;
    while (p < end && isdigit((unsigned char)*p)) pos = pos * 10 + (*p++ - '0');
    pos -= 1;
    if (p >= end || *p != ':') return false;
    ++p;
    const char* ref = nullptr;
    size_t ref_n = 0;
    int64_t rlen = -1;
    if (p < end && isdigit((unsigned char)*p)) {
        rlen = 0;
        while (p < end && isdigit((unsigned char)*p))
            rlen = rlen * 10 + (*p++ - '0');
    } else if (p < end && isalpha((unsigned char)*p)) {
        ref = p;
        while (p < end && isalpha((unsigned char)*p)) ++p;
        ref_n = (size_t)(p - ref);
        rlen = (int64_t)ref_n;
    } else if (p < end && *p == ':') {
        rlen = -1;
    }
    if (p >= end || *p != ':') return false;
    ++p;
    const char* alt_start = p;
    if (rlen < 0) {
        const char* q = alt_start;
        while (q < end && isalpha((unsigned char)*q)) ++q;
        rlen = (int64_t)(q - alt_start);
    }
    // left-normalize (case-insensitive) against ref
    size_t off = 0;
    while (p < end && isalpha((unsigned char)*p)) {
        if (ref && off < ref_n &&
            toupper((unsigned char)*p) == toupper((unsigned char)ref[off])) {
            ++off;
            ++p;
        } else {
            break;
        }
    }
    pos += (int64_t)off;
    rlen -= (int64_t)off;
    const char* alt = alt_start + off;
    size_t alt_n = (size_t)(end - alt);
    if (ref) {  // right-normalize
        const char* ref2 = ref + off;
        size_t ref2_n = ref_n - off;
        int64_t min_l = (int64_t)alt_n < rlen ? (int64_t)alt_n : rlen;
        int64_t off2 = 0;
        while (off2 < min_l && rlen - 1 - off2 < (int64_t)ref2_n &&
               isalpha((unsigned char)ref2[rlen - 1 - off2]) &&
               toupper((unsigned char)ref2[rlen - 1 - off2]) ==
                   toupper((unsigned char)alt[alt_n - 1 - (size_t)off2])) {
            ++off2;
        }
        rlen -= off2;
        alt_n -= (size_t)off2;
    }
    // emit "chrom:pos:rlen:al" (0-based pos: the internal hash-key form,
    // Allele.fmt in engine.py)
    char num[32];
    out.key_cat.append(s, chrom_n);
    out.key_cat.push_back(':');
    out.key_cat.append(num, (size_t)snprintf(num, sizeof num, "%lld",
                                             (long long)pos));
    out.key_cat.push_back(':');
    out.key_cat.append(num, (size_t)snprintf(num, sizeof num, "%lld",
                                             (long long)rlen));
    out.key_cat.push_back(':');
    out.key_cat.append(alt, alt_n);
    out.key_off.push_back((int64_t)out.key_cat.size());
    out.pos.push_back(pos);
    out.rlen.push_back((int32_t)rlen);
    out.chrom_len.push_back((int32_t)chrom_n);
    return true;
}

}  // namespace

extern "C" {

void* bgt_al_parse_batch(const char* cat, const int64_t* off,
                         const int32_t* len, int64_t n) {
    auto* b = new AlBatch();
    b->key_off.push_back(0);
    b->key_cat.reserve((size_t)n * 16);
    for (int64_t i = 0; i < n; ++i)
        al_parse_one(cat + off[i], (size_t)len[i], *b);
    return b;
}

int64_t bgt_al_batch_n(void* hv) {
    return (int64_t)((AlBatch*)hv)->pos.size();
}

void bgt_al_batch_data(void* hv, const char** key_cat, const int64_t** key_off,
                       const int64_t** pos, const int32_t** rlen,
                       const int32_t** chrom_len) {
    auto* b = (AlBatch*)hv;
    *key_cat = b->key_cat.data();
    *key_off = b->key_off.data();
    *pos = b->pos.data();
    *rlen = b->rlen.data();
    *chrom_len = b->chrom_len.data();
}

void bgt_al_batch_free(void* hv) { delete (AlBatch*)hv; }

}  // extern "C"

// ---------------------------------------------------------------------------
// Batched BCF record emission (the binary twin of bgt_emit_vcf_lines)
// ---------------------------------------------------------------------------
//
// Serializes output records of a single-database query straight from the
// columnar site arrays + packed genotype planes, mirroring the byte layout
// the engine's per-record writer produces (formats/bcf.py Bcf1.write +
// enc_* typed encoders; reference vcf.c:316-360, bcf_enc_*):
//   32B fixed header | shared: id(.)=0x07, alleles, FILTER(.)=0x00, INFO |
//   indiv: GT key + size2|INT8 + 2 bytes/sample (bgt_bits2gt).
// Import always writes ID="." and FILTER="." site records, which is what
// the text fastpath already relies on.

namespace {

inline char* benc_size(char* p, int64_t size, int btype) {
    if (size >= 15) {
        *p++ = (char)(15 << 4 | btype);
        if (size >= 128) {
            if (size >= 32768) {
                *p++ = (char)(1 << 4 | 3);
                memcpy(p, &size, 4);  // little-endian int32
                p += 4;
            } else {
                int16_t v = (int16_t)size;
                *p++ = (char)(1 << 4 | 2);
                memcpy(p, &v, 2);
                p += 2;
            }
        } else {
            *p++ = (char)(1 << 4 | 1);
            *p++ = (char)size;
        }
    } else {
        *p++ = (char)(size << 4 | btype);
    }
    return p;
}

inline char* benc_int1(char* p, int64_t x) {
    if (x == -2147483648LL) {
        p = benc_size(p, 1, 1);
        *p++ = (char)0x80;
    } else if (x > -128 && x <= 127) {
        p = benc_size(p, 1, 1);
        *p++ = (char)x;
    } else if (x > -32768 && x <= 32767) {
        int16_t v = (int16_t)x;
        p = benc_size(p, 1, 2);
        memcpy(p, &v, 2);
        p += 2;
    } else {
        int32_t v = (int32_t)x;
        p = benc_size(p, 1, 3);
        memcpy(p, &v, 4);
        p += 4;
    }
    return p;
}

inline char* benc_vint(char* p, const int64_t* vals, int n) {
    if (n == 0) return benc_size(p, 0, 0);
    if (n == 1) return benc_int1(p, vals[0]);
    int64_t vmax = -2147483647LL, vmin = 2147483647LL;
    for (int i = 0; i < n; ++i) {
        int64_t v = vals[i];
        if (v == -2147483648LL || v == -2147483647LL) continue;
        if (v > vmax) vmax = v;
        if (v < vmin) vmin = v;
    }
    if (vmax <= 127 && vmin > -127) {
        p = benc_size(p, n, 1);
        for (int i = 0; i < n; ++i) {
            int64_t v = vals[i];
            char b = v == -2147483647LL ? (char)0x81
                     : v == -2147483648LL ? (char)0x80 : (char)v;
            *p++ = b;
        }
    } else if (vmax <= 32767 && vmin > -32767) {
        p = benc_size(p, n, 2);
        for (int i = 0; i < n; ++i) {
            int64_t v = vals[i];
            int16_t b = v == -2147483647LL ? (int16_t)-32767
                        : v == -2147483648LL ? (int16_t)-32768 : (int16_t)v;
            memcpy(p, &b, 2);
            p += 2;
        }
    } else {
        p = benc_size(p, n, 3);
        for (int i = 0; i < n; ++i) {
            int32_t b = (int32_t)vals[i];
            memcpy(p, &b, 4);
            p += 4;
        }
    }
    return p;
}

}  // namespace

extern "C" {

int64_t bgt_emit_bcf_records(
    int64_t n,
    const int32_t* rid, const int64_t* pos, const int64_t* rlen,
    const char* ref_bytes, const int64_t* ref_off, const int32_t* ref_len,
    const char* alt_bytes, const int64_t* alt_off, const int32_t* alt_len,
    const int32_t* n_allele, const int64_t* end_val,
    int32_t info_on, int32_t n_groups,
    const int64_t* an, const int64_t* ac, const int64_t* ac_m,
    const int64_t* gan, const int64_t* gac, const int64_t* gac_m,
    int32_t end_id, int32_t an_id, int32_t ac_id,
    const int32_t* gan_ids, const int32_t* gac_ids,
    int32_t gt_id,
    const uint32_t* gt_p0, const uint32_t* gt_p1, int64_t gt_words,
    const int32_t* gt_cols, int64_t n_gt_pairs,
    char* out, int64_t cap) {
    static const char bits2gt[4] = {2, 4, 0, 6};
    // identity-column fast path: LUT mapping (plane0 byte, plane1 byte) ->
    // 8 GT bytes, one 64-bit store per 8 haplotype columns (the full-matrix
    // dump's gt_cols are consecutive whenever no sample is MGS-suppressed)
    static const uint64_t* kGtLut = [] {
        uint64_t* t = new uint64_t[65536];
        for (unsigned idx = 0; idx < 65536; ++idx) {
            unsigned b0 = idx & 0xff, b1 = idx >> 8;
            uint64_t v = 0;
            for (int k = 0; k < 8; ++k) {
                unsigned c = ((b0 >> k) & 1u) | (((b1 >> k) & 1u) << 1);
                v |= (uint64_t)(uint8_t)bits2gt[c] << (8 * k);
            }
            t[idx] = v;
        }
        return t;
    }();
    bool cols_identity = true;
    for (int64_t k = 0; k < 2 * n_gt_pairs; ++k)
        if (gt_cols && gt_cols[k] != k) {
            cols_identity = false;
            break;
        }
    char* p = out;
    char* lim = out + cap;
    for (int64_t i = 0; i < n; ++i) {
        int64_t bound = 32 + 16 + ref_len[i] + alt_len[i] + 16 +
                        (int64_t)(n_groups + 1) * 40 +
                        (n_gt_pairs ? 8 + 2 * n_gt_pairs : 0);
        if (p + bound > lim) return -1;
        char* hdr = p;  // 32-byte fixed header, lengths patched at the end
        p += 32;
        char* shared0 = p;
        *p++ = 0x07;  // id "." = empty CHAR vector
        p = benc_size(p, ref_len[i], 7);
        memcpy(p, ref_bytes + ref_off[i], ref_len[i]);
        p += ref_len[i];
        p = benc_size(p, alt_len[i], 7);
        memcpy(p, alt_bytes + alt_off[i], alt_len[i]);
        p += alt_len[i];
        bool multi = n_allele[i] > 2;
        if (multi) {
            p = benc_size(p, 3, 7);
            memcpy(p, "<M>", 3);
            p += 3;
        }
        *p++ = 0x00;  // FILTER "." = empty NULL vector
        int n_info = 0;
        if (end_val[i] >= 0) {
            p = benc_int1(p, end_id);
            p = benc_int1(p, end_val[i]);
            ++n_info;
        }
        if (info_on) {
            p = benc_int1(p, an_id);
            p = benc_int1(p, an[i]);
            ++n_info;
            p = benc_int1(p, ac_id);
            int64_t acv[2] = {ac[i], ac_m[i]};
            p = benc_vint(p, acv, multi ? 2 : 1);
            ++n_info;
            for (int32_t g = 0; n_groups > 1 && g < n_groups; ++g) {
                p = benc_int1(p, gan_ids[g]);
                p = benc_int1(p, gan[i * n_groups + g]);
                ++n_info;
                p = benc_int1(p, gac_ids[g]);
                int64_t gv[2] = {gac[i * n_groups + g],
                                 gac_m[i * n_groups + g]};
                p = benc_vint(p, gv, multi ? 2 : 1);
                ++n_info;
            }
        }
        int64_t l_shared = p - shared0;
        char* indiv0 = p;
        if (n_gt_pairs) {
            p = benc_int1(p, gt_id);
            p = benc_size(p, 2, 1);
            const uint32_t* r0 = gt_p0 + i * gt_words;
            const uint32_t* r1 = gt_p1 + i * gt_words;
            if (cols_identity) {
                int64_t total = 2 * n_gt_pairs;
                int64_t nb = total >> 3;
                const uint8_t* b0 = (const uint8_t*)r0;
                const uint8_t* b1 = (const uint8_t*)r1;
                for (int64_t k = 0; k < nb; ++k) {
                    uint64_t v =
                        kGtLut[(unsigned)b0[k] | ((unsigned)b1[k] << 8)];
                    memcpy(p, &v, 8);
                    p += 8;
                }
                for (int64_t j = nb * 8; j < total; ++j) {
                    unsigned c = ((r0[j >> 5] >> (j & 31)) & 1u) |
                                 (((r1[j >> 5] >> (j & 31)) & 1u) << 1);
                    *p++ = bits2gt[c];
                }
            } else {
                for (int64_t s = 0; s < n_gt_pairs; ++s) {
                    uint32_t j0 = (uint32_t)gt_cols[2 * s];
                    uint32_t j1 = (uint32_t)gt_cols[2 * s + 1];
                    unsigned c0 = ((r0[j0 >> 5] >> (j0 & 31)) & 1u) |
                                  (((r1[j0 >> 5] >> (j0 & 31)) & 1u) << 1);
                    unsigned c1 = ((r0[j1 >> 5] >> (j1 & 31)) & 1u) |
                                  (((r1[j1 >> 5] >> (j1 & 31)) & 1u) << 1);
                    *p++ = bits2gt[c0];
                    *p++ = bits2gt[c1];
                }
            }
        }
        int64_t l_indiv = p - indiv0;
        uint32_t h0 = (uint32_t)(l_shared + 24);
        uint32_t h1 = (uint32_t)l_indiv;
        int32_t v32;
        memcpy(hdr, &h0, 4);
        memcpy(hdr + 4, &h1, 4);
        v32 = rid[i];
        memcpy(hdr + 8, &v32, 4);
        v32 = (int32_t)pos[i];
        memcpy(hdr + 12, &v32, 4);
        v32 = (int32_t)rlen[i];
        memcpy(hdr + 16, &v32, 4);
        uint32_t qual_bits = 0;
        memcpy(hdr + 20, &qual_bits, 4);
        uint32_t nai = ((uint32_t)n_allele[i] << 16) | (uint32_t)n_info;
        memcpy(hdr + 24, &nai, 4);
        uint32_t nfs = n_gt_pairs
                           ? ((1u << 24) | (uint32_t)n_gt_pairs)
                           : 0u;
        memcpy(hdr + 28, &nfs, 4);
    }
    return p - out;
}

}  // extern "C"

// Multithreaded BCF record emission: chunk c of sites emits at
// out + chunk_offs[c]; the caller concatenates the slices (same scheme as
// bgt_emit_vcf_lines_mt).
extern "C" int64_t bgt_emit_bcf_records_mt(
    int64_t n,
    const int32_t* rid, const int64_t* pos, const int64_t* rlen,
    const char* ref_bytes, const int64_t* ref_off, const int32_t* ref_len,
    const char* alt_bytes, const int64_t* alt_off, const int32_t* alt_len,
    const int32_t* n_allele, const int64_t* end_val,
    int32_t info_on, int32_t n_groups,
    const int64_t* an, const int64_t* ac, const int64_t* ac_m,
    const int64_t* gan, const int64_t* gac, const int64_t* gac_m,
    int32_t end_id, int32_t an_id, int32_t ac_id,
    const int32_t* gan_ids, const int32_t* gac_ids,
    int32_t gt_id,
    const uint32_t* gt_p0, const uint32_t* gt_p1, int64_t gt_words,
    const int32_t* gt_cols, int64_t n_gt_pairs,
    char* out, int64_t cap,
    int32_t n_chunks, const int64_t* chunk_bounds, const int64_t* chunk_offs,
    int64_t* chunk_lens) {
    (void)n;
    std::vector<std::thread> ts;
    ts.reserve(n_chunks);
    for (int32_t c = 0; c < n_chunks; ++c) {
        int64_t lo = chunk_bounds[c], hi = chunk_bounds[c + 1];
        int64_t off = chunk_offs[c];
        int64_t ccap = (c + 1 < n_chunks ? chunk_offs[c + 1] : cap) - off;
        ts.emplace_back([=]() {
            chunk_lens[c] = bgt_emit_bcf_records(
                hi - lo, rid + lo, pos + lo, rlen + lo,
                ref_bytes, ref_off + lo, ref_len + lo,
                alt_bytes, alt_off + lo, alt_len + lo,
                n_allele + lo, end_val + lo, info_on, n_groups,
                an + lo, ac + lo, ac_m + lo,
                gan ? gan + lo * n_groups : nullptr,
                gac ? gac + lo * n_groups : nullptr,
                gac_m ? gac_m + lo * n_groups : nullptr,
                end_id, an_id, ac_id, gan_ids, gac_ids, gt_id,
                gt_p0 ? gt_p0 + lo * gt_words : nullptr,
                gt_p1 ? gt_p1 + lo * gt_words : nullptr,
                gt_words, gt_cols, n_gt_pairs, out + off, ccap);
        });
    }
    for (auto& t : ts) t.join();
    for (int32_t c = 0; c < n_chunks; ++c)
        if (chunk_lens[c] < 0) return -1;
    return 0;
}

// ---------------------------------------------------------------------------
// Native site-BCF scan: columnar (rid, pos, rlen, n_allele, REF, ALT1)
// arrays for SiteTable's one-time first scan (bgt_tpu/query/fastpath.py).
// Replaces the per-record Python Bcf1.read loop, which at reference scale
// (39.2M sites, tex/bgt.tex:187) costs hours vs seconds here.
// ---------------------------------------------------------------------------

namespace {

// sequential BGZF (blocked-gzip) reader: raw-deflate blocks framed per
// the htslib spec (reference bgzf.c:318-379)
struct BgzfSeq {
    FILE* fp = nullptr;
    std::vector<uint8_t> buf;
    size_t pos = 0;
    bool eof = false;

    bool fill() {
        uint8_t hdr[12];
        size_t got = fread(hdr, 1, 12, fp);
        if (got == 0) {
            eof = true;
            return false;
        }
        if (got != 12 || hdr[0] != 0x1f || hdr[1] != 0x8b) return false;
        int xlen = hdr[10] | hdr[11] << 8;
        std::vector<uint8_t> extra(xlen);
        if ((int)fread(extra.data(), 1, xlen, fp) != xlen) return false;
        int bsize = -1;
        for (int i = 0; i + 4 <= xlen;) {
            int slen = extra[i + 2] | extra[i + 3] << 8;
            if (extra[i] == 'B' && extra[i + 1] == 'C' && slen == 2)
                bsize = (extra[i + 4] | extra[i + 5] << 8) + 1;
            i += 4 + slen;
        }
        if (bsize < 0) return false;
        // block = 12-byte gzip header + XLEN extra + CDATA + CRC32 + ISIZE
        int cdata_len = bsize - xlen - 20;
        if (cdata_len < 0) return false;
        std::vector<uint8_t> cdata(cdata_len);
        if ((int)fread(cdata.data(), 1, cdata_len, fp) != cdata_len)
            return false;
        uint8_t tail[8];
        if (fread(tail, 1, 8, fp) != 8) return false;
        uint32_t isize = tail[4] | tail[5] << 8 | tail[6] << 16 |
                         (uint32_t)tail[7] << 24;
        if (pos > 0) {
            buf.erase(buf.begin(), buf.begin() + pos);
            pos = 0;
        }
        size_t old = buf.size();
        buf.resize(old + isize);
        if (isize) {
            z_stream zs{};
            if (inflateInit2(&zs, -15) != Z_OK) return false;
            zs.next_in = cdata.data();
            zs.avail_in = cdata_len;
            zs.next_out = buf.data() + old;
            zs.avail_out = isize;
            int r = inflate(&zs, Z_FINISH);
            inflateEnd(&zs);
            if (r != Z_STREAM_END) return false;
        }
        return true;
    }

    // ensure n bytes available at buf[pos..]; false on clean EOF with 0
    // available, error state otherwise checked by caller via avail()
    bool want(size_t n) {
        while (buf.size() - pos < n) {
            if (!fill()) return false;
        }
        return true;
    }

    size_t avail() const { return buf.size() - pos; }
};

struct SiteScanResult {
    std::vector<int32_t> rid, nal;
    std::vector<int64_t> pos, rlen, ref_len, alt_len;
    std::vector<uint8_t> ref_cat, alt_cat;
    int64_t n = 0;
};

// typed-value size descriptor (vcf.c typed encoding): returns false on
// malformed input; advances off past the descriptor
bool dec_size(const uint8_t* b, size_t len, size_t& off, uint32_t& sz,
              int& btype) {
    if (off >= len) return false;
    btype = b[off] & 0xF;
    uint32_t s = b[off] >> 4;
    ++off;
    if (s != 15) {
        sz = s;
        return true;
    }
    if (off >= len) return false;
    int t2 = b[off] & 0xF;
    uint32_t s2 = b[off] >> 4;
    ++off;
    (void)s2;
    if (t2 == 1) {
        if (off + 1 > len) return false;
        sz = b[off];
        off += 1;
    } else if (t2 == 2) {
        if (off + 2 > len) return false;
        sz = b[off] | b[off + 1] << 8;
        off += 2;
    } else if (t2 == 3) {
        if (off + 4 > len) return false;
        sz = b[off] | b[off + 1] << 8 | b[off + 2] << 16 |
             (uint32_t)b[off + 3] << 24;
        off += 4;
    } else {
        return false;
    }
    return true;
}

const int kTypeShift[16] = {0, 0, 1, 2, 0, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};

}  // namespace

extern "C" {

void* bgt_site_scan(const char* path) {
    FILE* fp = fopen(path, "rb");
    if (!fp) return nullptr;
    BgzfSeq in;
    in.fp = fp;
    auto fail = [&]() -> void* {
        fclose(fp);
        return nullptr;
    };
    if (!in.want(9)) return fail();
    const uint8_t* p = in.buf.data() + in.pos;
    if (memcmp(p, "BCF\2\2", 5) != 0) return fail();
    uint32_t l_text = p[5] | p[6] << 8 | p[7] << 16 | (uint32_t)p[8] << 24;
    in.pos += 9;
    // skip the header text (may span many blocks)
    {
        size_t left = l_text;
        while (left) {
            if (in.avail() == 0 && !in.fill()) return fail();
            size_t take = std::min(left, in.avail());
            in.pos += take;
            left -= take;
        }
    }
    auto* res = new SiteScanResult();
    std::vector<uint8_t> shared;
    for (;;) {
        if (!in.want(32)) {
            if (in.avail() == 0 && in.eof) break;  // clean EOF
            delete res;
            return fail();
        }
        const uint8_t* h = in.buf.data() + in.pos;
        uint32_t l_shared, l_indiv;
        int32_t rid, posv, rlenv;
        uint32_t w6, w7;
        memcpy(&l_shared, h, 4);
        memcpy(&l_indiv, h + 4, 4);
        memcpy(&rid, h + 8, 4);
        memcpy(&posv, h + 12, 4);
        memcpy(&rlenv, h + 16, 4);
        memcpy(&w6, h + 24, 4);
        memcpy(&w7, h + 28, 4);
        (void)w7;
        if (l_shared < 24) {
            delete res;
            return fail();
        }
        l_shared -= 24;
        in.pos += 32;
        uint32_t n_allele = w6 >> 16;
        if (!in.want(l_shared + l_indiv)) {
            delete res;
            return fail();
        }
        shared.assign(in.buf.data() + in.pos,
                      in.buf.data() + in.pos + l_shared);
        in.pos += l_shared + l_indiv;
        // parse: ID (skip), REF, ALT1 (bcf_get_ref_alt1, vcf.c:1129-1142)
        size_t off = 0;
        uint32_t sz;
        int t;
        if (!dec_size(shared.data(), shared.size(), off, sz, t)) {
            delete res;
            return fail();
        }
        off += (size_t)sz << kTypeShift[t];
        size_t ref_start;
        uint32_t ref_sz = 0, alt_sz = 0;
        if (!dec_size(shared.data(), shared.size(), off, sz, t) ||
            off + ((size_t)sz << kTypeShift[t]) > shared.size()) {
            delete res;
            return fail();
        }
        ref_sz = sz;
        ref_start = off;
        off += (size_t)sz << kTypeShift[t];
        size_t alt_start = off;
        if (n_allele > 1) {
            if (!dec_size(shared.data(), shared.size(), off, sz, t) ||
                off + ((size_t)sz << kTypeShift[t]) > shared.size()) {
                delete res;
                return fail();
            }
            alt_sz = sz;
            alt_start = off;
        }
        res->rid.push_back(rid);
        res->pos.push_back(posv);
        res->rlen.push_back(rlenv);
        res->nal.push_back((int32_t)n_allele);
        res->ref_len.push_back(ref_sz);
        res->alt_len.push_back(alt_sz);
        res->ref_cat.insert(res->ref_cat.end(), shared.data() + ref_start,
                            shared.data() + ref_start + ref_sz);
        res->alt_cat.insert(res->alt_cat.end(), shared.data() + alt_start,
                            shared.data() + alt_start + alt_sz);
        ++res->n;
    }
    fclose(fp);
    return res;
}

int64_t bgt_site_scan_n(void* h) { return ((SiteScanResult*)h)->n; }

void bgt_site_scan_data(void* h, void** rid, void** pos, void** rlen,
                        void** nal, void** ref_len, void** alt_len,
                        void** ref_cat, int64_t* ref_cat_len, void** alt_cat,
                        int64_t* alt_cat_len) {
    auto* r = (SiteScanResult*)h;
    *rid = r->rid.data();
    *pos = r->pos.data();
    *rlen = r->rlen.data();
    *nal = r->nal.data();
    *ref_len = r->ref_len.data();
    *alt_len = r->alt_len.data();
    *ref_cat = r->ref_cat.data();
    *ref_cat_len = (int64_t)r->ref_cat.size();
    *alt_cat = r->alt_cat.data();
    *alt_cat_len = (int64_t)r->alt_cat.size();
}

void bgt_site_scan_free(void* h) { delete (SiteScanResult*)h; }

}  // extern "C"

// ---------------------------------------------------------------------------
// Native text-VCF importer: parse + atomize + site-BCF/PBF emission in one
// C++ pass (reference import.c:8-120 + atomic.c).  Python handles header
// construction, .spl, and the CSI index; on any input anomaly this returns
// a negative code and the caller falls back to the pure-Python importer.
// Byte-compatibility contracts: site .bcf records mirror
// bgt_tpu/core/atomize.py:atom_to_bcf + Bcf1.append_info_ints, BGZF blocks
// mirror bgt_tpu/io/bgzf.py (0xff00 payload blocks, raw deflate), .pbf
// mirrors the streaming writer above.
// ---------------------------------------------------------------------------

namespace {

// BGZF writer with the exact python BgzfWriter framing
struct BgzfOut {
    FILE* fp = nullptr;
    int level = -1;
    std::vector<uint8_t> buf;   // pending uncompressed payload
    uint64_t block_address = 0; // compressed offset of the filling block
    std::vector<uint8_t> cbuf;

    static constexpr size_t kBlock = 0xFF00;

    // --- async mode: a worker thread deflates + writes queued payload
    // blocks in order, taking the dominant zlib cost off the emit thread
    // (the consumer was deflate-bound at site-heavy shapes: 1x39.2M rows
    // spent ~2.5 s of its 4.2 s in deflate).  Virtual
    // offsets are provisional while async (payload-block INDEX << 16 |
    // within-block offset) because compressed block sizes are not known
    // yet; remap_voffs() rewrites them to real BGZF virtual offsets after
    // close() using the recorded per-block compressed sizes.  The byte
    // stream is identical to sync mode (same payload split, same order).
    bool async = false;
    std::thread worker;
    std::mutex mu;
    std::condition_variable cv_put, cv_space;
    std::deque<std::vector<uint8_t>> jobs;
    bool done = false, werr = false;
    uint64_t n_submitted = 0;      // payload blocks handed to the worker
    std::vector<uint64_t> bsizes;  // compressed size of each written block
    static constexpr size_t kMaxJobs = 32;

    void start_async() {
        async = true;
        worker = std::thread([this] { worker_main(); });
    }

    void worker_main() {
        std::vector<uint8_t> job;
        for (;;) {
            {
                std::unique_lock<std::mutex> lk(mu);
                cv_put.wait(lk, [&] { return !jobs.empty() || done; });
                if (jobs.empty()) return;
                job = std::move(jobs.front());
                jobs.pop_front();
                cv_space.notify_all();
            }
            uint64_t before = block_address;
            bool ok;
            {
                // deflate outside the lock; flush_one_payload only touches
                // worker-owned state (fp, cbuf, block_address)
                ok = flush_one_payload(job.data(), job.size());
            }
            std::lock_guard<std::mutex> lk(mu);
            if (!ok) {
                werr = true;
                cv_space.notify_all();
                return;
            }
            bsizes.push_back(block_address - before);
        }
    }

    // compress+write one payload block (worker thread in async mode, the
    // caller in sync mode); does not touch `buf`
    bool flush_one_payload(const uint8_t* data, size_t n) {
        static const uint8_t kHdr[16] = {0x1f, 0x8b, 0x08, 0x04, 0, 0, 0, 0,
                                         0,    0xff, 0x06, 0,    'B', 'C', 2, 0};
        cbuf.resize(compressBound(n) + 64);
        z_stream zs{};
        int lv = (level < 0 || level > 9) ? Z_DEFAULT_COMPRESSION : level;
        if (deflateInit2(&zs, lv, Z_DEFLATED, -15, 8, Z_DEFAULT_STRATEGY) !=
            Z_OK)
            return false;
        zs.next_in = const_cast<uint8_t*>(data);
        zs.avail_in = n;
        zs.next_out = cbuf.data();
        zs.avail_out = cbuf.size();
        int r = deflate(&zs, Z_FINISH);
        size_t clen = zs.total_out;
        deflateEnd(&zs);
        if (r != Z_STREAM_END) return false;
        uint32_t crc = crc32(0, data, n);
        uint16_t bsize = (uint16_t)(clen + 18 + 8 - 1);
        uint32_t isize = (uint32_t)n;
        if (fwrite(kHdr, 1, 16, fp) != 16) return false;
        if (fwrite(&bsize, 2, 1, fp) != 1) return false;
        if (fwrite(cbuf.data(), 1, clen, fp) != clen) return false;
        if (fwrite(&crc, 4, 1, fp) != 1) return false;
        if (fwrite(&isize, 4, 1, fp) != 1) return false;
        block_address += clen + 18 + 8;
        return true;
    }

    // hand one payload block to the worker (async mode)
    bool submit(std::vector<uint8_t>&& job) {
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] { return jobs.size() < kMaxJobs || werr; });
        if (werr) return false;
        jobs.push_back(std::move(job));
        ++n_submitted;
        cv_put.notify_one();
        return true;
    }

    // drain + stop the worker; false if it hit a write error
    bool stop_async() {
        if (!async) return true;
        {
            std::lock_guard<std::mutex> lk(mu);
            done = true;
            cv_put.notify_one();
        }
        worker.join();
        async = false;
        return !werr;
    }

    // block start offsets for rewriting provisional async voffs (payload
    // block index << 16 | within) into real BGZF virtual offsets; valid
    // after close()
    std::vector<uint64_t> block_starts() const {
        std::vector<uint64_t> starts(bsizes.size() + 1);
        starts[0] = 0;
        for (size_t i = 0; i < bsizes.size(); ++i)
            starts[i + 1] = starts[i] + bsizes[i];
        return starts;
    }

    bool flush_one(size_t n) {
        if (!flush_one_payload(buf.data(), n)) return false;
        buf.erase(buf.begin(), buf.begin() + n);
        return true;
    }

    bool write(const void* data, size_t n) {
        const uint8_t* p = (const uint8_t*)data;
        buf.insert(buf.end(), p, p + n);
        if (async) {
            size_t off = 0;
            while (buf.size() - off >= kBlock) {
                if (!submit(std::vector<uint8_t>(
                        buf.begin() + off, buf.begin() + off + kBlock)))
                    return false;
                off += kBlock;
            }
            if (off) buf.erase(buf.begin(), buf.begin() + off);
            return true;
        }
        while (buf.size() >= kBlock)
            if (!flush_one(kBlock)) return false;
        return true;
    }

    uint64_t vtell() const {
        // async: provisional (payload-block index, within) pair — see
        // remap_voffs; buf.size() < kBlock = 0xFF00 so it fits 16 bits
        if (async)
            return (n_submitted << 16) | (buf.size() & 0xFFFF);
        return (block_address << 16) | (buf.size() & 0xFFFF);
    }

    bool close() {
        static const uint8_t kEof[28] = {
            0x1f, 0x8b, 0x08, 0x04, 0, 0,    0, 0, 0, 0xff, 0x06, 0, 'B', 'C',
            2,    0,    0x1b, 0,    3, 0,    0, 0, 0, 0,    0,    0, 0,   0};
        bool ok = true;
        if (async) {
            size_t off = 0;
            while (ok && buf.size() - off > 0) {
                size_t n = std::min(buf.size() - off, kBlock);
                ok = submit(std::vector<uint8_t>(
                    buf.begin() + off, buf.begin() + off + n));
                off += n;
            }
            buf.clear();
            if (!stop_async()) ok = false;
        } else {
            while (ok && !buf.empty())
                ok = flush_one(std::min(buf.size(), kBlock));
        }
        if (ok) ok = fwrite(kEof, 1, 28, fp) == 28;
        // always release the FILE*, success or not (a failed flush must
        // not leak the fd — long-lived servers retry imports)
        if (fclose(fp) != 0) ok = false;
        fp = nullptr;
        return ok;
    }

    ~BgzfOut() {
        if (async) stop_async();
    }
};

// typed-value encoders mirroring bgt_tpu/formats/bcf.py
inline void enc_size_c(std::vector<uint8_t>& o, uint32_t size, int btype) {
    if (size >= 15) {
        o.push_back(15 << 4 | btype);
        if (size >= 32768) {
            o.push_back(1 << 4 | 3);
            int32_t v = (int32_t)size;
            o.insert(o.end(), (uint8_t*)&v, (uint8_t*)&v + 4);
        } else if (size >= 128) {
            o.push_back(1 << 4 | 2);
            int16_t v = (int16_t)size;
            o.insert(o.end(), (uint8_t*)&v, (uint8_t*)&v + 2);
        } else {
            o.push_back(1 << 4 | 1);
            o.push_back((uint8_t)size);
        }
    } else {
        o.push_back(size << 4 | btype);
    }
}

inline void enc_int1_c(std::vector<uint8_t>& o, int64_t x) {
    if (x > -128 && x <= 127) {
        enc_size_c(o, 1, 1);
        o.push_back((uint8_t)x);
    } else if (x > -32768 && x <= 32767) {
        enc_size_c(o, 1, 2);
        int16_t v = (int16_t)x;
        o.insert(o.end(), (uint8_t*)&v, (uint8_t*)&v + 2);
    } else {
        enc_size_c(o, 1, 3);
        int32_t v = (int32_t)x;
        o.insert(o.end(), (uint8_t*)&v, (uint8_t*)&v + 4);
    }
}

inline void enc_vchar_c(std::vector<uint8_t>& o, const std::string& s) {
    enc_size_c(o, (uint32_t)s.size(), 7);
    o.insert(o.end(), s.begin(), s.end());
}

struct CAtom {
    int32_t rid = 0;
    int64_t pos = 0, rlen = 0;
    int32_t anum = 0;
    std::string ref, alt;
    bool from_new = true, has_multi = false;
    std::vector<uint8_t> gt;

    bool key_eq(const CAtom& b) const {
        return rid == b.rid && pos == b.pos && rlen == b.rlen && alt == b.alt;
    }
};

inline bool atom_less(const CAtom& a, const CAtom& b) {
    if (a.rid != b.rid) return a.rid < b.rid;
    if (a.pos != b.pos) return a.pos < b.pos;
    if (a.rlen != b.rlen) return a.rlen < b.rlen;
    if (a.alt != b.alt) return a.alt < b.alt;
    return a.from_new < b.from_new;  // old before new (bcf_atom_cmp2)
}

// one parsed input record (only what the atomizer consumes)
struct VRec {
    int32_t rid;
    int64_t pos, rlen;
    std::vector<std::string> alleles;  // [0]=ref
    std::vector<std::string> cigars;   // per ALT when INFO/CIGAR present
    std::vector<int8_t> gta;           // 2*n_samples allele indices, -1=missing
};

struct ImportCtx {
    int32_t n_samples = 0;
    bool cigar_defined = false, end_defined = false;
    std::unordered_map<std::string, int32_t> contig_id;
    std::unordered_map<std::string, int32_t> filter_id;
    int err = 0;  // sticky parse-anomaly flag -> python fallback
};

// gzFile line reader (plain or gzip text)
struct LineReader {
    gzFile gz = nullptr;
    std::vector<char> buf;
    size_t pos = 0, len = 0;
    bool eof = false;
    bool error = false;  // stream error/truncation: NOT a clean EOF

    bool getline(std::string& out) {
        out.clear();
        for (;;) {
            if (pos == len) {
                if (eof) return !out.empty();
                buf.resize(1 << 20);
                int n = gzread(gz, buf.data(), buf.size());
                if (n < 0) {
                    error = true;
                    return false;
                }
                if (n == 0) {
                    // distinguish clean EOF from a truncated gzip stream
                    int errnum = 0;
                    gzerror(gz, &errnum);
                    if (errnum != Z_OK || !gzeof(gz)) error = true;
                    eof = true;
                    return !out.empty();
                }
                len = (size_t)n;
                pos = 0;
            }
            char* start = buf.data() + pos;
            char* nl = (char*)memchr(start, '\n', len - pos);
            if (nl) {
                out.append(start, nl - start);
                pos = nl - buf.data() + 1;
                return true;
            }
            out.append(start, len - pos);
            pos = len;
        }
    }
};

bool parse_vrec(ImportCtx& C, const std::string& line, VRec& r,
                bool& skip_filtered) {
    r.alleles.clear();
    r.cigars.clear();
    r.gta.clear();
    skip_filtered = false;
    // split the 9 fixed columns
    const char* s = line.c_str();
    const char* end = s + line.size();
    const char* col[10];
    size_t cl[10];
    int nc = 0;
    const char* p = s;
    while (nc < 9 && p <= end) {
        const char* t = (const char*)memchr(p, '\t', end - p);
        if (!t) t = end;
        col[nc] = p;
        cl[nc] = t - p;
        ++nc;
        p = t < end ? t + 1 : end + 1;
    }
    if (nc < 8) return false;
    col[9] = p <= end ? p : end;  // sample section
    std::string chrom(col[0], cl[0]);
    auto it = C.contig_id.find(chrom);
    if (it == C.contig_id.end()) return false;  // unknown contig -> fallback
    r.rid = it->second;
    {
        int64_t v = 0;
        for (size_t i = 0; i < cl[1]; ++i) {
            if (!isdigit((unsigned char)col[1][i])) return false;
            v = v * 10 + (col[1][i] - '0');
        }
        r.pos = v - 1;
    }
    r.alleles.emplace_back(col[3], cl[3]);
    r.rlen = (int64_t)cl[3];
    if (!(cl[4] == 1 && col[4][0] == '.')) {
        const char* a = col[4];
        const char* ae = a + cl[4];
        while (a < ae) {
            const char* c = (const char*)memchr(a, ',', ae - a);
            if (!c) c = ae;
            r.alleles.emplace_back(a, c - a);
            a = c + 1;
        }
    }
    // FILTER: filtered unless "." or exactly one defined token with id 0
    if (!(cl[6] == 1 && col[6][0] == '.')) {
        const char* f = col[6];
        size_t flen = cl[6];
        if (flen && f[flen - 1] == ';') --flen;
        const char* fe = f + flen;
        int n_flt = 0;
        bool pass_only = true;
        while (f < fe) {
            const char* c = (const char*)memchr(f, ';', fe - f);
            if (!c) c = fe;
            auto fit = C.filter_id.find(std::string(f, c - f));
            if (fit != C.filter_id.end()) {
                ++n_flt;
                if (fit->second != 0) pass_only = false;
            }
            f = c + 1;
        }
        skip_filtered = n_flt > 0 && !(n_flt == 1 && pass_only);
    }
    // INFO: END= and CIGAR=
    if (nc > 7 && !(cl[7] == 1 && col[7][0] == '.')) {
        const char* i = col[7];
        size_t ilen = cl[7];
        if (ilen && i[ilen - 1] == ';') --ilen;
        const char* ie = i + ilen;
        while (i < ie) {
            const char* c = (const char*)memchr(i, ';', ie - i);
            if (!c) c = ie;
            const char* eq = (const char*)memchr(i, '=', c - i);
            if (eq) {
                size_t kl = eq - i;
                if (C.end_defined && kl == 3 && memcmp(i, "END", 3) == 0) {
                    int64_t v = 0;
                    for (const char* q = eq + 1; q < c; ++q) {
                        if (!isdigit((unsigned char)*q)) return false;
                        v = v * 10 + (*q - '0');
                    }
                    r.rlen = v - r.pos;
                } else if (C.cigar_defined && kl == 5 &&
                           memcmp(i, "CIGAR", 5) == 0) {
                    const char* a = eq + 1;
                    while (a < c) {
                        const char* cc = (const char*)memchr(a, ',', c - a);
                        if (!cc) cc = c;
                        r.cigars.emplace_back(a, cc - a);
                        a = cc + 1;
                    }
                }
            }
            i = c + 1;
        }
    }
    // FORMAT: locate the GT subfield
    if (nc < 9 || C.n_samples <= 0) return false;
    int gt_idx = -1;
    {
        const char* f = col[8];
        const char* fe = f + cl[8];
        int idx = 0;
        while (f < fe) {
            const char* c = (const char*)memchr(f, ':', fe - f);
            if (!c) c = fe;
            if (c - f == 2 && f[0] == 'G' && f[1] == 'T') {
                gt_idx = idx;
                break;
            }
            ++idx;
            f = c + 1;
        }
    }
    if (gt_idx < 0) return false;
    r.gta.resize((size_t)C.n_samples * 2);
    const char* q = col[9];
    const char* qe = end;
    int32_t n_allele = (int32_t)r.alleles.size();
    for (int32_t si = 0; si < C.n_samples; ++si) {
        if (q > qe) return false;
        const char* t = (const char*)memchr(q, '\t', qe - q);
        if (!t) t = qe;
        // step to the GT subfield
        const char* g = q;
        for (int k = 0; k < gt_idx; ++k) {
            const char* c = (const char*)memchr(g, ':', t - g);
            if (!c) return false;
            g = c + 1;
        }
        const char* ge = (const char*)memchr(g, ':', t - g);
        if (!ge) ge = t;
        // fast path: "a|b" / "a/b" single-digit diploid cell
        if (ge - g == 3 && (g[1] == '|' || g[1] == '/') &&
            (unsigned)(g[0] - '0') < 10u && (unsigned)(g[2] - '0') < 10u) {
            int a0 = g[0] - '0', a1 = g[2] - '0';
            if (a0 >= n_allele || a1 >= n_allele) return false;
            r.gta[(size_t)si * 2] = (int8_t)a0;
            r.gta[(size_t)si * 2 + 1] = (int8_t)a1;
            q = t + 1;
            continue;
        }
        // parse exactly two alleles (diploid import contract)
        int na = 0;
        int8_t al[2] = {-1, -1};
        const char* u = g;
        while (u < ge && na < 3) {
            if (*u == '.') {
                al[na > 1 ? 1 : na] = -1;
                ++na;
                ++u;
            } else if (isdigit((unsigned char)*u)) {
                int v = 0;
                while (u < ge && isdigit((unsigned char)*u)) {
                    v = v * 10 + (*u - '0');
                    ++u;
                }
                if (v >= n_allele) return false;
                if (na < 2) al[na] = (int8_t)v;
                ++na;
            } else {
                return false;
            }
            if (u < ge) {
                if (*u != '|' && *u != '/') return false;
                ++u;
            }
        }
        if (na != 2) return false;
        r.gta[(size_t)si * 2] = al[0];
        r.gta[(size_t)si * 2 + 1] = al[1];
        q = t + 1;
    }
    return true;
}

// bcf_atomize port (bgt_tpu/core/atomize.py:113-185; reference
// atomic.c:98-179)
bool atomize_c(ImportCtx& C, const VRec& r, std::vector<CAtom>& atoms) {
    for (auto& a : atoms) a.from_new = false;
    const std::string& ref = r.alleles[0];
    int64_t l_ref = (int64_t)ref.size();
    size_t ci = 0;
    for (int32_t i = 1; i < (int32_t)r.alleles.size(); ++i) {
        const std::string& alt = r.alleles[i];
        int64_t l_alt = (int64_t)alt.size();
        if (r.rlen != l_ref ||
            (!alt.empty() && alt.front() == '<' && alt.back() == '>')) {
            CAtom a;
            a.rid = r.rid;
            a.pos = r.pos;
            a.rlen = r.rlen;
            a.anum = i;
            a.ref = ref;
            a.alt = alt;
            atoms.push_back(std::move(a));
            continue;
        }
        std::string cig;
        if (!r.cigars.empty()) {
            if (ci >= r.cigars.size() || r.cigars[ci].empty()) return false;
            cig = r.cigars[ci++];
        } else if (l_alt == r.rlen) {
            cig = std::to_string(r.rlen) + "M";
        } else {
            int64_t l = l_alt - r.rlen;
            int64_t rest;
            if (l > 0) {
                cig = "1M" + std::to_string(l) + "I";
                rest = r.rlen - 1;
            } else {
                cig = "1M" + std::to_string(-l) + "D";
                rest = l_alt - 1;
            }
            if (rest) cig += std::to_string(rest) + "M";
        }
        int64_t x = 0, y = 0;
        size_t p = 0;
        while (p < cig.size()) {
            size_t q = p;
            while (q < cig.size() && isdigit((unsigned char)cig[q])) ++q;
            if (q == p || q >= cig.size()) return false;
            int64_t l = atoll(cig.substr(p, q - p).c_str());
            char op = cig[q];
            if (op == 'M' || op == '=' || op == 'X') {
                if (x + l > (int64_t)ref.size() || y + l > (int64_t)alt.size())
                    return false;
                for (int64_t j = 0; j < l; ++j) {
                    if (ref[x + j] != alt[y + j]) {
                        CAtom a;
                        a.rid = r.rid;
                        a.pos = r.pos + x + j;
                        a.rlen = 1;
                        a.anum = i;
                        a.ref = ref.substr(x + j, 1);
                        a.alt = alt.substr(y + j, 1);
                        atoms.push_back(std::move(a));
                    }
                }
                x += l;
                y += l;
            } else if (op == 'I') {
                if (x == 0 || y == 0) {
                    fprintf(stderr,
                            "[W::bcf_atomize] invalid insertion (%lld,%lld) "
                            "at ?:%lld\n",
                            (long long)x, (long long)y, (long long)(r.pos + 1));
                } else {
                    if (y - 1 + 1 + l > (int64_t)alt.size()) return false;
                    CAtom a;
                    a.rid = r.rid;
                    a.pos = r.pos + x - 1;
                    a.rlen = 1;
                    a.anum = i;
                    a.ref = ref.substr(x - 1, 1);
                    a.alt = alt.substr(y - 1, 1 + l);
                    atoms.push_back(std::move(a));
                }
                y += l;
            } else if (op == 'D') {
                if (!(x > 0 && y > 0)) return false;
                if (x - 1 + l + 1 > (int64_t)ref.size()) return false;
                CAtom a;
                a.rid = r.rid;
                a.pos = r.pos + x - 1;
                a.rlen = l + 1;
                a.anum = i;
                a.ref = ref.substr(x - 1, l + 1);
                a.alt = alt.substr(y - 1, 1);
                atoms.push_back(std::move(a));
                x += l;
            } else {
                return false;
            }
            p = q + 1;
        }
    }
    // _gen_at: sort, dedup, fill genotypes for new atoms
    std::stable_sort(atoms.begin(), atoms.end(), atom_less);
    size_t n = atoms.size();
    std::vector<size_t> eq(n, 0);
    bool has_dup = false;
    for (size_t i = 1; i < n; ++i) {
        eq[i] = atoms[i - 1].key_eq(atoms[i]) ? eq[i - 1] : i;
        if (eq[i] == eq[i - 1]) has_dup = true;
    }
    int32_t n_allele = (int32_t)r.alleles.size();
    std::vector<uint8_t> tr((size_t)n_allele);
    size_t n_gt = (size_t)C.n_samples * 2;
    for (size_t k = 0; k < n; ++k) {
        CAtom& ak = atoms[k];
        if (eq[k] != k || !ak.from_new) continue;
        ak.has_multi = false;
        std::fill(tr.begin(), tr.end(), 0);
        for (size_t i = 0; i < n; ++i) {
            const CAtom& ai = atoms[i];
            if (!ai.from_new) continue;
            if (eq[i] == eq[k])
                tr[ai.anum] = 1;
            else if (ai.pos < ak.pos + ak.rlen && ak.pos < ai.pos + ai.rlen)
                tr[ai.anum] = 3;
        }
        ak.gt.resize(n_gt);
        bool multi = false;
        for (size_t m = 0; m < n_gt; ++m) {
            int8_t c = r.gta[m];
            uint8_t code = c < 0 ? 2 : tr[(size_t)c];
            ak.gt[m] = code;
            multi |= code == 3;
        }
        ak.has_multi = multi;
    }
    if (has_dup) {
        std::vector<CAtom> kept;
        kept.reserve(n);
        for (size_t i = 0; i < n; ++i)
            if (eq[i] == i) kept.push_back(std::move(atoms[i]));
        atoms.swap(kept);
    }
    return true;
}

// CSI binning-index run builder driven per emitted record.  Mirrors
// bgt_tpu/formats/csi.py HtsIndex.push (itself the clean-room equivalent
// of hts_idx_push, hts.c:348-400): bin runs are recorded as flat
// (bin, u, v) triples per contig, the linear index as a min-write slot
// array, plus the RNI record offsets — the Python side reassembles an
// HtsIndex from these and runs the (small) finish/merge/save phase.
// Replaces the vectorized-Python push_batch pass that cost ~12 s at the
// 39.2M-row shape.
struct CsiCtg {
    std::vector<int64_t> run_bin;
    std::vector<uint64_t> run_u, run_v;
    std::vector<int64_t> lidx;  // -1 = empty slot
};

struct CsiBuilder {
    bool enabled = false, failed = false;
    int min_shift = 14, n_lvls = 5, rec_shift = 10;
    int64_t n_bins = 0;
    int64_t last_bin = -1, save_bin = -1;
    int32_t last_tid = -1, save_tid = -1;
    int64_t last_coor = -1;
    uint64_t save_off = 0, last_off = 0, off_beg = 0, off_end = 0;
    int64_t n_mapped = 0, n_unmapped = 0, n_rec = 0;
    std::vector<CsiCtg> ctg;
    std::vector<uint64_t> ridx;

    void init(int32_t n_ctg, int32_t min_shift_, int32_t n_lvls_,
              uint64_t voff0) {
        enabled = true;
        min_shift = min_shift_;
        n_lvls = n_lvls_;
        n_bins = ((1LL << (3 * n_lvls + 3)) - 1) / 7;
        ctg.resize(n_ctg);
        save_off = last_off = off_beg = off_end = voff0;
    }

    int64_t reg2bin(int64_t beg, int64_t end) const {
        end -= 1;
        int l = n_lvls, s = min_shift;
        int64_t t = ((1LL << (3 * n_lvls)) - 1) / 7;
        while (l > 0) {
            if ((beg >> s) == (end >> s)) return t + (beg >> s);
            --l;
            s += 3;
            t -= 1LL << (3 * l);
        }
        return 0;
    }

    void insert_b(int32_t tid, int64_t b, uint64_t u, uint64_t v) {
        CsiCtg& c = ctg[tid];
        c.run_bin.push_back(b);
        c.run_u.push_back(u);
        c.run_v.push_back(v);
    }

    void insert_l(int32_t tid, int64_t beg, int64_t end, uint64_t off) {
        std::vector<int64_t>& l = ctg[tid].lidx;
        int64_t b = beg >> min_shift, e = (end - 1) >> min_shift;
        if ((int64_t)l.size() < e + 1) l.resize(e + 1, -1);
        for (int64_t i = b; i <= e; ++i)
            if (l[i] < 0) l[i] = (int64_t)off;
    }

    // mapped records only (the importer emits mapped atoms exclusively);
    // false = unsorted input, builder poisoned, Python CSI fallback
    bool push(int32_t tid, int64_t beg, int64_t end, uint64_t offset) {
        if (!enabled || failed) return !failed;
        if (tid >= (int32_t)ctg.size()) ctg.resize(tid + 1);
        if (last_tid < tid) {
            last_tid = tid;
            last_bin = -1;
        } else if (last_tid > tid || last_coor > beg) {
            failed = true;
            return false;
        }
        insert_l(tid, beg, end, last_off);
        int64_t b = reg2bin(beg, end);
        if (last_bin != b) {
            if (save_bin != -1)
                insert_b(save_tid, save_bin, save_off, last_off);
            if (last_bin == -1 && save_bin != -1) {  // change of contig
                off_end = last_off;
                insert_b(save_tid, n_bins + 1, off_beg, off_end);
                insert_b(save_tid, n_bins + 1, (uint64_t)n_mapped,
                         (uint64_t)n_unmapped);
                n_mapped = n_unmapped = 0;
                off_beg = off_end;
            }
            save_off = last_off;
            save_bin = last_bin = b;
            save_tid = tid;
        }
        if (rec_shift > 0 && (n_rec & ((1LL << rec_shift) - 1)) == 0)
            ridx.push_back(last_off);
        ++n_mapped;
        last_off = offset;
        last_coor = beg;
        ++n_rec;
        return true;
    }

    template <typename F>
    void remap(F&& f) {
        for (CsiCtg& c : ctg) {
            // pseudo-bin (n_bins+1) entries alternate: (off_beg, off_end)
            // then (n_mapped, n_unmapped) — the counts pair must NOT be
            // rewritten as offsets
            int pseudo_seen = 0;
            for (size_t i = 0; i < c.run_bin.size(); ++i) {
                if (c.run_bin[i] == n_bins + 1 && (++pseudo_seen & 1) == 0)
                    continue;
                c.run_u[i] = f(c.run_u[i]);
                c.run_v[i] = f(c.run_v[i]);
            }
            for (int64_t& x : c.lidx)
                if (x >= 0) x = (int64_t)f((uint64_t)x);
        }
        for (uint64_t& r : ridx) r = f(r);
        save_off = f(save_off);
        last_off = f(last_off);
        off_beg = f(off_beg);
        off_end = f(off_end);
    }
};

struct ImportResult {
    std::vector<int32_t> rid;
    std::vector<int64_t> pos, end;
    std::vector<uint64_t> voff;  // BGZF virtual offset AFTER each record
    uint64_t voff0 = 0;          // offset after the header
    int64_t n = 0;
    // site-table columns collected while emitting (rid/pos above are
    // shared) so `bgt import` can write the .sites.npz sidecar without
    // re-scanning the BCF it just wrote (the reference builds its index
    // at import for the same reason, import.c:117)
    std::vector<int64_t> srlen, sref_len, salt_len;
    std::vector<int32_t> snal;
    std::vector<uint8_t> sref_cat, salt_cat;
    CsiBuilder csi;  // moved from the job at finish
};

// BGZF reader for native BCF input (inflate one block at a time; mirrors
// bgt_tpu/io/bgzf.py's reader, reference bgzf.c:318-379)
struct BgzfIn {
    FILE* fp = nullptr;
    std::vector<uint8_t> ub, cb;
    size_t up = 0;
    bool err = false;

    ~BgzfIn() {
        if (fp) fclose(fp);
    }

    bool fill() {  // load the next non-empty block; false at EOF/error
        for (;;) {
            uint8_t hdr[18];
            size_t n = fread(hdr, 1, 18, fp);
            if (n == 0) return false;  // clean EOF
            if (n < 18 || hdr[0] != 0x1f || hdr[1] != 0x8b) {
                err = true;
                return false;
            }
            uint16_t bs16;
            memcpy(&bs16, hdr + 16, 2);
            size_t bsize = (size_t)bs16 + 1;
            if (bsize < 18 + 8) {
                err = true;
                return false;
            }
            cb.resize(bsize - 18);
            if (fread(cb.data(), 1, bsize - 18, fp) != bsize - 18) {
                err = true;
                return false;
            }
            uint32_t isize;
            memcpy(&isize, cb.data() + (bsize - 18 - 4), 4);
            if (isize == 0) continue;  // EOF marker block
            ub.resize(isize);
            up = 0;
            z_stream zs{};
            if (inflateInit2(&zs, -15) != Z_OK) {
                err = true;
                return false;
            }
            zs.next_in = cb.data();
            zs.avail_in = (uInt)(bsize - 18 - 8);
            zs.next_out = ub.data();
            zs.avail_out = isize;
            int r = inflate(&zs, Z_FINISH);
            inflateEnd(&zs);
            if (r != Z_STREAM_END) {
                err = true;
                return false;
            }
            return true;
        }
    }

    // read exactly n bytes: 1=ok, 0=clean EOF with nothing read, -1=error
    int read_exact(void* dst, size_t n) {
        uint8_t* d = (uint8_t*)dst;
        size_t got = 0;
        while (got < n) {
            if (up == ub.size()) {
                if (!fill()) return err ? -1 : (got == 0 ? 0 : -1);
            }
            size_t take = std::min(n - got, ub.size() - up);
            memcpy(d + got, ub.data() + up, take);
            up += take;
            got += take;
        }
        return 1;
    }
};

// cursor over BCF typed values (bgt_tpu/formats/bcf.py dec_* equivalents)
struct TCur {
    const uint8_t* p;
    const uint8_t* e;
    bool ok = true;

    static int tsize(int t) {
        switch (t) {
            case 0: return 0;
            case 1: return 1;
            case 2: return 2;
            case 3: return 4;
            case 5: return 4;
            case 7: return 1;
        }
        return -1;
    }

    int64_t raw_int(int t) {
        int s = tsize(t);
        if (s < 1 || s > 4 || t == 5 || p + s > e) {
            ok = false;
            return 0;
        }
        int64_t v = 0;
        if (t == 1) {
            int8_t x;
            memcpy(&x, p, 1);
            v = x;
        } else if (t == 2) {
            int16_t x;
            memcpy(&x, p, 2);
            v = x;
        } else {
            int32_t x;
            memcpy(&x, p, 4);
            v = x;
        }
        p += s;
        return v;
    }

    int64_t int1() {  // one full typed scalar (keys, big sizes)
        if (p >= e) {
            ok = false;
            return 0;
        }
        uint8_t b = *p++;
        if ((b >> 4) != 1) {
            ok = false;
            return 0;
        }
        return raw_int(b & 0xf);
    }

    bool head(int& t, int64_t& n) {
        if (p >= e) {
            ok = false;
            return false;
        }
        uint8_t b = *p++;
        t = b & 0xf;
        n = b >> 4;
        if (n == 15) n = int1();
        return ok;
    }

    bool skip_val(int t, int64_t n) {
        int s = tsize(t);
        if (s < 0 || p + s * n > e) {
            ok = false;
            return false;
        }
        p += s * n;
        return true;
    }
};

// streaming BCF record source for the importer (native equivalent of the
// reference's bcf_read1 front-end, import.c:45, vcf.c:316-360)
struct BcfRecSource {
    BgzfIn in;
    int32_t n_samples = 0;
    const int32_t* rid_map = nullptr;
    int32_t n_contigs_in = 0;
    int32_t gt_kid = -1, cigar_kid = -1, pass_fid = 0;
    bool keep_flt = false;
    std::vector<uint8_t> sh, ind;

    bool open(const char* path) {
        in.fp = fopen(path, "rb");
        if (!in.fp) return false;
        // header: "BCF\2\x??" + l_text + text
        uint8_t magic[5];
        if (in.read_exact(magic, 5) != 1 || memcmp(magic, "BCF\x02", 4) != 0)
            return false;
        int32_t l_text;
        if (in.read_exact(&l_text, 4) != 1 || l_text < 0) return false;
        std::vector<uint8_t> skip((size_t)l_text);
        return l_text == 0 || in.read_exact(skip.data(), skip.size()) == 1;
    }

    int read(VRec& r) {  // 1=got, 0=eof, -1=error
        for (;;) {
            uint32_t lens[2];
            int g = in.read_exact(lens, 8);
            if (g <= 0) return g;
            uint32_t l_shared = lens[0], l_indiv = lens[1];
            if (l_shared < 24 || l_shared > (1u << 30) ||
                l_indiv > (1u << 31))
                return -1;
            sh.resize(l_shared);
            if (in.read_exact(sh.data(), l_shared) != 1) return -1;
            ind.resize(l_indiv);
            if (l_indiv && in.read_exact(ind.data(), l_indiv) != 1) return -1;
            int32_t rid, pos, rlen;
            uint32_t nai, nfs;
            memcpy(&rid, sh.data(), 4);
            memcpy(&pos, sh.data() + 4, 4);
            memcpy(&rlen, sh.data() + 8, 4);
            memcpy(&nai, sh.data() + 16, 4);
            memcpy(&nfs, sh.data() + 20, 4);
            int32_t n_allele = (int32_t)(nai >> 16);
            int32_t n_info = (int32_t)(nai & 0xffff);
            int32_t n_sample = (int32_t)(nfs & 0xffffff);
            int32_t n_fmt = (int32_t)(nfs >> 24);
            if (rid < 0 || rid >= n_contigs_in || n_sample != n_samples ||
                n_allele < 1)
                return -1;
            r.rid = rid_map[rid];
            if (r.rid < 0) return -1;
            r.pos = pos;
            r.rlen = rlen;
            TCur c{sh.data() + 24, sh.data() + l_shared};
            int t;
            int64_t n;
            if (!c.head(t, n) || !c.skip_val(t, n)) return -1;  // ID
            r.alleles.clear();
            for (int32_t i = 0; i < n_allele; ++i) {
                if (!c.head(t, n) || t != 7 || c.p + n > c.e) return -1;
                r.alleles.emplace_back((const char*)c.p, (size_t)n);
                c.p += n;
            }
            // FILTER: filtered unless empty or exactly {PASS}
            if (!c.head(t, n)) return -1;
            bool skip_rec = false;
            if (n > 0) {
                int64_t first = c.raw_int(t);
                if (!c.ok || !c.skip_val(t, n - 1)) return -1;
                skip_rec = !(n == 1 && first == pass_fid);
            }
            // INFO: capture CIGAR (comma-joined string), skip the rest
            r.cigars.clear();
            for (int32_t i = 0; i < n_info; ++i) {
                int64_t key = c.int1();
                if (!c.ok || !c.head(t, n)) return -1;
                if ((int32_t)key == cigar_kid && t == 7 && cigar_kid >= 0) {
                    if (c.p + n > c.e) return -1;
                    const char* a = (const char*)c.p;
                    const char* ae = a + n;
                    while (a < ae) {
                        const char* cm = (const char*)memchr(a, ',', ae - a);
                        if (!cm) cm = ae;
                        r.cigars.emplace_back(a, cm - a);
                        a = cm + 1;
                    }
                    c.p += n;
                } else if (!c.skip_val(t, n)) {
                    return -1;
                }
            }
            // FORMAT: find GT, require 2 int values per sample (diploid)
            TCur f{ind.data(), ind.data() + l_indiv};
            bool got_gt = false;
            for (int32_t k = 0; k < n_fmt; ++k) {
                int64_t key = f.int1();
                if (!f.ok || !f.head(t, n)) return -1;
                if ((int32_t)key == gt_kid) {
                    if (n != 2 || (t != 1 && t != 2)) return -1;
                    r.gta.resize((size_t)n_samples * 2);
                    for (int64_t m = 0; m < (int64_t)n_samples * 2; ++m) {
                        int64_t v = f.raw_int(t);
                        if (!f.ok) return -1;
                        int64_t al = v <= 0 ? -1 : (v >> 1) - 1;
                        if (al >= n_allele) return -1;
                        r.gta[m] = (int8_t)al;
                    }
                    got_gt = true;
                } else if (!f.skip_val(t, n * n_sample)) {
                    return -1;
                }
            }
            if (!got_gt) return -1;
            if (!keep_flt && skip_rec) continue;
            return 1;
        }
    }
};

// Import job: the shared .bcf/.pbf writers + row counter across any number
// of input files (the reference's multi-input append, import.c:85-109)
struct ImportJob {
    BgzfOut bcf;
    void* pbfw = nullptr;
    void* pbfw1 = nullptr;  // optional single-plane .pb1 (import.c:24,37)
    ImportResult* R = nullptr;
    std::vector<uint8_t> rowbuf, rowbuf1, shared;
    int64_t rowbuf_n = 0, kRowBatch = 1;
    int32_t row_kid = 0, n_samples = 0;
    std::string pbf_path, bcf_path, pb1_path;
    CsiBuilder csi;  // opt-in via bgt_import_csi_init
    bool failed = false;

    bool flush_rows() {
        if (rowbuf_n == 0) return true;
        if (bgt_pbf_writer_write(pbfw, rowbuf.data(), rowbuf_n) < 0)
            return false;
        if (pbfw1 &&
            bgt_pbf_writer_write(pbfw1, rowbuf1.data(), rowbuf_n) < 0)
            return false;
        rowbuf.clear();
        rowbuf1.clear();
        rowbuf_n = 0;
        return true;
    }

    bool emit(const CAtom& a) {
        // site record: atom_to_bcf(write_m=True, id_gt=-1) + INFO/_row
        shared.clear();
        int32_t n_allele = a.has_multi ? 3 : 2;
        enc_size_c(shared, 0, 7);  // empty ID
        enc_vchar_c(shared, a.ref);
        enc_vchar_c(shared, a.alt);
        if (n_allele > 2) enc_vchar_c(shared, "<M>");
        enc_size_c(shared, 0, 0);  // empty FILTER (enc_vint([]))
        enc_int1_c(shared, row_kid);
        enc_int1_c(shared, R->n);
        uint32_t l_shared = (uint32_t)shared.size() + 24, l_indiv = 0;
        uint32_t w[8];
        w[0] = l_shared;
        w[1] = l_indiv;
        w[2] = (uint32_t)a.rid;
        w[3] = (uint32_t)a.pos;
        w[4] = (uint32_t)a.rlen;
        w[5] = 0;                              // qual bits
        w[6] = (uint32_t)n_allele << 16 | 1;   // n_allele<<16 | n_info
        w[7] = 0;                              // n_fmt<<24 | n_sample
        if (!bcf.write(w, 32)) return false;
        if (!bcf.write(shared.data(), shared.size())) return false;
        rowbuf.insert(rowbuf.end(), a.gt.begin(), a.gt.end());
        if (pbfw1) {
            size_t base = rowbuf1.size();
            rowbuf1.resize(base + a.gt.size());
            for (size_t i = 0; i < a.gt.size(); ++i)
                rowbuf1[base + i] = a.gt[i] == 1;  // import.c:98
        }
        if (++rowbuf_n >= kRowBatch && !flush_rows()) return false;
        R->rid.push_back(a.rid);
        R->pos.push_back(a.pos);
        R->end.push_back(a.pos + a.rlen);
        R->voff.push_back(bcf.vtell());
        // CSI bin/linear/RNI state machine (a poisoned builder just means
        // the Python side rebuilds the index from rid/pos/end/voff)
        csi.push(a.rid, a.pos, a.pos + a.rlen, R->voff.back());
        // site-table sidecar columns (ALT1 only, bcf_get_ref_alt1 rule)
        R->srlen.push_back(a.rlen);
        R->snal.push_back(n_allele);
        R->sref_len.push_back((int64_t)a.ref.size());
        R->salt_len.push_back((int64_t)a.alt.size());
        R->sref_cat.insert(R->sref_cat.end(), a.ref.begin(), a.ref.end());
        R->salt_cat.insert(R->salt_cat.end(), a.alt.begin(), a.alt.end());
        ++R->n;
        return true;
    }
};

// One input file through the atomize state machine: the producer thread
// parses + atomizes (bgt_tpu/core/atomize.py:220-284), this thread encodes
// the PBWT planes and writes both outputs — the halves overlap on two
// cores (the reference is strictly sequential here, import.c:92-103).
template <typename ReadRec>
bool run_import_source(ImportJob& J, ImportCtx& C, ReadRec&& read_rec) {
    constexpr size_t kPipeMax = 8;
    struct Pipe {
        std::mutex mu;
        std::condition_variable cv_put, cv_get;
        std::deque<std::vector<CAtom>> q;
        bool done = false, error = false;
    } pipe;

    std::thread producer([&]() {
        std::vector<CAtom> atoms;
        size_t start = 0;
        bool no_vcf = false;
        VRec nxt;
        std::vector<CAtom> batch;
        constexpr size_t kBatch = 64;

        auto push_batch = [&]() -> bool {
            std::unique_lock<std::mutex> lk(pipe.mu);
            pipe.cv_put.wait(lk, [&] {
                return pipe.q.size() < kPipeMax || pipe.error;
            });
            if (pipe.error) return false;
            pipe.q.push_back(std::move(batch));
            batch.clear();
            pipe.cv_get.notify_one();
            return true;
        };
        auto finish = [&](bool err) {
            std::lock_guard<std::mutex> lk(pipe.mu);
            if (err) pipe.error = true;
            pipe.done = true;
            pipe.cv_get.notify_one();
        };

        VRec cur;
        int g = read_rec(cur);
        if (g < 0) return finish(true);
        if (g == 1) {
            if (!atomize_c(C, cur, atoms)) return finish(true);
            g = read_rec(nxt);
            if (g < 0) return finish(true);
            if (g == 0) no_vcf = true;
        } else {
            no_vcf = true;
        }
        for (;;) {
            if (start == atoms.size()) {
                if (no_vcf) break;
                atoms.clear();
                start = 0;
                if (!atomize_c(C, nxt, atoms)) return finish(true);
                g = read_rec(nxt);
                if (g < 0) return finish(true);
                if (g == 0) no_vcf = true;
                if (atoms.empty()) continue;
            }
            for (;;) {
                CAtom& a0 = atoms[start];
                if (no_vcf || a0.rid < nxt.rid ||
                    (a0.rid == nxt.rid && a0.pos < nxt.pos)) {
                    batch.push_back(std::move(a0));
                    ++start;
                    if (batch.size() >= kBatch && !push_batch()) return;
                    break;
                }
                if (start) {
                    atoms.erase(atoms.begin(), atoms.begin() + start);
                    start = 0;
                }
                if (!atomize_c(C, nxt, atoms)) return finish(true);
                g = read_rec(nxt);
                if (g < 0) return finish(true);
                if (g == 0) no_vcf = true;
            }
        }
        if (!batch.empty() && !push_batch()) return;
        finish(false);
    });

    bool ok = true;
    for (;;) {
        std::vector<CAtom> batch;
        {
            std::unique_lock<std::mutex> lk(pipe.mu);
            pipe.cv_get.wait(lk, [&] { return !pipe.q.empty() || pipe.done; });
            if (pipe.q.empty()) {
                ok = !pipe.error;
                break;
            }
            batch = std::move(pipe.q.front());
            pipe.q.pop_front();
            pipe.cv_put.notify_one();
        }
        for (const CAtom& a : batch) {
            if (!J.emit(a)) {
                std::lock_guard<std::mutex> lk(pipe.mu);
                pipe.error = true;
                pipe.cv_put.notify_one();
                ok = false;
                break;
            }
        }
        if (!ok) break;
    }
    producer.join();
    return ok;
}

}  // namespace

extern "C" {

// Open an import job: shared site-BCF + PBF writers across input files.
// nullptr on failure (caller falls back to the Python importer).
void* bgt_import_open(const char* pbf_path, const char* bcf_path,
                      const uint8_t* bcf_hdr_blob, int64_t hdr_len,
                      int32_t n_samples, int32_t clevel, int32_t row_kid,
                      int32_t shift, const char* pb1_path) {
    auto* J = new ImportJob();
    J->pbf_path = pbf_path;
    J->bcf_path = bcf_path;
    if (pb1_path && pb1_path[0]) J->pb1_path = pb1_path;
    J->row_kid = row_kid;
    J->n_samples = n_samples;
    // PBF rows batch up so the writer can encode both planes in parallel;
    // without a third core that parallelism never engages and the batch
    // copies are pure overhead for wide rows, so flush per row there —
    // EXCEPT narrow matrices (few samples, e.g. the 39.2M-row site-scale
    // case), where the per-call overhead dwarfs the tiny row copies
    int64_t by_width = (int64_t)(1 << 16) / std::max(1, n_samples * 2);
    J->kRowBatch = std::max<int64_t>(
        by_width, std::thread::hardware_concurrency() >= 3 ? 256 : 1);
    J->bcf.fp = fopen(bcf_path, "wb");
    J->bcf.level = clevel;
    // overlap site-BCF deflate with parsing/encoding when a second core
    // exists (the emit thread is deflate-bound at site-heavy shapes)
    if (std::thread::hardware_concurrency() >= 2) J->bcf.start_async();
    auto fail = [&]() -> void* {
        J->bcf.stop_async();  // worker must stop before the fp closes
        if (J->bcf.fp) fclose(J->bcf.fp);
        if (J->pbfw) bgt_pbf_writer_close(J->pbfw);
        remove(bcf_path);
        remove(pbf_path);
        if (!J->pb1_path.empty()) remove(J->pb1_path.c_str());
        delete J;
        return nullptr;
    };
    if (!J->bcf.fp) return fail();
    if (!J->bcf.write(bcf_hdr_blob, (size_t)hdr_len)) return fail();
    J->pbfw = bgt_pbf_writer_open(pbf_path, n_samples * 2, 2, shift);
    if (!J->pbfw) return fail();
    if (!J->pb1_path.empty()) {
        // single-plane PBF, same geometry (import.c:74)
        J->pbfw1 = bgt_pbf_writer_open(J->pb1_path.c_str(), n_samples * 2,
                                       1, shift);
        if (!J->pbfw1) return fail();
    }
    J->R = new ImportResult();
    J->R->voff0 = J->bcf.vtell();
    return J;
}

// Stream one text-VCF input through the job.  0 ok, -1 error (job poisoned;
// finish cleans up).
int32_t bgt_import_add_text(void* jobp, const char* vcf_path,
                            const char* contigs_cat, int32_t n_contigs,
                            const char* filters_cat,
                            const int32_t* filter_ids, int32_t n_filters,
                            int32_t keep_flt, int32_t end_defined,
                            int32_t cigar_defined) {
    auto* J = (ImportJob*)jobp;
    if (J->failed) return -1;
    ImportCtx C;
    C.n_samples = J->n_samples;
    C.end_defined = end_defined != 0;
    C.cigar_defined = cigar_defined != 0;
    {
        const char* p = contigs_cat;
        for (int32_t i = 0; i < n_contigs; ++i) {
            C.contig_id.emplace(p, i);
            p += strlen(p) + 1;
        }
        p = filters_cat;
        for (int32_t i = 0; i < n_filters; ++i) {
            C.filter_id.emplace(p, filter_ids[i]);
            p += strlen(p) + 1;
        }
    }
    LineReader lr;
    lr.gz = gzopen(vcf_path, "rb");
    if (!lr.gz) {
        J->failed = true;
        return -1;
    }
    gzbuffer(lr.gz, 1 << 20);
    std::string line;
    auto read_rec = [&](VRec& r) -> int {  // 1=got, 0=eof, -1=error
        bool skip;
        while (lr.getline(line)) {
            if (!line.empty() && line.back() == '\r') line.pop_back();
            if (line.empty()) continue;
            if (line[0] == '#') continue;
            if (!parse_vrec(C, line, r, skip)) return -1;
            if (!keep_flt && skip) continue;
            return 1;
        }
        return lr.error ? -1 : 0;  // truncated input must not look done
    };
    bool ok = run_import_source(*J, C, read_rec);
    gzclose(lr.gz);
    if (!ok) J->failed = true;
    return ok ? 0 : -1;
}

// Stream one binary-BCF input through the job.  ``rid_map`` maps the input
// file's contig ids to output ids (identity for a same-header append);
// ``gt_kid``/``cigar_kid``/``pass_fid`` are the INPUT header's dictionary
// ids.  0 ok, -1 error (job poisoned).
int32_t bgt_import_add_bcf(void* jobp, const char* bcf_path,
                           const int32_t* rid_map, int32_t n_contigs_in,
                           int32_t gt_kid, int32_t cigar_kid,
                           int32_t pass_fid, int32_t keep_flt) {
    auto* J = (ImportJob*)jobp;
    if (J->failed) return -1;
    ImportCtx C;
    C.n_samples = J->n_samples;
    BcfRecSource src;
    src.n_samples = J->n_samples;
    src.rid_map = rid_map;
    src.n_contigs_in = n_contigs_in;
    src.gt_kid = gt_kid;
    src.cigar_kid = cigar_kid;
    src.pass_fid = pass_fid;
    src.keep_flt = keep_flt != 0;
    if (!src.open(bcf_path)) {
        J->failed = true;
        return -1;
    }
    bool ok = run_import_source(*J, C,
                                [&](VRec& r) -> int { return src.read(r); });
    if (!ok) J->failed = true;
    return ok ? 0 : -1;
}

// Poison the job: a subsequent finish removes the partial outputs instead
// of finalizing them (Python-side pre-add failures, e.g. header mismatch).
void bgt_import_abort(void* jobp) { ((ImportJob*)jobp)->failed = true; }

// Close the job.  Returns the ImportResult handle, or nullptr on failure
// (partial outputs removed).
void* bgt_import_finish(void* jobp) {
    auto* J = (ImportJob*)jobp;
    ImportResult* R = J->R;
    bool ok = !J->failed && J->flush_rows();
    bool was_async = J->bcf.async;
    if (ok) {
        ok = J->bcf.close();
        if (ok && was_async) {
            auto starts = J->bcf.block_starts();
            auto f = [&](uint64_t v) {
                return (starts[v >> 16] << 16) | (v & 0xFFFF);
            };
            for (auto& v : R->voff) v = f(v);
            R->voff0 = f(R->voff0);
            if (J->csi.enabled && !J->csi.failed) J->csi.remap(f);
        }
        R->csi = std::move(J->csi);
    } else if (J->bcf.fp) {
        J->bcf.stop_async();
        fclose(J->bcf.fp);
        J->bcf.fp = nullptr;
    }
    if (J->pbfw && bgt_pbf_writer_close(J->pbfw) != 0) ok = false;
    if (J->pbfw1 && bgt_pbf_writer_close(J->pbfw1) != 0) ok = false;
    if (!ok) {
        remove(J->bcf_path.c_str());
        remove(J->pbf_path.c_str());
        if (!J->pb1_path.empty()) remove(J->pb1_path.c_str());
        delete R;
        R = nullptr;
    }
    delete J;
    return R;
}

// One-shot single text-VCF import (the original entry point; kept as a
// wrapper over open/add/finish).
void* bgt_import_text(const char* vcf_path, const char* pbf_path,
                      const char* bcf_path, const uint8_t* bcf_hdr_blob,
                      int64_t hdr_len, const char* contigs_cat,
                      int32_t n_contigs, const char* filters_cat,
                      const int32_t* filter_ids, int32_t n_filters,
                      int32_t n_samples, int32_t keep_flt, int32_t clevel,
                      int32_t row_kid, int32_t end_defined,
                      int32_t cigar_defined, int32_t shift) {
    void* J = bgt_import_open(pbf_path, bcf_path, bcf_hdr_blob, hdr_len,
                              n_samples, clevel, row_kid, shift, nullptr);
    if (!J) return nullptr;
    bgt_import_add_text(J, vcf_path, contigs_cat, n_contigs, filters_cat,
                        filter_ids, n_filters, keep_flt, end_defined,
                        cigar_defined);
    return bgt_import_finish(J);
}

int64_t bgt_import_n(void* h) { return ((ImportResult*)h)->n; }

uint64_t bgt_import_voff0(void* h) { return ((ImportResult*)h)->voff0; }

void bgt_import_meta(void* h, void** rid, void** pos, void** end,
                     void** voff) {
    auto* r = (ImportResult*)h;
    *rid = r->rid.data();
    *pos = r->pos.data();
    *end = r->end.data();
    *voff = r->voff.data();
}

// Enable the in-job CSI builder (call right after bgt_import_open, before
// any add; n_ctg/min_shift/n_lvls from the output header's contigs)
void bgt_import_csi_init(void* jobp, int32_t n_ctg, int32_t min_shift,
                         int32_t n_lvls) {
    auto* J = (ImportJob*)jobp;
    J->csi.init(n_ctg, min_shift, n_lvls, J->R->voff0);
}

// 1 when the finished result carries a usable CSI build
int32_t bgt_import_csi_ok(void* h) {
    auto& c = ((ImportResult*)h)->csi;
    return (c.enabled && !c.failed) ? 1 : 0;
}

// builder end-state for the Python finish() pass; vals[9]:
// n_ctg, n_rec, save_tid, save_bin, save_off, off_beg, n_mapped,
// n_unmapped, ridx_len
void bgt_import_csi_state(void* h, int64_t* vals, void** ridx) {
    auto& c = ((ImportResult*)h)->csi;
    vals[0] = (int64_t)c.ctg.size();
    vals[1] = c.n_rec;
    vals[2] = c.save_tid;
    vals[3] = c.save_bin;
    vals[4] = (int64_t)c.save_off;
    vals[5] = (int64_t)c.off_beg;
    vals[6] = c.n_mapped;
    vals[7] = c.n_unmapped;
    vals[8] = (int64_t)c.ridx.size();
    *ridx = c.ridx.data();
}

void bgt_import_csi_ctg(void* h, int32_t i, void** run_bin, void** run_u,
                        void** run_v, int64_t* n_runs, void** lidx,
                        int64_t* n_lidx) {
    CsiCtg& c = ((ImportResult*)h)->csi.ctg[i];
    *run_bin = c.run_bin.data();
    *run_u = c.run_u.data();
    *run_v = c.run_v.data();
    *n_runs = (int64_t)c.run_bin.size();
    *lidx = c.lidx.data();
    *n_lidx = (int64_t)c.lidx.size();
}

// Sidecar columns collected during emit (rid/pos come from bgt_import_meta)
void bgt_import_sites(void* h, void** rlen, void** nal, void** ref_len,
                      void** alt_len, void** ref_cat, int64_t* ref_cat_len,
                      void** alt_cat, int64_t* alt_cat_len) {
    auto* r = (ImportResult*)h;
    *rlen = r->srlen.data();
    *nal = r->snal.data();
    *ref_len = r->sref_len.data();
    *alt_len = r->salt_len.data();
    *ref_cat = r->sref_cat.data();
    *ref_cat_len = (int64_t)r->sref_cat.size();
    *alt_cat = r->salt_cat.data();
    *alt_cat_len = (int64_t)r->salt_cat.size();
}

void bgt_import_free(void* h) { delete (ImportResult*)h; }

}  // extern "C"

// ---------------------------------------------------------------------------
// Native multi-DB site merge: a streaming k-way merge over key-sorted
// per-DB site selections (rid, pos, rlen, alt) — the site streams are
// sorted by construction (the atomizer emits in key order), so no sort is
// needed; equal keys across DBs consume together, pairing duplicate keys
// occurrence-wise exactly like the reference lookahead merge
// (bgt.c:803-842) and fastpath._merge_dict.
// ---------------------------------------------------------------------------

namespace {

struct MergeResult {
    std::vector<int32_t> rid, nal;
    std::vector<int64_t> pos, rlen, ref_len, alt_len, pres;
    std::vector<uint8_t> ref_cat, alt_cat;
    int64_t n = 0;
};

struct MergeCursor {
    const int64_t* rows;
    int64_t n, i;
    const int32_t* rid;
    const int64_t* pos;
    const int64_t* rlen;
    const int32_t* nal;
    const int64_t* aoff;
    const int64_t* alen;
    const uint8_t* acat;
    const int64_t* roff;
    const int64_t* rflen;
    const uint8_t* rcat;

    bool done() const { return i >= n; }
    int64_t row() const { return rows[i]; }
};

// -1/0/1 comparison of cursor heads by (rid, pos, rlen, alt-bytes)
int head_cmp(const MergeCursor& a, const MergeCursor& b) {
    int64_t ra = a.row(), rb = b.row();
    if (a.rid[ra] != b.rid[rb]) return a.rid[ra] < b.rid[rb] ? -1 : 1;
    if (a.pos[ra] != b.pos[rb]) return a.pos[ra] < b.pos[rb] ? -1 : 1;
    if (a.rlen[ra] != b.rlen[rb]) return a.rlen[ra] < b.rlen[rb] ? -1 : 1;
    int64_t la = a.alen[ra], lb = b.alen[rb];
    int c = memcmp(a.acat + a.aoff[ra], b.acat + b.aoff[rb],
                   (size_t)std::min(la, lb));
    if (c) return c < 0 ? -1 : 1;
    if (la != lb) return la < lb ? -1 : 1;
    return 0;
}

}  // namespace

extern "C" {

void* bgt_merge_sites(int32_t n_db, const int64_t* db_nrows,
                      const int64_t* rows_cat, const void** rid_p,
                      const void** pos_p, const void** rlen_p,
                      const void** nal_p, const void** aoff_p,
                      const void** alen_p, const void** acat_p,
                      const void** roff_p, const void** rflen_p,
                      const void** rcat_p) {
    std::vector<MergeCursor> cur((size_t)n_db);
    int64_t off = 0;
    for (int32_t d = 0; d < n_db; ++d) {
        MergeCursor& c = cur[d];
        c.rows = rows_cat + off;
        c.n = db_nrows[d];
        c.i = 0;
        off += c.n;
        c.rid = (const int32_t*)rid_p[d];
        c.pos = (const int64_t*)pos_p[d];
        c.rlen = (const int64_t*)rlen_p[d];
        c.nal = (const int32_t*)nal_p[d];
        c.aoff = (const int64_t*)aoff_p[d];
        c.alen = (const int64_t*)alen_p[d];
        c.acat = (const uint8_t*)acat_p[d];
        c.roff = (const int64_t*)roff_p[d];
        c.rflen = (const int64_t*)rflen_p[d];
        c.rcat = (const uint8_t*)rcat_p[d];
    }
    auto* R = new MergeResult();
    int64_t total = off;
    R->rid.reserve(total);
    R->pos.reserve(total);
    R->rlen.reserve(total);
    R->nal.reserve(total);
    R->ref_len.reserve(total);
    R->alt_len.reserve(total);
    R->pres.reserve(total * n_db);
    for (;;) {
        int min_d = -1;
        for (int32_t d = 0; d < n_db; ++d) {
            if (cur[d].done()) continue;
            if (min_d < 0 || head_cmp(cur[d], cur[min_d]) < 0) min_d = d;
        }
        if (min_d < 0) break;
        const MergeCursor& m = cur[min_d];
        int64_t mr = m.row();
        // capture the min key BEFORE any cursor advances (equality checks
        // below must not see a consumed head)
        int32_t krid = m.rid[mr];
        int64_t kpos = m.pos[mr], krlen = m.rlen[mr];
        const uint8_t* kalt = m.acat + m.aoff[mr];
        int64_t kalen = m.alen[mr];
        R->rid.push_back(krid);
        R->pos.push_back(kpos);
        R->rlen.push_back(krlen);
        R->ref_len.push_back(m.rflen[mr]);
        R->ref_cat.insert(R->ref_cat.end(), m.rcat + m.roff[mr],
                          m.rcat + m.roff[mr] + m.rflen[mr]);
        R->alt_len.push_back(kalen);
        R->alt_cat.insert(R->alt_cat.end(), kalt, kalt + kalen);
        int32_t nal = 0;
        size_t pres_base = R->pres.size();
        R->pres.resize(pres_base + n_db, -1);
        for (int32_t d = 0; d < n_db; ++d) {
            MergeCursor& c = cur[d];
            if (c.done()) continue;
            int64_t r = c.row();
            bool eq = d == min_d ||
                      (c.rid[r] == krid && c.pos[r] == kpos &&
                       c.rlen[r] == krlen && c.alen[r] == kalen &&
                       memcmp(c.acat + c.aoff[r], kalt, (size_t)kalen) == 0);
            if (eq) {
                R->pres[pres_base + d] = r;
                if (c.nal[r] > nal) nal = c.nal[r];
                ++c.i;
            }
        }
        R->nal.push_back(nal);
        ++R->n;
    }
    return R;
}

int64_t bgt_merge_n(void* h) { return ((MergeResult*)h)->n; }

void bgt_merge_data(void* h, void** rid, void** pos, void** rlen, void** nal,
                    void** ref_len, void** alt_len, void** pres,
                    void** ref_cat, int64_t* ref_cat_len, void** alt_cat,
                    int64_t* alt_cat_len) {
    auto* r = (MergeResult*)h;
    *rid = r->rid.data();
    *pos = r->pos.data();
    *rlen = r->rlen.data();
    *nal = r->nal.data();
    *ref_len = r->ref_len.data();
    *alt_len = r->alt_len.data();
    *pres = r->pres.data();
    *ref_cat = r->ref_cat.data();
    *ref_cat_len = (int64_t)r->ref_cat.size();
    *alt_cat = r->alt_cat.data();
    *alt_cat_len = (int64_t)r->alt_cat.size();
}

void bgt_merge_free(void* h) { delete (MergeResult*)h; }

}  // extern "C"

// ---------------------------------------------------------------------------
// Threaded masked popcount counts: the host tier of the AC/AN reduction
// (same math as the device kernel, ops/counts.py; reference bgt.c:735-757).
// ---------------------------------------------------------------------------

extern "C" int64_t bgt_host_counts(const uint32_t* p0, const uint32_t* p1,
                                   const int64_t* rows, int64_t n_rows,
                                   int32_t n_words, const uint32_t* masks,
                                   int32_t n_g, const int32_t* mask_pop,
                                   int32_t* out, int32_t n_threads) {
    if (n_threads < 1) n_threads = 1;
    // the memmapped planes sit at header offset 20/28, so 64-bit views are
    // 4-byte aligned: load via memcpy (compiles to unaligned movs, no UB)
    auto ld64 = [](const void* p, int64_t w) {
        uint64_t v;
        memcpy(&v, (const uint8_t*)p + w * 8, 8);
        return v;
    };
    auto work = [&](int64_t lo, int64_t hi) {
        int32_t w64 = n_words / 2;
        for (int64_t i = lo; i < hi; ++i) {
            const uint32_t* r0 = p0 + rows[i] * n_words;
            const uint32_t* r1 = p1 + rows[i] * n_words;
            int32_t* o = out + i * n_g * 4;
            for (int32_t g = 0; g < n_g; ++g) {
                const uint32_t* m = masks + (size_t)g * n_words;
                int64_t n10 = 0, n11 = 0, nb = 0;
                for (int32_t w = 0; w < w64; ++w) {
                    uint64_t mw = ld64(m, w);
                    uint64_t aw = ld64(r0, w);
                    uint64_t bw = ld64(r1, w);
                    n10 += __builtin_popcountll(aw & mw);
                    n11 += __builtin_popcountll(bw & mw);
                    nb += __builtin_popcountll(aw & bw & mw);
                }
                int32_t cnt1 = (int32_t)(n10 - nb);
                int32_t cnt2 = (int32_t)(n11 - nb);
                o[g * 4 + 0] = mask_pop[g] - cnt1 - cnt2 - (int32_t)nb;
                o[g * 4 + 1] = cnt1;
                o[g * 4 + 2] = cnt2;
                o[g * 4 + 3] = (int32_t)nb;
            }
        }
    };
    if (n_words % 2 != 0) return -1;  // planes are 1024-bit aligned
    if (n_threads == 1 || n_rows < 1024) {
        work(0, n_rows);
        return 0;
    }
    std::vector<std::thread> ts;
    int64_t per = (n_rows + n_threads - 1) / n_threads;
    for (int32_t t = 0; t < n_threads; ++t) {
        int64_t lo = t * per, hi = std::min<int64_t>(n_rows, lo + per);
        if (lo >= hi) break;
        ts.emplace_back(work, lo, hi);
    }
    for (auto& t : ts) t.join();
    return 0;
}

// ---------------------------------------------------------------------------
// Native allele set: hashed canonical allele keys with a batched site
// matcher (al_present semantics, reference bgt.c:252-270) — replaces the
// per-site Python key build + set probe for large -a/-d sets.
// ---------------------------------------------------------------------------

namespace {

struct AlSet {
    std::vector<uint8_t> cat;                       // owned key bytes
    std::unordered_map<std::string_view, int> keys; // view into cat
};

}  // namespace

extern "C" {

void* bgt_al_set_new(const uint8_t* key_cat, const int64_t* key_off,
                     int64_t n_keys) {
    auto* s = new AlSet();
    int64_t total = n_keys ? key_off[n_keys] : 0;
    s->cat.assign(key_cat, key_cat + total);
    s->keys.reserve((size_t)n_keys * 2);
    for (int64_t i = 0; i < n_keys; ++i) {
        std::string_view k((const char*)s->cat.data() + key_off[i],
                           (size_t)(key_off[i + 1] - key_off[i]));
        s->keys.emplace(k, 1);
    }
    return s;
}

int64_t bgt_al_set_len(void* h) { return (int64_t)((AlSet*)h)->keys.size(); }

int32_t bgt_al_set_contains(void* h, const uint8_t* key, int64_t len) {
    auto* s = (AlSet*)h;
    return s->keys.count(std::string_view((const char*)key, (size_t)len)) ? 1
                                                                          : 0;
}

void bgt_al_set_free(void* h) { delete (AlSet*)h; }

// kinds[i] = 1 (alt key in set), 2 (only ref key in set), 0 (neither) for
// each selected site row — bgt_al_from_bcf + al_present batched.
void bgt_al_match(void* h, const int64_t* rows, int64_t n_sel,
                  const int32_t* rid, const int64_t* pos, const int64_t* rlen,
                  const int64_t* ref_off, const int64_t* ref_len,
                  const uint8_t* ref_cat, const int64_t* alt_off,
                  const int64_t* alt_len, const uint8_t* alt_cat,
                  const uint8_t* ctg_cat, const int64_t* ctg_off,
                  const int64_t* ctg_len, uint8_t* kinds) {
    auto* s = (AlSet*)h;
    std::string key;
    for (int64_t i = 0; i < n_sel; ++i) {
        int64_t r = rows[i];
        const uint8_t* ref = ref_cat + ref_off[r];
        const uint8_t* alt = alt_cat + alt_off[r];
        int64_t lr = ref_len[r], la = alt_len[r];
        int64_t min_l = std::min(lr, la);
        int64_t shift = 0;
        while (shift < min_l && ref[shift] == alt[shift]) ++shift;
        key.clear();
        key.append((const char*)ctg_cat + ctg_off[rid[r]],
                   (size_t)ctg_len[rid[r]]);
        key.push_back(':');
        key += std::to_string(pos[r] + shift);
        key.push_back(':');
        key += std::to_string(rlen[r] - shift);
        key.push_back(':');
        size_t head = key.size();
        key.append((const char*)alt + shift, (size_t)(la - shift));
        if (s->keys.count(std::string_view(key))) {
            kinds[i] = 1;
            continue;
        }
        key.resize(head);
        key.append((const char*)ref + shift, (size_t)(lr - shift));
        kinds[i] = s->keys.count(std::string_view(key)) ? 2 : 0;
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Multithreaded BGZF deflate: the write-side block compressor (the native
// equivalent of the reference's pthread write pool, bgzf.c:381-535, which
// `bgt view -b` itself never enables — its deflate is single-threaded).
// Input is split into 0xff00-byte payloads; each worker owns a z_stream
// (deflateReset per block) and writes its framed blocks into a fixed
// 0x10000-byte slot; slots are then compacted in order.  Byte-identical to
// zlib's streaming output at the same level (raw deflate, windowBits -15,
// memLevel 8, default strategy — the reference's parameters).
// ---------------------------------------------------------------------------

extern "C" {

// Returns the total compressed length, or -1 on a deflate error.  `out`
// must have capacity n_blocks(data) * 0x10000 where
// n_blocks = ceil(len / 0xff00) (>=1 even for len==0 is NOT required:
// len==0 produces 0 blocks and returns 0).
int64_t bgt_bgzf_deflate(const uint8_t* data, int64_t len, int level,
                         int n_threads, uint8_t* out) {
    static const uint8_t kHdr[16] = {0x1f, 0x8b, 0x08, 0x04, 0, 0, 0, 0,
                                     0,    0xff, 0x06, 0,    0x42, 0x43,
                                     0x02, 0x00};
    const int64_t kPayload = 0xff00, kSlot = 0x10000;
    if (len <= 0) return 0;
    int64_t n_blocks = (len + kPayload - 1) / kPayload;
    if (n_threads < 1) n_threads = 1;
    if (n_threads > (int)n_blocks) n_threads = (int)n_blocks;
    std::vector<int32_t> sizes(n_blocks, -1);
    std::atomic<int64_t> next{0};
    std::atomic<bool> failed{false};
    auto work = [&]() {
        z_stream zs;
        std::memset(&zs, 0, sizeof(zs));
        if (deflateInit2(&zs, level, Z_DEFLATED, -15, 8,
                         Z_DEFAULT_STRATEGY) != Z_OK) {
            failed.store(true);
            return;
        }
        for (;;) {
            int64_t b = next.fetch_add(1);
            if (b >= n_blocks || failed.load(std::memory_order_relaxed))
                break;
            const uint8_t* src = data + b * kPayload;
            uint32_t n = (uint32_t)std::min(kPayload, len - b * kPayload);
            uint8_t* dst = out + b * kSlot;
            std::memcpy(dst, kHdr, 16);
            deflateReset(&zs);
            zs.next_in = const_cast<Bytef*>(src);
            zs.avail_in = n;
            zs.next_out = dst + 18;
            zs.avail_out = (uInt)(kSlot - 18 - 8);
            if (deflate(&zs, Z_FINISH) != Z_STREAM_END) {
                failed.store(true);
                break;
            }
            uint32_t body = (uInt)(kSlot - 18 - 8) - zs.avail_out;
            uint32_t bsize = body + 18 + 8;
            dst[16] = (uint8_t)((bsize - 1) & 0xff);
            dst[17] = (uint8_t)(((bsize - 1) >> 8) & 0xff);
            uint32_t crc = crc32(0, src, n);
            uint8_t* tail = dst + 18 + body;
            tail[0] = (uint8_t)(crc & 0xff);
            tail[1] = (uint8_t)((crc >> 8) & 0xff);
            tail[2] = (uint8_t)((crc >> 16) & 0xff);
            tail[3] = (uint8_t)((crc >> 24) & 0xff);
            tail[4] = (uint8_t)(n & 0xff);
            tail[5] = (uint8_t)((n >> 8) & 0xff);
            tail[6] = (uint8_t)((n >> 16) & 0xff);
            tail[7] = (uint8_t)((n >> 24) & 0xff);
            sizes[b] = (int32_t)bsize;
        }
        deflateEnd(&zs);
    };
    if (n_threads == 1) {
        work();
    } else {
        std::vector<std::thread> threads;
        for (int t = 0; t < n_threads; ++t) threads.emplace_back(work);
        for (auto& th : threads) th.join();
    }
    if (failed.load()) return -1;
    // compact the fixed slots into a contiguous stream (ordered writeback)
    int64_t w = sizes[0];
    for (int64_t b = 1; b < n_blocks; ++b) {
        std::memmove(out + w, out + b * kSlot, (size_t)sizes[b]);
        w += sizes[b];
    }
    return w;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// ksort.h introsort replica over an int64 index array ordered by key[x] >
// key[y] (descending counts): the -H report's tie order is set by this
// UNSTABLE algorithm (reference bgt.c:929, ksort.h), so byte parity needs
// the very same swap sequence — this is a line-for-line translation of
// bgt_tpu/core/introsort.py (itself the ksort.h replica), not a std::sort.
// ---------------------------------------------------------------------------

namespace {

struct IntroLt {
    const int64_t* key;
    bool operator()(int64_t x, int64_t y) const { return key[x] > key[y]; }
};

void intro_insertsort(int64_t* a, int64_t lo, int64_t hi, IntroLt lt) {
    for (int64_t i = lo + 1; i < hi; ++i)
        for (int64_t j = i; j > lo && lt(a[j], a[j - 1]); --j)
            std::swap(a[j], a[j - 1]);
}

void intro_combsort(int64_t* a, int64_t lo, int64_t n, IntroLt lt) {
    const double kShrink = 1.2473309501039786540366528676643;
    int64_t gap = n;
    for (;;) {
        if (gap > 2) {
            gap = (int64_t)(gap / kShrink);
            if (gap == 9 || gap == 10) gap = 11;
        }
        bool do_swap = false;
        for (int64_t i = lo; i < lo + n - gap; ++i) {
            int64_t j = i + gap;
            if (lt(a[j], a[i])) {
                std::swap(a[i], a[j]);
                do_swap = true;
            }
        }
        if (!(do_swap || gap > 2)) break;
    }
    if (gap != 1) intro_insertsort(a, lo, lo + n, lt);
}

}  // namespace

extern "C" void bgt_introsort_desc(int64_t* a, int64_t n,
                                   const int64_t* key) {
    IntroLt lt{key};
    if (n < 1) return;
    if (n == 2) {
        if (lt(a[1], a[0])) std::swap(a[0], a[1]);
        return;
    }
    int d = 2;
    while ((int64_t(1) << d) < n) ++d;
    struct Frame {
        int64_t s, t;
        int d;
    };
    std::vector<Frame> stack;
    int64_t s = 0, t = n - 1;
    d <<= 1;
    for (;;) {
        if (s < t) {
            if (--d == 0) {
                intro_combsort(a, s, t - s + 1, lt);
                t = s;
                continue;
            }
            int64_t i = s, j = t;
            int64_t k = i + ((j - i) >> 1) + 1;
            if (lt(a[k], a[i])) {
                if (lt(a[k], a[j])) k = j;
            } else {
                k = lt(a[j], a[i]) ? i : j;
            }
            int64_t rp = a[k];
            if (k != t) std::swap(a[k], a[t]);
            for (;;) {
                ++i;
                while (lt(a[i], rp)) ++i;
                --j;
                while (i <= j && lt(rp, a[j])) --j;
                if (j <= i) break;
                std::swap(a[i], a[j]);
            }
            std::swap(a[i], a[t]);
            if (i - s > t - i) {
                if (i - s > 16) stack.push_back({s, i - 1, d});
                s = (t - i > 16) ? i + 1 : t;
            } else {
                if (t - i > 16) stack.push_back({i + 1, t, d});
                t = (i - s > 16) ? i - 1 : s;
            }
        } else {
            if (stack.empty()) {
                intro_insertsort(a, 0, n, lt);
                return;
            }
            Frame f = stack.back();
            stack.pop_back();
            s = f.s;
            t = f.t;
            d = f.d;
        }
    }
}
