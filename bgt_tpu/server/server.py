"""HTTP query server (twin of the reference Go server, bgt-server.go).

GET parameters mirror ``bgt view`` flags: s/r/i/n/a/f/t/g/C/S/H, with
``.and.``/``.or.`` operator rewriting (``&&`` clashes with the query-string
separator), MGS privacy enforcement via 403, per-query genotype quota with a
trailing ``*`` truncation marker, and a self-documenting help page on a bare
request (bgt-server.go:159-373).

Databases are opened once and shared read-only across request threads (each
request builds its own reader state); the device tile store is likewise
shared, so concurrent queries ride the same HBM-resident matrix.
"""

from __future__ import annotations

import os
import sys
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qsl, urlsplit

from ..formats import bcf as bcflib
from ..formats.fmf import Fmf
from ..io import files
from ..query.engine import (F_CNT_AL, F_CNT_HAP, F_NO_GT, F_SET_AC, BgtFile,
                            BgtmReader)


class ServerConfig:
    def __init__(self):
        self.port = 8000
        self.max_gt = 10_000_000
        self.min_group = 0
        self.vardb: Fmf | None = None
        self.files: list[BgtFile] = []
        self.prefixes: list[str] = []


def _replace_op(t: str) -> str:
    return (t.replace(".AND.", "&&").replace(".and.", "&&")
            .replace(".OR.", "||").replace(".or.", "||"))


def help_text(cfg: ServerConfig, host: str) -> str:
    out = []
    w = out.append
    w("Server Configuration")
    w("====================\n")
    w("The following configurations were set when the server was launched. "
      "Clients can't override them.\n")
    w(" * BGT file prefix(es) and queryable sample annotations:")
    for i, bf in enumerate(cfg.files):
        w(f"   - {cfg.prefixes[i]}: {bf.f.keys}")
    w("")
    if cfg.vardb is not None:
        w(f" * Queryable variant annotations: {cfg.vardb.keys}\n")
    else:
        w(" * No variant annotations specified.\n")
    w(" * This server may report individual genotypes.\n")
    w(f" * Maximal genotypes processed internally per query: {cfg.max_gt}\n")
    w("Accepted Parameters")
    w("===================\n")
    w("  s EXPR  sample list (,sample1,sample2) or metadata expression; each 's' defines a group")
    w("  r STR   region like '11:200,000-300,000'")
    w("  i INT   start from the i-th record (INT>0)")
    w("  n INT   read at most INT records")
    w("  a EXPR  allele list chr:1basedPos:refLen:alleleSeq, or expression over variant annotations")
    w("  f EXPR  site filter over AC, AN, AC#, AN# (use .and. / .or. for logical operators)")
    w("  g       output sample genotypes")
    w("  C       output AC/AN INFO fields (automatic with 's')")
    w("  S       output samples having requested alleles (with 'a')")
    w("  H       output counts of haplotypes across requested alleles (with 'a')")
    w("  t STR   tabular output fields: CHROM, POS, END, REF, ALT, AC, AN, AC#, AN#")
    return "\n".join(out) + "\n"


class _ClientGone(BaseException):
    """Raised inside the producer when the consumer abandoned the stream."""


class _StreamWriter:
    """Text-IO-shaped sink pushing byte chunks into a bounded queue.

    The fastpath engine runs in a worker thread and writes here; the HTTP
    generator drains the queue, so bytes reach the client while the query
    is still decoding and peak memory is bounded by the queue, not the
    response size (reference bgt-server.go:330-352 streams per record).
    """

    _DONE = object()

    def __init__(self, maxsize: int = 64):
        import queue
        self.q: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self.stopped = False  # set by the consumer on client disconnect
        self._full_exc = queue.Full
        outer = self

        class _B:
            def write(self, data):
                outer._put(bytes(data))
                return len(data)

            def flush(self):
                pass

        self.buffer = _B()

    def _put(self, item) -> None:
        while True:
            if self.stopped:
                raise _ClientGone()
            try:
                self.q.put(item, timeout=0.1)
                return
            except self._full_exc:
                continue

    def write(self, s: str) -> int:
        self._put(s.encode("latin-1"))
        return len(s)

    def flush(self) -> None:
        pass

    def close_producer(self) -> None:
        self._put(self._DONE)

    def drain(self):
        """Yield chunks until the producer signals completion."""
        while True:
            item = self.q.get()
            if item is self._DONE:
                return
            yield item


def run_query(cfg: ServerConfig, form: dict):
    """Execute one request; returns (http_status, chunk iterator).

    VCF/table queries without allele sets run on the batched device engine
    (fastpath), with the genotype quota applied as a site cutoff before
    emission; everything else takes the per-site general path, streaming
    each record as a chunk (reference bgt-server.go:330-352).
    """
    flag = F_NO_GT
    max_read = 2147483647
    vcf_out = True
    bm = BgtmReader(cfg.files)
    try:
        bm.set_mgs(cfg.min_group)
        if "g" in form:
            flag &= ~F_NO_GT
        if "C" in form or "s" in form:
            flag |= F_SET_AC
        if "S" in form:
            flag |= F_CNT_AL
        if "H" in form:
            flag |= F_CNT_HAP
        bm.set_flag(flag)
        if flag & (F_CNT_AL | F_CNT_HAP):
            vcf_out = False
        seekn = -1
        if "f" in form:
            if bm.set_flt_site(_replace_op(form["f"][0])) != 0:
                return 400, iter(["400 Bad Request: failed to parse parameter 'f'\n"])
        if "r" in form:
            if bm.set_region(form["r"][0]) < 0:
                return 400, iter(["400 Bad Request: failed to set region with parameter 'r'\n"])
        if "i" in form:
            try:
                i = int(form["i"][0])
            except ValueError:
                i = 0
            if i < 1:
                return 400, iter(["400 Bad Request: failed to set start with parameter 'i'\n"])
            bm.set_start(i)
            seekn = i - 1
        if "n" in form:
            try:
                max_read = int(form["n"][0])
            except ValueError:
                max_read = 0
        if "t" in form:
            vcf_out = False
            if bm.set_table(form["t"][0]) < 0:
                return 400, iter(["400 Bad Request: failed to parse tabular format with parameter 't'\n"])
        if "a" in form:
            n_al = bm.set_alleles(_replace_op(form["a"][0]), cfg.vardb, None)
            if n_al < 0:
                return 400, iter(["400 Bad Request: failed to retrieve alleles with parameter 'a'\n"])
            if n_al == 0:
                return 204, iter(["204 No Content: no alleles matching parameter 'a'\n"])
        if "s" in form:
            for s in form["s"]:
                if bm.add_group(_replace_op(s)) < 0:
                    return 400, iter(["400 Bad Request: failed to set sample group with parameter 's'\n"])
        bm.prepare()
        if not bm.test_mgs():
            return 403, iter(["403 Forbidden: genotype summary can't be computed "
                              "for small sample groups\n"])
    except Exception:
        bm.close()
        raise

    # batched engine for the whole query surface, including the -S/-H
    # accumulators (batched over the tile store since r3)
    from ..query import fastpath

    class _Opt:
        pass

    opt = _Opt()
    opt.n_rec = None
    opt.seekn = seekn
    opt.max_gt = cfg.max_gt
    opt.srv_max_read = max_read
    opt.not_vcf = not vcf_out

    def gen_fast():
        import threading
        w = _StreamWriter()
        err: list[BaseException] = []
        # bm may only be closed once BOTH sides are done with it: if the
        # client abandons the stream while the producer sits inside one
        # long native/device call (it only observes ``stopped`` at its
        # next write), closing the readers/mmaps under it would be a
        # use-after-close -> possible SIGSEGV.  Whoever finishes last
        # closes.
        state = {"left": 0}
        state_mu = threading.Lock()

        def leave():
            with state_mu:
                state["left"] += 1
                last = state["left"] == 2
            if last:
                bm.close()

        def work():
            try:
                fastpath.FastView(bm, opt).run(w)
            except _ClientGone:
                pass
            except BaseException as e:  # noqa: BLE001 - reported via err
                err.append(e)
            finally:
                try:
                    w.close_producer()
                except _ClientGone:
                    pass
                leave()

        t = threading.Thread(target=work, daemon=True,
                             name="bgt-stream-producer")
        started = False
        try:
            if vcf_out:
                yield (bm.h_out.text + "\n").encode("latin-1")
            t.start()
            started = True
            yield from w.drain()
            if err:
                raise err[0]
            if not vcf_out and len(bm.aal) > 0:
                if flag & F_CNT_HAP:
                    yield bm.hapcnt_print().encode("latin-1")
                if flag & F_CNT_AL:
                    yield bm.alcnt_print().encode("latin-1")
            if bm.truncated:
                yield b"*\n"
        finally:
            # client gone or done: release the producer (it checks
            # ``stopped`` on every put); the close handshake runs when the
            # second side leaves, however long the producer's current call
            # takes
            w.stopped = True
            if started:
                t.join(timeout=5.0)
                leave()
            else:
                bm.close()

    return 200, gen_fast()


class _Handler(BaseHTTPRequestHandler):
    cfg: ServerConfig = None
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        print(f"[{time.time_ns()}] {fmt % args}", file=sys.stderr)

    def do_GET(self):
        url = urlsplit(self.path)
        raw = url.query.replace("&&", ".AND.")
        pairs = parse_qsl(raw, keep_blank_values=True)
        form: dict[str, list[str]] = {}
        for k, v in pairs:
            form.setdefault(k, []).append(v)
        if not form:
            body = help_text(self.cfg, self.headers.get("Host", "localhost"))
            self._send_whole(200, body.encode("latin-1", errors="replace"))
            return
        try:
            status, chunks = run_query(self.cfg, form)
        except Exception as e:  # noqa: BLE001
            self._send_whole(500, f"500 Internal Server Error: {e}\n".encode())
            return
        # stream the body with chunked transfer encoding: records flow as
        # they are produced and GB-scale dumps never buffer whole
        # (reference bgt-server.go:330-352 streams per record)
        self.send_response(status)
        self.send_header("Content-Type", "text/plain; charset=utf-8")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        try:
            try:
                for data in chunks:
                    if isinstance(data, str):
                        data = data.encode("latin-1", errors="replace")
                    if not data:
                        continue
                    self.wfile.write(b"%x\r\n" % len(data))
                    self.wfile.write(data)
                    self.wfile.write(b"\r\n")
            except Exception as e:  # noqa: BLE001 - headers already sent
                msg = f"\n500 Internal Server Error: {e}\n".encode()
                self.wfile.write(b"%x\r\n" % len(msg))
                self.wfile.write(msg)
                self.wfile.write(b"\r\n")
            self.wfile.write(b"0\r\n\r\n")
        except BrokenPipeError:
            pass
        finally:
            # deterministically release the producer thread + readers
            close = getattr(chunks, "close", None)
            if close is not None:
                close()

    def _send_whole(self, status: int, data: bytes) -> None:
        self.send_response(status)
        self.send_header("Content-Type", "text/plain; charset=utf-8")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


def make_server(cfg: ServerConfig) -> ThreadingHTTPServer:
    handler = type("Handler", (_Handler,), {"cfg": cfg})
    return ThreadingHTTPServer(("", cfg.port), handler)


def main_server(argv: list[str]) -> int:
    import getopt as _getopt
    cfg = ServerConfig()
    if os.environ.get("PORT"):
        cfg.port = int(os.environ["PORT"])
    opts, args = _getopt.getopt(argv, "d:p:m:g:")
    for c, val in opts:
        if c == "-p":
            cfg.port = int(val)
        elif c == "-m":
            cfg.max_gt = int(val)
        elif c == "-d":
            cfg.vardb = Fmf.read(val)
        elif c == "-g":
            cfg.min_group = int(val)
    if not args:
        print("Usage: bgt server [options] <bgt.pre1> [...]\n"
              "Options:\n"
              f"  -p INT    port number [{cfg.port} or from $PORT env]\n"
              f"  -m INT    maximal genotypes processed per query [{cfg.max_gt}]\n"
              "  -d FILE   variant annotations in the FMF format []\n"
              "  -g INT    minimal sample group size (force -G if positive) [0]",
              file=sys.stderr)
        return 1
    files.no_file = True  # server mode: expressions never name local files
    cfg.files = [BgtFile(p) for p in args]
    cfg.prefixes = [os.path.basename(p) for p in args]
    srv = make_server(cfg)
    print(f"[{time.time_ns()}] launched at port {cfg.port}", file=sys.stderr)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0
