#!/usr/bin/env python
"""Count-kernel scaling methodology: device-mesh and process scaling.

Measures the psum-merged sharded count kernel (the hot reduction of every
query, reference bgt.c:735-757) across
  - 1/2/4/8 virtual devices in one process (weak + strong scaling),
  - a 2-axis (site x sample) mesh,
  - the flat multi-device dispatch overhead and the row-count crossover
    where the mesh starts beating a single device, and
  - 1 vs 2 jax.distributed processes over one mesh (the multi-host seam).

Methodology notes (round-4 revision):
  - Each virtual CPU device is pinned to ONE compute thread
    (--xla_cpu_multi_thread_eigen=false).  Without this a 1-device
    baseline already uses every core via XLA's intra-op threading, so
    sharding could never measure above ~1/n "efficiency" — the flag makes
    a virtual device model one chip.  This host has few physical cores;
    device counts beyond them oversubscribe and their efficiencies are
    reported for completeness only (`physical_cores` says where that
    starts).  On real cards each shard is a GPU and the psum rides NVLink;
    this harness cannot measure that.
  - Timing forces the result to host with np.asarray (the production
    readback); block_until_ready alone under-reports on this backend.
  - Strong scaling runs at a row count where plane bandwidth dominates
    the flat dispatch overhead (measured separately), per the round-3
    verdict; the crossover feeds fastpath._shard_min_rows.

Prints ONE JSON line: {"scaling": {...}}.
"""

import json
import os
import re
import socket
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

ONE_THREAD = "--xla_cpu_multi_thread_eigen=false"

DEV_RUNNER = r"""
import os, sys, time
n_dev = int(sys.argv[1]); words = int(sys.argv[2]); rows = int(sys.argv[3])
mesh2_rows = int(sys.argv[4])  # 0 = 1-axis mesh
os.environ["XLA_FLAGS"] = (
    f"--xla_force_host_platform_device_count={n_dev} " + ONE_THREAD)
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, REPO)
import numpy as np
from bgt_tpu.parallel import mesh as meshlib
rng = np.random.default_rng(0)
# tile a random block: the kernel is data-independent, so cheap synthesis
# (memcpy-speed) replaces multi-GB RNG draws
blk = rng.integers(0, 2**32, (min(rows, 4096), words), dtype=np.uint32)
reps = (rows + blk.shape[0] - 1) // blk.shape[0]
p0 = np.tile(blk, (reps, 1))[:rows]
p1 = np.tile(blk[::-1], (reps, 1))[:rows]
masks = rng.integers(0, 2**32, (2, words), dtype=np.uint32)
if mesh2_rows > 0:
    mesh = meshlib.make_mesh2(mesh2_rows)
    d0, d1, dm = meshlib.shard_planes2(mesh, p0, p1, masks)
    fn2 = meshlib.sharded_count2_fn(mesh)
    call = lambda: fn2(d0, d1, dm)
else:
    mesh = meshlib.make_mesh()
    d0, d1, dm = meshlib.shard_planes(mesh, p0, p1, masks)
    fn = meshlib.sharded_count_range_fn(mesh)
    call = lambda: fn(d0, d1, dm, 0, rows)
np.asarray(call())  # warm: compile + first readback
best = float("inf")
for _ in range(2):
    t0 = time.perf_counter()
    np.asarray(call())  # production sync: counts come back to the host
    best = min(best, time.perf_counter() - t0)
print(f"RESULT {best:.6f}", flush=True)
"""

PROC_RUNNER = r"""
import os, sys, time
pid = int(sys.argv[1]); n_proc = int(sys.argv[2]); port = sys.argv[3]
dev_per_proc = int(sys.argv[4]); words_total = int(sys.argv[5])
rows = int(sys.argv[6])
os.environ["XLA_FLAGS"] = (
    f"--xla_force_host_platform_device_count={dev_per_proc} " + ONE_THREAD)
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
if n_proc > 1:
    jax.distributed.initialize(coordinator_address="127.0.0.1:" + port,
                               num_processes=n_proc, process_id=pid)
sys.path.insert(0, REPO)
import numpy as np
from bgt_tpu.parallel import distributed, mesh as meshlib
mesh = distributed.global_mesh()
n_dev = mesh.devices.size
words = meshlib.pad_words_for_mesh(words_total, n_dev)
rng = np.random.default_rng(0)
blk = rng.integers(0, 2**32, (min(rows, 4096), words), dtype=np.uint32)
reps = (rows + blk.shape[0] - 1) // blk.shape[0]
full0 = np.tile(blk, (reps, 1))[:rows]
full1 = np.tile(blk[::-1], (reps, 1))[:rows]
masks = rng.integers(0, 2**32, (2, words), dtype=np.uint32)
lo, hi = distributed.local_column_range(words, mesh)
p0 = distributed.place_local(mesh, full0[:, lo:hi])
p1 = distributed.place_local(mesh, full1[:, lo:hi])
mk = distributed.place_local(mesh, masks[:, lo:hi])
fn = meshlib.sharded_count_range_fn(mesh)
np.asarray(fn(p0, p1, mk, 0, rows))
best = float("inf")
for _ in range(3):
    t0 = time.perf_counter()
    np.asarray(fn(p0, p1, mk, 0, rows))
    best = min(best, time.perf_counter() - t0)
if pid == 0:
    print(f"RESULT {best:.6f}", flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def _clean_env():
    return {k: v for k, v in os.environ.items()
            if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}


def _parse(out: str) -> float:
    m = re.search(r"RESULT ([0-9.eE+-]+)", out)
    if not m:
        raise RuntimeError(f"no RESULT in: {out[-500:]}")
    return float(m.group(1))


def run_device(n_dev: int, words: int, rows: int, mesh2_rows: int = 0) -> float:
    script = (f"REPO = {str(REPO)!r}\nONE_THREAD = {ONE_THREAD!r}\n"
              + DEV_RUNNER)
    res = subprocess.run(
        [sys.executable, "-c", script, str(n_dev), str(words), str(rows),
         str(mesh2_rows)],
        env=_clean_env(), capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(res.stderr[-800:])
    return _parse(res.stdout)


def run_procs(n_proc: int, total_devices: int, words: int, rows: int) -> float:
    port = str(_free_port())
    script = (f"REPO = {str(REPO)!r}\nONE_THREAD = {ONE_THREAD!r}\n"
              + PROC_RUNNER)
    dev_per_proc = total_devices // n_proc
    procs = [
        subprocess.Popen([sys.executable, "-c", script, str(pid), str(n_proc),
                          port, str(dev_per_proc), str(words), str(rows)],
                         env=_clean_env(), stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
        for pid in range(n_proc)
    ]
    out0 = ""
    for pid, p in enumerate(procs):
        out, err = p.communicate(timeout=600)
        if p.returncode != 0:
            raise RuntimeError(err[-800:])
        if pid == 0:
            out0 = out
    return _parse(out0)


def main() -> dict:
    cores = os.cpu_count() or 1
    result: dict = {
        "method": "sharded count kernel (psum over sample axis); "
                  "1 thread per virtual device "
                  "(--xla_cpu_multi_thread_eigen=false), best-of-3, "
                  "np.asarray sync; device counts beyond physical_cores "
                  "oversubscribe and measure software overhead only",
        "physical_cores": cores,
    }
    # flat multi-device dispatch overhead (tiny rows: all overhead)
    overhead = {}
    for n in (1, 2, 4, 8):
        overhead[str(n)] = round(run_device(n, 256 * n, 256), 6)
    result["dispatch_overhead_s"] = overhead
    # strong scaling at a bandwidth-dominated shape (round-3 verdict:
    # re-measure at >=1M rows so the flat dispatch cost amortizes)
    strong_rows, strong_words = 1 << 19, 512
    result["strong_rows"] = strong_rows
    strong = {}
    t1 = None
    for n in (1, 2, 4, 8):
        t = run_device(n, strong_words, strong_rows)
        e = {"s_per_iter": round(t, 6),
             "gb_per_s": round(strong_rows * strong_words * 8 / t / 1e9, 2)}
        if n == 1:
            t1 = t
        else:
            e["efficiency"] = round(t1 / (t * n), 3)
            e["oversubscribed"] = n > cores
        strong[str(n)] = e
    result["strong_devices"] = strong
    # 2-axis (site x sample) mesh at the same strong shape
    try:
        t22 = run_device(4, strong_words, strong_rows, mesh2_rows=2)
        result["mesh2_2x2"] = {
            "s_per_iter": round(t22, 6),
            "efficiency_vs_1dev": round(t1 / (t22 * 4), 3),
            "oversubscribed": 4 > cores,
        }
    except (RuntimeError, subprocess.TimeoutExpired) as e:
        result["mesh2_2x2"] = {"error": str(e)[:200]}
    # weak scaling: constant words per device
    weak = {}
    w1 = None
    base_words, weak_rows = 512, 1 << 17
    for n in (1, 2, 4, 8):
        t = run_device(n, base_words * n, weak_rows)
        gt = weak_rows * base_words * n * 32
        e = {"s_per_iter": round(t, 6),
             "gcounts_per_s": round(gt / t / 1e9, 2)}
        if n == 1:
            w1 = t
        else:
            e["efficiency"] = round(w1 / t, 3)
            e["oversubscribed"] = n > cores
        weak[str(n)] = e
    result["weak_devices"] = weak
    # crossover: smallest row count where the 2-device mesh beats 1 device
    cross = {}
    crossover = None
    for rows in (8192, 131072):
        a = run_device(1, 2048, rows)
        b = run_device(2, 2048, rows)
        cross[str(rows)] = {"t1": round(a, 6), "t2": round(b, 6)}
        if crossover is None and b < a:
            crossover = rows
    result["crossover"] = {
        "rows_vs_1dev": cross,
        "crossover_rows": crossover,
        "production_gate": "fastpath._shard_min_rows "
                           "(BGT_TPU_SHARD_MIN_ROWS, default 65536)",
    }
    # process scaling (the multi-host seam): 1 vs 2 processes
    try:
        tp1 = run_procs(1, 2, 2048, 1 << 17)
        tp2 = run_procs(2, 2, 2048, 1 << 17)
        result["processes"] = {
            "1": {"s_per_iter": round(tp1, 6)},
            "2": {"s_per_iter": round(tp2, 6),
                  "efficiency": round(tp1 / tp2, 3)},
        }
    except (RuntimeError, subprocess.TimeoutExpired) as e:
        result["processes"] = {"error": str(e)[:200]}
    return result


if __name__ == "__main__":
    print(json.dumps({"scaling": main()}))
