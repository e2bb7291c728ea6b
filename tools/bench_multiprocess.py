#!/usr/bin/env python
"""Multi-process count-kernel scaling: N jax.distributed processes, one mesh.

Each process holds its word-column slice of synthetic packed planes on its
local devices; the benchmark times the psum-merged sharded count kernel
(the hot reduction of every query, reference bgt.c:735-757) and prints the
global genotype-count throughput.  Run it once per process count:

    python tools/bench_multiprocess.py 1
    python tools/bench_multiprocess.py 2

On a real multi-host cluster each process maps to a host and the psum
rides the interconnect; on this CPU harness the processes share the machine's
cores, so the 2-process number demonstrates correctness of the multi-host
path and overhead of the cross-process collective, not hardware scaling.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

RUNNER = r"""
import os, sys, time
pid = int(sys.argv[1]); n_proc = int(sys.argv[2]); port = sys.argv[3]
dev_per_proc = int(sys.argv[4])
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={dev_per_proc}"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
if n_proc > 1:
    jax.distributed.initialize(coordinator_address="127.0.0.1:" + port,
                               num_processes=n_proc, process_id=pid)
sys.path.insert(0, REPO)
import numpy as np
from bgt_tpu.parallel import distributed, mesh as meshlib

rows, words_total, groups = 16384, 160, 2
mesh = distributed.global_mesh()
n_dev = mesh.devices.size
words = meshlib.pad_words_for_mesh(words_total, n_dev)
rng = np.random.default_rng(0)
full0 = rng.integers(0, 2**32, (rows, words), dtype=np.uint32)
full1 = rng.integers(0, 2**32, (rows, words), dtype=np.uint32)
masks = rng.integers(0, 2**32, (groups, words), dtype=np.uint32)
lo, hi = distributed.local_column_range(words, mesh)
p0 = distributed.place_local(mesh, full0[:, lo:hi])
p1 = distributed.place_local(mesh, full1[:, lo:hi])
mk = distributed.place_local(mesh, masks[:, lo:hi])
fn = meshlib.sharded_count_range_fn(mesh)
out = fn(p0, p1, mk, 0, rows); out.block_until_ready()   # compile
iters = 30
t0 = time.time()
for _ in range(iters):
    out = fn(p0, p1, mk, 0, rows)
out.block_until_ready()
dt = (time.time() - t0) / iters
gt = rows * words * 32
if pid == 0:
    print(f"RESULT {n_proc} proc: {dt*1e3:.2f} ms/iter, "
          f"{gt/dt/1e9:.2f} G genotype-counts/s", flush=True)
"""


def free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def run(n_proc: int, total_devices: int = 8) -> None:
    port = str(free_port())
    script = f"REPO = {str(REPO)!r}\n" + RUNNER
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    dev_per_proc = total_devices // n_proc
    procs = [
        subprocess.Popen([sys.executable, "-c", script, str(pid), str(n_proc),
                          port, str(dev_per_proc)], env=env)
        for pid in range(n_proc)
    ]
    for p in procs:
        p.wait(timeout=300)
        assert p.returncode == 0


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    run(n)
