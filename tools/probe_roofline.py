"""Kernel-decision probe for the masked-popcount count kernel.

Times, on the device JAX finds, over random planes at the HRC tile width
(2,048 uint32 words per plane row, ~150k rows):

- the production XLA fusion (``ops.counts.count_codes``) at 1, 2 and 32
  masks;
- a popcount-reduce proxy over both planes (one read of the planes, one
  popcount per word: what the count pass costs at 1 mask at best);
- a plain device copy of one plane (read + write: what the card's memory
  reaches).

Each number is the best of three runs of ``--calls`` back-to-back calls
ending in ``block_until_ready``.  Every rate is printed beside the card's
name and power limit (``nvidia-smi``) and its share of the published HBM
peak (``bench.HBM_PEAK_GBS``; an unknown device kind is an error).  It also
writes the compiled HLO of the fusion at 32 masks and counts its fusions:
several fusions that each re-read the planes are where a hand kernel would
win.

    python tools/probe_roofline.py [--rows N] [--calls N] [--out DIR]

Writes DIR/roofline.json and DIR/count_g32.hlo.txt (DIR: build/probe/).
"""

from __future__ import annotations

import argparse
import functools
import json
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

WORDS = 2048
GROUPS = (1, 2, 32)


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def seconds_per_call(fn, *args, calls: int) -> float:
    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(calls):
            out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / calls)
    return best


def fusion_summary(hlo: str) -> dict:
    """Fusions in the entry computation and how many read a plane."""
    entry = hlo[hlo.index("ENTRY"):]
    fusions = re.findall(r"\bfusion\(([^)]*)\)", entry)
    params = re.findall(r"(\S+) = \S+ parameter\(([01])\)", entry)
    plane_names = {name for name, _ in params}
    readers = sum(any(op.strip().lstrip("%") in
                      {p.lstrip("%") for p in plane_names}
                      for op in args.split(","))
                  for args in fusions)
    return {"fusions": len(fusions), "fusions_reading_a_plane": readers}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=150_000)
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--out", default=str(REPO / "build" / "probe"))
    args = ap.parse_args()
    from bench import hbm_peak_gbs
    from bgt_tpu.ops import counts

    dev = jax.devices()[0]
    assert dev.platform == "gpu", f"no GPU: first device is {dev.platform}"
    peak = hbm_peak_gbs(dev.device_kind)
    where = card()
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    res = {"device_kind": dev.device_kind, "card": where, "rows": args.rows,
           "words": WORDS, "calls": args.calls, "hbm_peak_gbs": peak}
    print(f"card: {where}; jax {jax.__version__}", flush=True)

    key = jax.random.key(0)
    k0, k1, km = jax.random.split(key, 3)
    bits = functools.partial(jax.random.bits, dtype=jnp.uint32)
    p0 = bits(k0, (args.rows, WORDS))
    p1 = bits(k1, (args.rows, WORDS))
    masks = bits(km, (max(GROUPS), WORDS))
    plane_bytes = 2 * p0.nbytes

    def record(name, t, nbytes, **extra):
        gbs = nbytes / t / 1e9
        res[name] = {"ms": t * 1e3, "gbs": gbs, "hbm_share": gbs / peak,
                     **extra}
        print(f"{name}: {t * 1e3:.4f} ms, {gbs:.1f} GB/s "
              f"({gbs / peak:.3f} of {peak:.0f} GB/s) [{where}]", flush=True)

    copy = jax.jit(lambda x: x ^ jnp.uint32(1))
    record("copy_1plane", seconds_per_call(copy, p0, calls=args.calls),
           2 * p0.nbytes, note="read + write of one plane")
    proxy = jax.jit(lambda a, b: (
        jax.lax.population_count(a).sum(axis=1, dtype=jnp.int32)
        + jax.lax.population_count(b).sum(axis=1, dtype=jnp.int32)))
    record("popcount_reduce_2planes",
           seconds_per_call(proxy, p0, p1, calls=args.calls), plane_bytes)

    for g in GROUPS:
        pops = 3 * g * args.rows * WORDS
        t = seconds_per_call(counts.count_codes, p0, p1, masks[:g],
                             calls=args.calls)
        record(f"xla_g{g}", t, plane_bytes, gpopcount_per_s=pops / t / 1e9)

    hlo = counts.count_codes.lower(p0, p1, masks).compile().as_text()
    (out_dir / "count_g32.hlo.txt").write_text(hlo)
    res["xla_g32_hlo"] = fusion_summary(hlo)
    print(f"xla g=32 compiled HLO: {res['xla_g32_hlo']}", flush=True)
    (out_dir / "roofline.json").write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
