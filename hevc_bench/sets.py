#!/usr/bin/env python3
"""Runs of benchmark cells in turn, one process each, and their spreads.

    python3 hevc_bench/sets.py --cells <cell>[,<cell>...] --seeds <n>[,<n>...]
        [--seconds S] [--trace 0|1] [--sets K] [--out DIR]

Each cell runs once per seed, `--sets` times over (the same seeds in every
set), as `hevc_bench/run.py` with the manifest's `run_seconds` unless
`--seconds` is given. Every result line, with the end of each run's
standard error, goes to DIR/<cell>.jsonl; the summary printed at the end
gives, per cell, set and metric, the median and the spread (the distance
between the first and the third quartile of `statistics.quantiles(n=4)`,
as a share of the median), and the number of runs that were correct.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spread(values):
    if len(values) < 2:
        return float("nan")
    q1, _, q3 = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return (q3 - q1) / med if med else float("nan")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out"))
    args = ap.parse_args(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    seconds = args.seconds or manifest["run_seconds"]
    seeds = [int(s) for s in args.seeds.split(",")]
    os.makedirs(args.out, exist_ok=True)
    summary = []
    for cell in args.cells.split(","):
        for k in range(args.sets):
            lines = []
            for seed in seeds:
                cmd = [sys.executable, os.path.join(ROOT, "hevc_bench",
                                                    "run.py"),
                       "--workload", cell, "--seed", str(seed), "--seconds",
                       str(seconds), "--trace", str(args.trace)]
                t0 = time.perf_counter()
                res = subprocess.run(cmd, cwd=ROOT, capture_output=True,
                                     text=True)
                wall = time.perf_counter() - t0
                out = res.stdout.strip().splitlines()
                try:
                    line = json.loads(out[-1]) if out else None
                except json.JSONDecodeError:
                    line = None
                rec = dict(cell=cell, set=k, seed=seed, rc=res.returncode,
                           wall_s=wall, result=line,
                           stderr=res.stderr[-4000:])
                with open(os.path.join(args.out, cell + ".jsonl"), "a") as f:
                    f.write(json.dumps(rec) + "\n")
                print(f"{cell} set {k} seed {seed}: rc {res.returncode}, "
                      f"{wall:.1f} s, "
                      + (json.dumps({m: v["value"] for m, v in
                                     line["metrics"].items()})
                         + f" correct {line['correct']}" if line
                         else "no result"), flush=True)
                if line is None or res.returncode:
                    print(res.stderr[-3000:], flush=True)
                else:
                    lines.append(line)
            names = sorted({m for ln in lines for m in ln["metrics"]})
            for m in names:
                vals = [ln["metrics"][m]["value"] for ln in lines
                        if m in ln["metrics"]]
                summary.append(f"{cell} set {k} {m}: median "
                               f"{statistics.median(vals):.6g}, spread "
                               f"{spread(vals):.4%}, n {len(vals)}")
            summary.append(f"{cell} set {k}: correct "
                           f"{sum(ln['correct'] for ln in lines)} of "
                           f"{len(seeds)}")
    print("\n".join(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
