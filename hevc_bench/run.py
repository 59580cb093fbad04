#!/usr/bin/env python3
"""One run of one benchmark cell of homerhevc_tpu_torch on the CUDA card.

    python hevc_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. The cell names a configuration and a
traffic mix in BENCHMARK.json; see hevc_bench/README.md. The last line of
standard output is the run's result as one JSON object.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# import the harness as the package hevc_bench, not this folder's modules
# by their bare names
sys.path[0] = ROOT


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from hevc_bench import harness
    return harness.main(args, root=ROOT, t_start=T_START)


if __name__ == "__main__":
    sys.exit(main())
