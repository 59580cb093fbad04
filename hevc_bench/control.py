#!/usr/bin/env python3
"""The control of a cell's output check and its decision fault, on the
card, beside the program's own readings.

    python3 hevc_bench/control.py --workload <cell> --seeds <n>[,<n>...] \
        [--seconds S]

For each seed, in one process, the cell's session is set up and a window
of S seconds run as `run.py` runs it, and the check is read on the
sample drawn from the seed three times:

- for the program;
- for the control: the reference's own pictures at 7-bit precision in
  the place of the program's reference planes;
- for the decision fault: the same seed run again with the integer motion
  search handing back the zero vector for every block
  (`plant_zero_vectors`).

One JSON line per seed: the three sets of numbers, each beside its limit,
and whether each comes out correct. The benchmark's runs do not run the
control or the fault.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT


def plant_zero_vectors(setattr_):
    """Plant the decision fault with `setattr_(obj, name, value)`: the P
    stage's integer motion search (the hierarchical search above search
    24, the full sweep at or below it) keeps its costs and hands back the
    zero vector for every block, as a search that read no reference
    would."""
    import torch

    from homerhevc_tpu_torch.pipeline import p_torch
    hier, dense = p_torch._me_hier, p_torch.integer_me

    def me_hier(*a, **k):
        return {s: (torch.zeros_like(vy), torch.zeros_like(vx), cost)
                for s, (vy, vx, cost) in hier(*a, **k).items()}

    def integer_me(cur, ref, mvcost, *, B, search, **k):
        cost, best = dense(cur, ref, mvcost, B=B, search=search, **k)
        n = 2 * search + 1
        return cost, torch.full_like(best, search * n + search)
    setattr_(p_torch, "_me_hier", me_hier)
    setattr_(p_torch, "integer_me", integer_me)


class Patches:
    """setattr with undo."""

    def __init__(self):
        self.saved = []

    def __call__(self, obj, name, value):
        self.saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        while self.saved:
            setattr(*self.saved.pop())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args(argv)
    import torch

    from hevc_bench import check, harness
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    manifest = harness.Manifest(ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = harness.drive(manifest, args.workload, seed, args.seconds,
                            False, t_start=t0)
        start = harness.check_unit(run, seed)
        sound, failed = check.verify(run, start)
        notes, printed = run.check_notes, run.check_printed
        ctrl, _ = check.verify(run, start, control=True)
        patches = Patches()
        plant_zero_vectors(patches)
        try:
            bad = harness.drive(manifest, args.workload, seed, args.seconds,
                                False, t_start=time.perf_counter())
        finally:
            patches.undo()
        fault, _ = check.verify(bad, harness.check_unit(bad, seed))
        print(json.dumps(dict(
            workload=args.workload, seed=seed, frames=run.window_frames,
            correct=harness.is_correct(sound), failed=failed, checks=sound,
            notes=notes, printed=printed,
            control_correct=harness.is_correct(ctrl), control=ctrl,
            fault_correct=harness.is_correct(fault), fault=fault,
            fault_printed=bad.check_printed,
            wall_s=time.perf_counter() - t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
