"""Where the time goes in the torch port on one GPU at 1280x720.

    python3 tools/profile_torch_port.py [fastest|fast|default|full64|cbr|
                                         ibp_fastest|ibp_fast|fastest16|
                                         faster16]
                                        [--idr-ctus RxC] [--no-idr-profile]
                                        [--no-idr]

`fastest` is the fixed-CU configuration (FASTEST_COMPUTATION, search 16),
`fast` (the default) the one the repository's bench.py times
(FAST_COMPUTATION, search 64: quadtree P frames, split-RDO IDR), `default`
the JAX package's default configuration (64x64 CTUs, FAST_COMPUTATION,
search 16), `full64` FULL_COMPUTATION at CTU 64, search 64 (8x8 inter
CUs), and `cbr` the `fast` configuration under CBR at 400 kbps with WPP:
its P chunk codes per-CTU-row QPs, the frame QPs and row plans issued by
the session's rate control after the IDR, as encode_frames issues them.
`ibp_fastest` and `ibp_fast` are `fastest` and `fast` with B frames
(gop_size 2): the session codes I0, then P2 and B1 through push_frame, and
B1 is profiled alone: its device stage (b_torch.b_frame_device) under the
profiler, then each host step of the session's B frame between
synchronising timers (the wire copy, the merge/AMVP walk build_b_plans, the
AU assembly) beside the whole B frame; nothing else runs in these modes.
`fastest16` and `faster16` are `fastest` at cu_size 16 and FASTER at
cu_size 16 (the split-RDO IDR on 16-CTUs, the fixed-CU P stage at B 16).

For one P chunk of 8 frames (device stage only, no host CABAC) and for one
IDR device stage, after a warm-up, torch.profiler (CPU + CUDA activities)
gives: wall time, summed device kernel time, device busy share (kernel time
/ wall), kernel launches (in all, and per frame), and the top operators by
device time. Then the same P chunk runs once more with every stage of the
frame loop between synchronising host timers, which gives each stage's share
of the chunk (the synchronisation itself lengthens the whole a little, so
the shares are of the sum of the stages).

The split-RDO IDR of `fast` makes millions of launches, and a profile of the
whole picture does not end within a quarter of an hour on an H100's host.
Its launches go with the diagonals of the wavefront (every lane of a
diagonal is one batch), not with the picture's area, so by default it is
profiled on the top-left 3 x 8 CTUs of the picture (12 diagonals against 84)
and the launches per diagonal are printed (at CTU 64 on the top-left 2 x 4
CTUs, 6 diagonals against 42; at CTU 16 on the top-left 6 x 16 CTUs, the
same area, 26 diagonals against 168); its wall time on the whole picture is still
printed, unprofiled. `--idr-ctus RxC` sets the crop (`0x0`: the whole
picture, the default for `fastest`), `--no-idr` leaves out both the IDR's
timing and its profile (the session still codes one IDR for the reference
planes), `--no-idr-profile`
leaves the profile out. Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LAUNCH_KEYS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
               "cuLaunchKernelEx")


def _window(name, fn, per: int = 1, unit: str = "frame", warm: bool = True):
    import torch
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type.name == "CUDA")
    launches = sum(e.count for e in events if e.key in LAUNCH_KEYS)
    print(f"{name}: wall {wall * 1000:.1f} ms (profiler on), device kernels "
          f"{dev_us / 1000:.1f} ms, busy {dev_us / 1e6 / wall:.1%}, "
          f"{launches} kernel launches ({launches / per:.0f} per {unit})",
          flush=True)
    print(events.table(sort_by="self_device_time_total", row_limit=12,
                       max_name_column_width=48), flush=True)


def _synced_ms(fn) -> float:
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


class StageClock:
    """Synchronising host timers around named functions of the P frame
    loop; a stage called inside another is taken off its caller's time."""

    def __init__(self):
        self.ms = {}
        self._stack = []

    def wrap(self, module, attr, name=None):
        import torch
        name = name or attr
        fn = getattr(module, attr)

        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self._stack.append(0.0)
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                dt = (time.perf_counter() - t0) * 1e3
                inner = self._stack.pop()
                self.ms[name] = self.ms.get(name, 0.0) + dt - inner
                if self._stack:
                    self._stack[-1] += dt

        setattr(module, attr, timed)
        return lambda: setattr(module, attr, fn)

    def report(self, title, total_ms, frames):
        named = sum(self.ms.values())
        print(f"{title}: {total_ms:.1f} ms with the stage timers on; stages "
              f"sum to {named:.1f} ms, the rest (padding, selects, unit maps, "
              f"casts) {total_ms - named:.1f} ms")
        for k, v in sorted(self.ms.items(), key=lambda kv: -kv[1]):
            print(f"  {k:<34s} {v:9.1f} ms  {v / total_ms:6.1%}  "
                  f"{v / frames:8.2f} ms per frame")


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config", nargs="?", default="fast",
                    choices=("fastest", "fast", "default", "full64", "cbr",
                             "ibp_fastest", "ibp_fast", "fastest16",
                             "faster16"))
    ap.add_argument("--idr-ctus", default=None, metavar="RxC",
                    help="profile the IDR on the top-left R x C CTUs only "
                         "(default: 3x8 at CTU 32, 2x4 at CTU 64, 6x16 at "
                         "CTU 16, 0x0 = whole for fastest)")
    ap.add_argument("--no-idr-profile", action="store_true")
    ap.add_argument("--no-idr", action="store_true")
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from homerhevc_tpu_torch import tables
    from homerhevc_tpu_torch.api import HomerEncoder
    from homerhevc_tpu_torch.device import require_cuda
    from homerhevc_tpu_torch.pipeline import intra_torch, p_chunk, p_torch
    from homerhevc_tpu_torch.utils import fixtures as fx
    from homerhevc_tpu_torch.utils.synth import synth_clip

    dev = require_cuda()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    cfg = fx.config_from({
        "fastest": fx.slice_kwargs, "fast": fx.fast_kwargs,
        "default": fx.ctu64_kwargs,
        "full64": lambda w, h: fx.ctu64_kwargs(
            w, h, performance_mode="FULL_COMPUTATION", me_search_range=64),
        "cbr": lambda w, h: fx.fast_kwargs(
            w, h, bitrate_mode="CBR", bitrate=400, wpp=True),
        "ibp_fastest": lambda w, h: fx.slice_kwargs(w, h, gop_size=2),
        "ibp_fast": lambda w, h: fx.fast_kwargs(w, h, gop_size=2),
        "fastest16": lambda w, h: fx.slice_kwargs(w, h, cu_size=16),
        "faster16": lambda w, h: fx.slice_kwargs(
            w, h, cu_size=16, performance_mode="FASTER_COMPUTATION"),
    }[args.config](1280, 720))
    print(f"configuration {args.config}: {cfg.performance_mode.name}, "
          f"cu_size {cfg.cu_size}, search {cfg.me_search_range}, on {card}",
          flush=True)
    if cfg.gop_size >= 2:
        return profile_b_frame(cfg, dev)

    frames = list(synth_clip(1280, 720, 9, seed=0))
    enc = HomerEncoder(cfg, device=dev)
    t0 = time.perf_counter()
    enc.encode_frames(frames[:1])                  # IDR -> reference planes
    print(f"first IDR through the session (cold): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    padded = [enc._pad_frame(*f) for f in frames]
    y0, u0, v0 = (torch.as_tensor(p, device=dev) for p in padded[0])
    ys, us, vs = (torch.as_tensor(np.stack([p[k] for p in padded[1:9]]),
                                  device=dev) for k in range(3))
    # the frame QPs (and row plans) the session would issue for this chunk
    qp_l = [int(np.clip(enc._rc.frame_qp(False) if enc._rc else cfg.qp,
                        0, 51)) for _ in range(8)]
    qps = torch.as_tensor(qp_l, dtype=torch.int32, device=dev)
    qp_rows = None
    if enc._row_qp_on:
        plans = np.stack([enc._plan_rows(q) for q in qp_l]).astype(np.int32)
        qp_rows = torch.as_tensor(plans, device=dev)
        print(f"frame QPs {qp_l}, row plans {sorted(set(plans.ravel()))}",
              flush=True)
    ref = enc._ref
    tu = enc.params.max_tr_depth_intra

    def chunk():
        return p_chunk.p_chunk_device(
            ys, us, vs, *ref, qps, deblock=True, sao=True,
            cap=enc._chunk_cap, tree=enc.inter_split, qp_rows=qp_rows,
            **enc._tree_kwargs())

    _window("p_chunk8", chunk, per=8)

    clock = StageClock()
    undo = [clock.wrap(p_torch, "sad_grids", "sad_grids (SAD sweeps)"),
            clock.wrap(p_torch, "_me_hier_coarse",
                       "_me_hier coarse (pool, argmin)"),
            clock.wrap(p_torch, "_me_hier", "_me_hier refine (gather, 98)"),
            clock.wrap(p_torch, "integer_me", "integer_me (me_sad)"),
            clock.wrap(p_torch, "_level_encode"),
            clock.wrap(p_torch, "_p_stage_tail", "_p_stage_tail"),
            clock.wrap(p_torch, "_intra_in_p"),
            clock.wrap(p_torch, "decoded_qp_maps"),
            clock.wrap(p_torch, "tree_deblock", "deblock"),
            clock.wrap(p_torch, "inter_deblock", "deblock"),
            clock.wrap(p_chunk, "_sao_device", "sao"),
            clock.wrap(p_chunk, "_frame_wire", "wire")]
    total = _synced_ms(chunk)
    for u in undo:
        u()
    clock.report("p_chunk8 stages", total, 8)
    print(f"p_chunk8 without timers: {_synced_ms(chunk):.1f} ms", flush=True)

    def idr(planes):
        return intra_torch.encode_frame_intra(
            *planes, B=enc.ctu, qp=cfg.qp, sign_hiding=True,
            split_rdo=enc.intra_split, tu_depth=tu)

    if args.no_idr:
        enc.close()
        return 0
    whole = (y0, u0, v0)
    ms = _synced_ms(lambda: idr(whole))
    line = f"idr (whole picture, no profiler): {ms:.1f} ms"
    if enc.intra_split:
        qp_t = torch.tensor(cfg.qp, dtype=torch.int32, device=dev)
        lam = torch.as_tensor(tables.LAMBDA_FX, device=dev)[qp_t]

        def pass_a(y):
            return intra_torch._open_loop_maps(
                y, B=enc.intra_b, qp=qp_t, lam_fx=lam,
                strong_smoothing=True, tu_split=bool(tu))

        ms_a = _synced_ms(lambda: pass_a(y0))
        line += f", pass A {ms_a:.1f} ms, pass B {ms - ms_a:.1f} ms"
    print(line, flush=True)
    if not args.no_idr_profile:
        ctu = enc.ctu
        crop = args.idr_ctus or ({64: "2x4", 32: "3x8", 16: "6x16"}[ctu]
                                 if enc.intra_split else "0x0")
        rows, cols = (int(v) for v in crop.split("x"))
        planes, what = whole, "whole picture"
        nby, nbx = enc.ph // ctu, enc.pw // ctu
        if rows and cols:
            h, w = rows * ctu, cols * ctu
            planes = (y0[:h, :w].contiguous(),
                      u0[:h // 2, :w // 2].contiguous(),
                      v0[:h // 2, :w // 2].contiguous())
            what = f"top-left {rows} x {cols} of {nby} x {nbx} CTUs"
            nby, nbx = rows, cols
        diagonals = nbx + 2 * (nby - 1)
        if enc.intra_split:
            _window(f"idr pass A ({what})", lambda: pass_a(planes[0]),
                    unit="IDR", warm=False)
        _window(f"idr ({what}; {diagonals} diagonals of the whole picture's "
                f"{enc.pw // ctu + 2 * (enc.ph // ctu - 1)})",
                lambda: idr(planes), per=diagonals, unit="diagonal",
                warm=False)
    enc.close()
    return 0


def profile_b_frame(cfg, dev) -> int:
    """B1 of I0 P2 B1 at 1280x720: its device stage under the profiler, then
    the session's B frame step by step between synchronising timers."""
    import numpy as np
    import torch

    from homerhevc_tpu_torch.api import HomerEncoder
    from homerhevc_tpu_torch.entropy import headers
    from homerhevc_tpu_torch.pipeline import assemble, b_golden, b_torch
    from homerhevc_tpu_torch.utils.synth import synth_clip

    frames = list(synth_clip(1280, 720, 3, seed=0))
    enc = HomerEncoder(cfg, device=dev, fetch_recon=False)
    t0 = time.perf_counter()
    enc.push_frame(*frames[0])
    print(f"first IDR through push_frame (cold): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    ref0 = enc._ref
    enc.push_frame(*frames[1])                      # waits for its anchor
    enc.push_frame(*frames[2])                      # P2, then B1
    ref1 = enc._ref
    cur = tuple(torch.as_tensor(p, device=dev)
                for p in enc._pad_frame(*frames[1]))
    qp = cfg.qp + 2
    kw = dict(B=enc.ctu, qp=qp, search=cfg.me_search_range,
              me_precision=int(cfg.motion_estimation_precision),
              sign_hiding=cfg.sign_hiding, vis=(cfg.height, cfg.width))

    def device_stage():
        return b_torch.b_frame_device(*cur, *ref0, *ref1, **kw)

    _window("b_frame_device", device_stage, unit="B frame")
    steps = {}
    out = device_stage()
    steps["device stage"] = _synced_ms(device_stage)
    wire = [None]
    steps["wire copy"] = _synced_ms(
        lambda: wire.__setitem__(0, out["wire"].cpu().numpy()))
    w = b_torch.unpack_b_wire(wire[0], enc.ph, enc.pw, enc.ctu)
    plan = [None]

    def walk():
        plan[0] = b_golden.build_b_plans(
            w["idc"], w["mv0"], w["mv1"],
            *(w[k].astype(np.int32) for k in ("lev_y", "lev_u", "lev_v")),
            (None, None, None), size=enc.ctu, poc=1, poc_refs=(0, 2))

    steps["build_b_plans (merge/AMVP walk)"] = _synced_ms(walk)
    steps["assemble_p_au (CABAC)"] = _synced_ms(
        lambda: assemble.assemble_p_au(
            enc.params, plan[0].ctu_plans, poc=1, slice_qp=qp,
            slice_type=headers.SLICE_B, rps_idx=1))
    whole = _synced_ms(lambda: enc._encode_b((1, frames[1]), ref0, ref1))
    print(f"B frame through the session: {whole:.1f} ms; its steps "
          f"(synchronised, timed one by one):", flush=True)
    for k, v in steps.items():
        print(f"  {k:<34s} {v:9.1f} ms  {v / whole:6.1%}", flush=True)
    enc.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
