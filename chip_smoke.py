#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (homerhevc_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (non-zero exit, no result line):
  1. device  — require CUDA; print the card's name and power limit
  2. build   — build the hand-written CUDA kernels from kernels/*.cu (one
               nvcc per source, all started together) and the port's own
               libhenc (g++); print what -Xptxas -v says of each kernel
  3. kernels — each kernel against its plain PyTorch version, exact
               equality: me_sad on real, random and all-tie data, from
               uint8 and int16 planes, at 736x1280 (B 32, S 16), at
               768x1280 (B 64, S 16), at 720x1280 (B 16, S 16, nb 3,600:
               the CTU-16 paths' B-16 tile), at the small fixture clips'
               shapes and at search 8; gather_win on real and random data with
               planted out-of-range starts, from uint8 and int16 planes, at
               every call site of every path at both sizes: the fixed-CU
               path's luma window and chroma pair (one launch) at CU 32 (G
               41, 19), CU 64 (G 73, 35) and CU 16 (G 25, 11; nb 3,600 at
               720x1280), and the quadtree path's refine
               window of the hierarchical search, luma window and chroma
               pair at CU 8 (G 14, 17, 7), 16 (22, 25, 11), 32 (38, 41, 19)
               and 64 (70, 73, 35); at 1088x1920 (1080p, nb 2,040), me_sad
               at B 32, S 16 and the fixed-CU gathers (G 41, 19) on the
               1080p clip's first two frames; every gather site also on
               its first nb - 3 and first 5 windows (a ragged tail of the
               span path), and where the launcher takes the span path (G
               7, 11, 14, 17), the window path on the same data. Then times
               from CUDA graph replays at the 720p and 1080p call sites:
               kernel, plain version, an empty kernel of the same grid
               (floor_ms), one PyTorch indexing call for the same gather
               (library_ms), gather_win's window path (earlier_ms) and its
               empty grid (earlier_floor_ms), its generic (any-G) kernel
               (generic_ms), and the bound computed from the shapes
               and, for the gather, the starts: each distinct plane sample
               that a window covers read once (windows overlap), each
               window written once; then the band stages' sites
               (BAND_STEPS and TREE_BAND_STEPS, recorded from one run of
               each step): me_sad on a 192x1280 band at B 64, the gathers G
               73 and the G 35 pair on 720p bands, the refine window G 38,
               G 41 and the G 19 pair on 544-row 1080p bands (search 64);
               the quadtree's on 720p bands: at CTU 64 (192 rows) G 25 and
               41 and the G 11 and 19 pairs, at CTU 32 with search 64 (192
               and 160 rows) the refine windows G 22 and 38, G 25 and 41,
               and the G 11 and 19 pairs; the B stage's on 720p bands
               (B_BAND_STEPS, 192 and 160 rows): me_sad at B 32, S 16 (nb
               240 and 200), luma G 41, the G 19 pair and, at search 64,
               the refine window G 38
  4. paths   — each main path through HomerEncoder(cfg).encode_frames on
               the default device, with the launch counts set to 0 just
               before it and read just after (launches per P frame):
                 fastest_720p: FASTEST, cu_size 32, search 16, on
                   synth_clip(1280, 720, 9): one IDR and a chunk of 8 P
                   frames; me_sad 1, gather_win 2;
                 fast_720p: FAST, cu_size 32, search 64 (the configuration
                   bench.py times), same clip; me_sad 0, gather_win 6;
                 default_720p: EncoderConfig(width=1280, height=720, qp=32)
                   (cu_size 64, FAST, search 16); me_sad 0, gather_win 6;
                 full64_720p: FULL (8x8 inter CUs), cu_size 64, search 64:
                   8 P frames from default_720p's IDR planes (the same IDR);
                   me_sad 0, gather_win 12;
                 fastest64_720p: FASTEST, cu_size 64, search 16; me_sad 1,
                   gather_win 2;
                 cbr_wpp_720p: fast_720p's configuration under CBR at 400
                   kbps with WPP (per-CTU-row QPs, cu_qp_delta, entry
                   points), on synth_clip(1280, 720, 17): the IDR and two
                   chunks of 8 P frames, the second planned before the
                   first's bits return; me_sad 0, gather_win 6;
                 vbr_fastest_720p: fastest_720p's configuration under VBR at
                   400 kbps, the same 17 frames; me_sad 1, gather_win 2;
                 allintra_rdfast64_720p: BASELINE.md's configuration 1,
                   EncoderConfig(width=1280, height=720, qp=32, cu_size=64,
                   rd_mode=FAST, sample_adaptive_offset=False,
                   intra_period=1): one split-RDO IDR, no launch; its small
                   clips are all-intra in every rd_mode at CTU 32 and 64;
                 fastest16_720p, faster16_720p: FASTEST and FASTER at
                   cu_size 16, search 16 (the IDR at CU = TU = 16, or the
                   split-RDO IDR on 80 x 45 16-CTUs; the fixed-CU P stage
                   at B 16); me_sad 1, gather_win 2; their streams drift
                   in a decoder (fault 2 of the reference), which a
                   libde265 check, where it runs, must find;
                 ibp_fastest_720p, ibp_fast_720p, ibp_fastest16_720p:
                   fastest_720p's, fast_720p's and fastest16_720p's
                   configurations with gop_size 2 on
                   synth_clip(1280, 720, 10) through push_frame / flush (I0
                   P2 B1 P4 B3 P6 B5 P8 B7, the explicit P9 at flush);
                   launches asserted per frame type (IBP_PATHS);
               every AU's SHA-256 must equal tests/fixtures/
               torch_port_aus.json (written from the JAX package); the same
               P frames with kernels=False must give identical AUs and
               launch nothing (not run on the all-intra path, whose IDRs
               launch no kernel; a rate-controlled path continues from a copy
               of the rate control's state after the IDR, and its P frames
               are timed here, in the run that counts the launches); libde265
               decode check where the library loads; each path's small
               fixture clip too, with and without the kernels (a clip that
               launched no kernel, all-intra, with them only);
               then cli_cbr_scene_fastest_1080p, BASELINE.md's
               configuration 4 through the port's CLI (app.main, in this
               process, no -device: the card): synth_clip(1920, 1080, 10),
               frames 5-9 negated, -performance_mode 3 -cu_size 32
               -search_range 16 -bitrate_mode 1 -bitrate 1250 -rd 2 -sao 1
               -sign_hiding 1 -metrics -o-raw -profiling; its .265 and
               -o-raw SHA-256, per-frame lines (I at POC 0 and at POC 5,
               the scene-change IDR) and profiler stage names must equal
               the JAX CLI's (the fixture's "cli" entry); launches per
               frame asserted (me_sad 1, gather_win 2 per P frame and per
               scene-cut attempt); the same frames through
               HomerEncoder(cfg, kernels=False).encode_frame must give the
               same stream and launch nothing
               then the CUDA graphs of the fixed-CU P step
               (pipeline/p_graph.py) at the benchmark's configuration
               (hevc_bench/configs/ldp_1080p_fastest.json: 1920x1080,
               CTU 64, search 64, FASTEST, SAO) on synth_clip(1920, 1080,
               33): 24 P frames after the IDR through encode_frames(chunk
               8) and through encode_frame, each against a session whose
               fixed-CU step is called directly (its graphs set to None):
               AUs and final reference planes identical, P_GRAPH 1
               capture, 1 eager (warm-up) frame and 23 replays a path,
               gather_win 3 per frame; the ms per P frame of both steps,
               host clock over 16 frames ending in a synchronise, and of
               the 8 frames that warm up and capture; then torch.profiler
               over 8 graphed and 8 direct frames of each path: the gather
               kernels it sees equal to GATHER_WIN's count, kernels and
               busy device ms per frame, the kernels whose count differs
  5. mesh    — multi-device on the one card: make_p_frame_sharded on a
               mesh naming the card lanes x bands times (720p at B 64, 2
               lanes x 4 bands; 1080p at B 32 with search 64, 2 bands),
               every output equal to p_frame_device with and without the
               kernels, launches asserted, the step timed against the
               single-device stage; the quadtree stage with its deblocking
               in bands (p_frame_tree_bands; TREE_BAND_STEPS: default_720p's
               settings in 4 bands of 3 CTU rows, fast_720p's in bands of
               6, 6, 6, 5) against p_frame_tree_device on every output,
               with and without the kernels, gather_win 6 per band, timed
               against the single-device stage; the B stage in 4 bands
               (B_BAND_STEPS: ibp_fastest_720p's settings, search 16, and
               ibp_fast_720p's, search 64) against b_frame_device, wire
               included, with and without the kernels, launches asserted,
               timed; the IDR in bands (INTRA_BAND_STEPS): pass A in rd
               FULL and FAST and, at B 16, FULL against its whole-frame
               maps, the fixed-CU IDR at B 16, 32 and 64 with deblocking
               and SAO against encode_frame_intra and the single-device
               filter, timed; fastest_720p, fastest64_720p, fast_720p,
               default_720p, full64_720p and fastest16_720p again with
               mesh=[card] * 4 (bands of 6, 6, 6, 5, of 3, 3, 3, 3 and of
               12, 11, 11, 11 CTU rows; every frame in bands: the IDR,
               fast_720p's split-RDO IDR included, and the stage,
               deblocking and SAO of every P frame; launches per P frame
               the path's times 4; default_720p and full64_720p from their
               phase-4 IDR planes) against the fixture, with and without
               the kernels, and their small clips (the CTU-64 split-RDO IDR
               in bands there); ibp_fastest_720p through push_frame /
               flush on the mesh (IDR and B frames in bands; launches per
               frame type the path's times 4), with and without the
               kernels, and its small clip;
               8 P frames on one device and on the mesh, in turns;
               wpp_shards=4 on one card (no mesh, the same AUs); the
               GopPipeline in two child processes (this script with
               --gop-worker) over gloo on 127.0.0.1, sharing the card:
               fastest_720p's configuration with an IDR every 6 frames, span
               4, 9 frames; both stitched streams must equal the
               single-process session's
  6. timing  — after warm-up: 16 P frames end to end on the fixed-CU paths
               (CTU 32 and 16), 8 on each quadtree path (CTU 32 and 64)
               and on faster16_720p; a P chunk's device
               stage on each; the fixed-CU IDR's device stage, warm, and a
               split-RDO IDR's pass A alone, warm (phase 4 printed each
               IDR's first time, pass B being all but pass A: a split-RDO
               IDR reads the same cold and warm; pass A in rd_mode FAST,
               FULL and DIST_ONLY on the all-intra path); on each IBP path
               the 9 frames
               after the IDR end to end (fps) and each B frame on its own
               (ms, host clock ending in a synchronize); the 1080p CLI
               path's IDR cold (its first run) and warm (the kernels=False
               session), then one more CLI run, warm: ms per frame, ms
               per P frame, the CLI's fps and the profiler's breakdown

The last three lines are the per-kernel JSON record, the card's name and
power limit, and {"ok": true, "device": {...}}. `--gop-worker RANK WORLD
PORT OUT` runs one process of phase 5's GopPipeline (the script starts
both).
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_aus.json")

# Published rates of one H100 SXM at its full power limit, for the bounds:
# device memory 3.35 TB/s; 132 SMs with 64 32-bit integer lanes each, one
# instruction per lane and clock at the card's maximum SM clock.
HBM_BYTES_PER_S = 3.35e12
SMS = 132
INT_LANES_PER_SM = 64
# me_sad takes four absolute differences per integer instruction
# (vabsdiff4 on packed bytes)
DIFFS_PER_INSTRUCTION = 4


def log(msg: str) -> None:
    print(msg, flush=True)


def smi(query: str) -> str:
    res = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def card_line() -> str:
    return smi("name,power.limit")


def max_sm_hz() -> float:
    return float(smi("clocks.max.sm").split()[0]) * 1e6


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call of fn, after one warm-up call.

    The `reps` calls are captured into one CUDA graph and the graph's
    replay is timed with CUDA events, so the number is the device's time
    for the launches queued back to back, not the rate at which Python can
    enqueue them (a wrapper call costs the host tens of microseconds, more
    than these kernels take)."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()                                  # warm the graph itself
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def pad_plane(p, h, w):
    """Crop or edge-pad a plane to (h, w)."""
    import numpy as np
    p = p[:h, :w]
    return np.pad(p, ((0, h - p.shape[0]), (0, w - p.shape[1])), mode="edge")


def me_cases(dev, cur_frame, ref_frame, H, W, S, qp=32):
    """me_sad inputs at one size: {name: (cur, ref_pad, mvcost)} with real
    (frame against the previous frame, padded as the session pads them),
    random and all-tie data, cur as uint8 and as int16."""
    import numpy as np
    import torch

    from homerhevc_tpu_torch.device import edge_pad
    from homerhevc_tpu_torch.pipeline import p_torch
    from homerhevc_tpu_torch.tables import LAMBDA_ME_FX_P

    PAD = p_torch.PAD
    rng = np.random.default_rng(1)
    lam = int(LAMBDA_ME_FX_P[qp])
    mvcost = torch.as_tensor((lam * p_torch._mv_bits_grid(S)) >> 8,
                             device=dev)
    y_ref = torch.as_tensor(pad_plane(ref_frame[0], H, W), device=dev)
    y_cur = torch.as_tensor(pad_plane(cur_frame[0], H, W), device=dev)
    ref_real = edge_pad(y_ref.to(torch.int16), PAD)
    rand_cur = torch.as_tensor(rng.integers(0, 256, (H, W)),
                               dtype=torch.uint8, device=dev)
    rand_ref = torch.as_tensor(
        rng.integers(0, 256, (H + 2 * PAD, W + 2 * PAD)), dtype=torch.int16,
        device=dev)
    return {
        "real uint8": (y_cur, ref_real, mvcost),
        "real int16": (y_cur.to(torch.int16), ref_real, mvcost),
        "random uint8": (rand_cur, rand_ref.to(torch.uint8), mvcost),
        "random int16": (rand_cur.to(torch.int16), rand_ref, mvcost),
        "ties": (torch.full((H, W), 9, dtype=torch.int16, device=dev),
                 torch.full((H + 2 * PAD, W + 2 * PAD), 9,
                            dtype=torch.int16, device=dev),
                 torch.zeros_like(mvcost)),
    }


def gather_sites(dev, ref_frame, best, H, W, B, S):
    """The P stage's two gather call sites at one size, from an integer
    search result `best`: {name: (planes, by, bx, G)}; luma G = B + 9 on the
    padded luma plane, chroma G = B/2 + 3 on the pair of padded chroma
    planes."""
    import torch

    from homerhevc_tpu_torch.device import edge_pad
    from homerhevc_tpu_torch.pipeline import p_torch

    PAD = p_torch.PAD
    n = 2 * S + 1
    nby, nbx = H // B, W // B
    B2 = B // 2
    planes = [edge_pad(torch.as_tensor(pad_plane(p, h, w), device=dev)
                       .to(torch.int16), pad)
              for p, h, w, pad in zip(ref_frame, (H, H // 2, H // 2),
                                      (W, W // 2, W // 2),
                                      (PAD, PAD // 2, PAD // 2))]
    r = torch.arange(nby * nbx, device=dev) // nbx
    c = torch.arange(nby * nbx, device=dev) % nbx
    vy = (best.reshape(-1) // n - S).to(torch.int64)
    vx = (best.reshape(-1) % n - S).to(torch.int64)
    i32 = torch.int32
    return {
        f"luma G={B + 9}": (planes[0], (r * B + vy - 4 + PAD).to(i32),
                            (c * B + vx - 4 + PAD).to(i32), B + 9),
        f"chroma pair G={B2 + 3}": (
            (planes[1], planes[2]),
            (r * B2 + ((4 * vy) >> 3) + PAD // 2 - 1).to(i32),
            (c * B2 + ((4 * vx) >> 3) + PAD // 2 - 1).to(i32), B2 + 3),
    }


def clamped_starts(plane, by, bx, G):
    """The window starts after the gather's start rule, as int64 indices."""
    import torch
    Hp, Wp = (plane[0] if isinstance(plane, tuple) else plane).shape
    y0 = torch.where(by < 0, by + Hp, by).clamp(0, Hp - G).to(torch.int64)
    x0 = torch.where(bx < 0, bx + Wp, bx).clamp(0, Wp - G).to(torch.int64)
    return y0, x0


def covered_samples(shape, y0, x0, G) -> int:
    """How many samples of a plane of `shape` the G x G windows at the
    clamped starts (y0, x0) cover together: windows of neighbouring blocks
    overlap, and a sample that several of them hold need be read once."""
    import torch
    Hp, Wp = shape
    d = torch.zeros((Hp + 1, Wp + 1), dtype=torch.int32, device=y0.device)
    one = torch.ones(y0.shape, dtype=torch.int32, device=y0.device)
    for dy, dx, sign in ((0, 0, 1), (0, G, -1), (G, 0, -1), (G, G, 1)):
        d.index_put_((y0 + dy, x0 + dx), sign * one, accumulate=True)
    return int((d.cumsum(0).cumsum(1)[:Hp, :Wp] > 0).sum())


def library_gather(plane, y0, x0, G):
    """One PyTorch indexing call per plane that computes the gather from
    clamped starts (the yardstick library_ms; the port never calls it).
    Returns the list of per-plane results."""
    planes = plane if isinstance(plane, tuple) else (plane,)
    return [p.unfold(0, G, 1).unfold(1, G, 1)[y0, x0] for p in planes]


def check_me(dev, frames, H, W, B, S, label):
    """me_sad == plain on every data set of one size; returns the cases and
    the largest absolute difference seen (0, or the check raises)."""
    import torch

    from homerhevc_tpu_torch.ops import me
    from homerhevc_tpu_torch.pipeline.p_torch import PAD

    cases = me_cases(dev, frames[1], frames[0], H, W, S)
    worst = 0
    for name, (cur, ref, mc) in cases.items():
        ck, ik = me.integer_me_cuda(cur, ref, mc, B=B, search=S, pad=PAD)
        cp, ip = me.integer_me_plain(cur, ref, mc, B=B, search=S, pad=PAD)
        torch.cuda.synchronize()
        if ck.shape != cp.shape or ik.shape != ip.shape:
            raise AssertionError(f"me_sad shape != plain on {name} data "
                                 f"({label})")
        err = max(int((ck - cp).abs().max()), int((ik - ip).abs().max()))
        if err:
            raise AssertionError(f"me_sad != plain on {name} data ({label}): "
                                 f"max abs difference {err}")
        worst = max(worst, err)
        log(f"  me_sad == plain on {name} data ({label})")
    return cases, worst


def fast_gather_sites(dev, cur_frame, ref_frame, H, W, search,
                      sizes=(16, 32), qp=32):
    """The quadtree P stage's gather call sites at one size, from the
    hierarchical search of `cur_frame` against `ref_frame` (plain versions):
    {name: (planes, by, bx, G)}; per CU size S of `sizes` the refine window
    of the search (G = S + 6, starts from the pyramid picks, or at S 8 from
    the parent 16-block's MV), the luma support window (G = S + 9) and the
    chroma pair (G = S/2 + 3), both with starts from the integer MVs."""
    import torch

    from homerhevc_tpu_torch.device import edge_pad
    from homerhevc_tpu_torch.pipeline import p_torch
    from homerhevc_tpu_torch.tables import LAMBDA_ME_FX_P

    PAD = p_torch.PAD
    i32 = torch.int32
    planes = [edge_pad(torch.as_tensor(pad_plane(p, h, w), device=dev)
                       .to(torch.int16), pad)
              for p, h, w, pad in zip(ref_frame, (H, H // 2, H // 2),
                                      (W, W // 2, W // 2),
                                      (PAD, PAD // 2, PAD // 2))]
    cur = torch.as_tensor(pad_plane(cur_frame[0], H, W), device=dev).to(i32)
    lam = torch.tensor(int(LAMBDA_ME_FX_P[qp]), dtype=i32, device=dev)
    hier = tuple(sorted(set(sizes) | ({16} if 8 in sizes else set())))
    coarse = p_torch._me_hier_coarse(cur, planes[0], sizes=hier,
                                     search=search, lam=lam)
    ints = p_torch._me_hier(cur, planes[0], sizes=hier, search=search,
                            lam=lam, kernels=False)
    sites = {}
    for S in sizes:
        nbx = W // S
        bi = torch.arange((H // S) * nbx, device=dev, dtype=i32)
        r, c = bi // nbx, bi % nbx
        if S == 8:
            cy, cx = (t.repeat_interleave(2, 0).repeat_interleave(2, 1)
                      .clamp(-search, search).reshape(-1)
                      for t in ints[16][:2])
        else:
            cy, cx, _ = coarse[S]
        vy, vx = (t.reshape(-1) for t in ints[S][:2])
        S2 = S // 2
        sites[f"hier refine G={S + 6}"] = (
            planes[0], r * S + cy - 3 + PAD, c * S + cx - 3 + PAD, S + 6)
        sites[f"tree luma G={S + 9}"] = (
            planes[0], r * S + vy - 4 + PAD, c * S + vx - 4 + PAD, S + 9)
        sites[f"tree chroma pair G={S2 + 3}"] = (
            (planes[1], planes[2]),
            r * S2 + ((4 * vy) >> 3) + PAD // 2 - 1,
            c * S2 + ((4 * vx) >> 3) + PAD // 2 - 1, S2 + 3)
    return sites


def gather_entry(symbol, plane, by, bx, G, *extra):
    """Launch another entry of gather_win.cu that takes the launcher's
    arguments (and `extra` ints before the stream) at one site, into a new
    (P, nb, G, G) output; a yardstick, not counted as a launch."""
    import ctypes

    import torch

    from homerhevc_tpu_torch.ops import gather

    planes = plane if isinstance(plane, tuple) else (plane,)
    dev = planes[0].device
    out = torch.empty((len(planes), by.shape[0], G, G), dtype=torch.int16,
                      device=dev)
    ptrs = [p.data_ptr() for p in planes] + [None] * (
        gather.MAX_PLANES - len(planes))
    argtypes = gather.GATHER_WIN.argtypes
    argtypes = argtypes[:-1] + [ctypes.c_int] * len(extra) + argtypes[-1:]
    gather.GATHER_WIN.launch_other(
        symbol, *ptrs, len(planes), by.data_ptr(), bx.data_ptr(),
        out.data_ptr(), by.shape[0], *planes[0].shape, G, *extra,
        torch.cuda.current_stream(dev).cuda_stream, argtypes=argtypes)
    return out


def span_width(G: int) -> int:
    """Windows per CTA of gather_win's span path at G (0: the window
    path), as the launcher chooses them."""
    import ctypes

    from homerhevc_tpu_torch.ops import gather
    return gather.GATHER_WIN.entry("gather_win_span_width",
                                   [ctypes.c_int])(G)


def check_gather(dev, sites, label):
    """gather_win == plain at every call site of `sites`, on real starts,
    on random data with planted out-of-range starts, and on the first
    nb - 3 and the first 5 windows of both (a ragged tail: P * nb not a
    multiple of 8), from int16 planes through the kernel's launcher and
    from uint8 planes through the wrapper; where the launcher takes the span
    path, the window path (gather_win_window_launch) is held to the
    same data. Returns the largest absolute difference seen (0, or the
    check raises)."""
    import numpy as np
    import torch

    from homerhevc_tpu_torch.ops import gather

    rng = np.random.default_rng(2)
    worst = 0
    for name, (plane, by, bx, G) in sites.items():
        first = plane[0] if isinstance(plane, tuple) else plane
        Hp, Wp = first.shape
        by, bx = by.to(torch.int32), bx.to(torch.int32)

        def rand_like(p):
            return torch.as_tensor(rng.integers(-300, 300, tuple(p.shape)),
                                   dtype=torch.int16, device=dev)

        rand_plane = (tuple(rand_like(p) for p in plane)
                      if isinstance(plane, tuple) else rand_like(plane))
        rand_by = by + torch.as_tensor(rng.integers(-8, 9, tuple(by.shape)),
                                       dtype=torch.int32, device=dev)
        # planted starts: negative (counts from the end), far outside, and
        # the last row that fits
        rand_by[:3] = torch.tensor([-5, 10 ** 5, Hp - G], dtype=torch.int32,
                                   device=dev)
        rand_bx = bx.clone()
        rand_bx[3:6] = torch.tensor([-3, 10 ** 5, Wp - G], dtype=torch.int32,
                                    device=dev)
        nb = by.shape[0]
        cases = [("real", (plane, by, bx)),
                 ("random", (rand_plane, rand_by, rand_bx))]
        cases += [(f"{kind}, first {n}", (p, yy[:n].contiguous(),
                                          xx[:n].contiguous()))
                  for n in (nb - 3, 5) if 0 < n < nb
                  for kind, (p, yy, xx) in cases[:2]]
        span = span_width(G)
        for kind, (p, yy, xx) in cases:
            b = gather.gather_windows_plain(p, yy, xx, G)
            runs = [("gather_win", gather.gather_windows_cuda(p, yy, xx, G))]
            if span:
                runs.append(("window path", gather_entry(
                    "gather_win_window_launch", p, yy, xx, G).reshape(
                        b.shape)))
            torch.cuda.synchronize()
            for what, a in runs:
                if a.shape != b.shape:
                    raise AssertionError(f"{what} shape != plain at {name} "
                                         f"({kind}, {label})")
                err = int((a.to(torch.int32) - b.to(torch.int32)).abs()
                          .max())
                if err:
                    raise AssertionError(f"{what} != plain at {name} "
                                         f"({kind}, {label}): max abs "
                                         f"difference {err}")
                worst = max(worst, err)
            path = f"span path, W {span}" if span else "window path"
            log(f"  gather_win == plain at {name} on {kind} data ({label}, "
                f"plane {Hp}x{Wp}, nb={yy.shape[0]}, {path})")
        # the wrapper on uint8 planes (it widens them, then launches)
        p8 = (tuple(q.to(torch.uint8) for q in plane)
              if isinstance(plane, tuple) else plane.to(torch.uint8))
        before = gather.GATHER_WIN.launches
        a = gather.gather_windows(p8, by, bx, G)
        if gather.GATHER_WIN.launches != before + 1:
            raise AssertionError("gather_windows did not launch the kernel "
                                 f"on a CUDA tensor at {name}")
        b = gather.gather_windows_plain(p8, by, bx, G)
        err = int((a.to(torch.int32) - b.to(torch.int32)).abs().max())
        if a.shape != b.shape or err:
            raise AssertionError(f"gather_win != plain at {name} (uint8, "
                                 f"{label}): max abs difference {err}")
    return worst


def time_me(dev, cur, ref, mc, H, W, B, S):
    """Times of me_sad at one call site: kernel, plain version, empty grid,
    and the bound."""
    import torch

    from homerhevc_tpu_torch.ops import me
    from homerhevc_tpu_torch.pipeline.p_torch import PAD

    def stream():        # the current stream: a graph capture's own, inside
        return torch.cuda.current_stream(dev).cuda_stream

    nblocks = (H // B) * (W // B)
    n = 2 * S + 1
    diffs = nblocks * n * n * B * B
    rate = DIFFS_PER_INSTRUCTION * INT_LANES_PER_SM * SMS * max_sm_hz()
    nbytes = (cur.numel() * cur.element_size()
              + ref.numel() * ref.element_size() + mc.numel() * 4
              + 2 * nblocks * 4)
    ops_ms = diffs / rate * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    t = dict(
        site=f"{H}x{W} B={B} S={S}", B=B, nblocks=nblocks,
        ms=cuda_ms(lambda: me.integer_me_cuda(cur, ref, mc, B=B, search=S,
                                              pad=PAD), 50),
        plain_ms=cuda_ms(lambda: me.integer_me_plain(cur, ref, mc, B=B,
                                                     search=S, pad=PAD), 3),
        floor_ms=cuda_ms(lambda: me.ME_SAD.launch_floor(H, W, B, S,
                                                        stream()), 50),
        bound_ms=max(ops_ms, bytes_ms),
        bound_by="operations" if ops_ms >= bytes_ms else "bytes",
        library_ms=None)
    log(f"  me_sad {t['site']}: kernel {t['ms']:.4f} ms, plain "
        f"{t['plain_ms']:.4f} ms, empty grid {t['floor_ms']:.4f} ms; bound "
        f"{ops_ms:.4f} ms by "
        f"operations ({diffs:.3e} differences, {DIFFS_PER_INSTRUCTION} per "
        f"instruction), {bytes_ms:.4f} ms by bytes ({nbytes} B)")
    return t


def time_gather(dev, name, plane, by, bx, G):
    """Times of gather_win at one call site: the kernel (the path its
    launcher takes at G), the window path ("earlier"), the empty grid
    of each of the two launch shapes, one PyTorch indexing call per plane,
    the any-G kernel, the plain version, and the bound (each distinct plane
    sample the windows cover read once, each window written once)."""
    import torch

    from homerhevc_tpu_torch.ops import gather

    def stream():        # the current stream: a graph capture's own, inside
        return torch.cuda.current_stream(dev).cuda_stream

    nplanes = len(plane) if isinstance(plane, tuple) else 1
    nb = by.shape[0]
    by, bx = by.to(torch.int32).contiguous(), bx.to(torch.int32).contiguous()
    y0, x0 = clamped_starts(plane, by, bx, G)
    first = plane[0] if isinstance(plane, tuple) else plane
    # int16 samples: the distinct ones the windows cover, read once per
    # plane; every window written once; the starts read once
    nbytes = (nplanes * 2 * (covered_samples(first.shape, y0, x0, G)
                             + nb * G * G) + 2 * nb * 4)
    want = gather.gather_windows_plain(plane, by, bx, G).reshape(-1)
    lib = torch.stack(library_gather(plane, y0, x0, G))
    if not torch.equal(lib.reshape(-1), want):
        raise AssertionError(f"library gather != plain at {name}")
    for symbol in ("gather_win_window_launch", "gather_win_generic_launch"):
        if not torch.equal(gather_entry(symbol, plane, by, bx, G).reshape(-1),
                           want):
            raise AssertionError(f"{symbol} != plain at {name}")
    span = span_width(G)
    t = dict(
        site=name, G=G, nb=nb, planes=nplanes,
        path=f"span W={span}" if span else "window",
        ms=cuda_ms(lambda: gather.gather_windows_cuda(plane, by, bx, G),
                   100),
        earlier_ms=cuda_ms(lambda: gather_entry(
            "gather_win_window_launch", plane, by, bx, G), 100),
        plain_ms=cuda_ms(lambda: gather.gather_windows_plain(
            plane, by, bx, G), 50),
        floor_ms=cuda_ms(lambda: gather.GATHER_WIN.launch_floor(
            nb, nplanes, G, -1, stream()), 100),
        earlier_floor_ms=cuda_ms(lambda: gather.GATHER_WIN.launch_floor(
            nb, nplanes, G, 0, stream()), 100),
        library_ms=cuda_ms(lambda: library_gather(plane, y0, x0, G), 50),
        generic_ms=cuda_ms(lambda: gather_entry(
            "gather_win_generic_launch", plane, by, bx, G), 100),
        bound_bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes")
    log(f"  gather_win {name} (nb {nb}, {t['path']}): kernel "
        f"{t['ms']:.4f} ms, window path (earlier) {t['earlier_ms']:.4f} ms, "
        f"empty grid {t['floor_ms']:.4f} ms (window path's "
        f"{t['earlier_floor_ms']:.4f}), one indexing call per plane "
        f"{t['library_ms']:.4f} ms, any-G kernel {t['generic_ms']:.4f} ms, "
        f"plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms by "
        f"bytes ({nbytes} B)")
    return t


def phase_kernels(dev, frames, small_frames, small64_frames, frames1080,
                  small16_frames):
    """Kernel vs plain at the 720p call sites of every path (CTU 32 at
    736x1280, CTU 64 at 768x1280, CTU 16 at 720x1280), the fixed-CU path's
    sites at 1080p (1088x1920, nb 2,040), the small fixture clips' shapes
    and search 8; times and bounds at 720p and 1080p. Returns per-kernel
    records."""
    import torch

    from homerhevc_tpu_torch.ops import gather, me
    from homerhevc_tpu_torch.pipeline.p_torch import PAD

    H, W, B, S = 736, 1280, 32, 16
    H64 = 768
    # max_abs_err of a kernel: the largest difference over all its checks
    cases, me_err = check_me(dev, frames, H, W, B, S, "736x1280, B=32, S=16")
    small, err = check_me(dev, small_frames, 96, 128, B, S,
                          "96x128, B=32, S=16")
    me_err = max(me_err, err)
    cases64, err = check_me(dev, frames, H64, W, 64, S, "768x1280, B=64, S=16")
    me_err = max(me_err, err)
    small64, err = check_me(dev, small64_frames, 128, 192, 64, S,
                            "128x192, B=64, S=16")
    me_err = max(me_err, err)
    # CTU 16: the fixed-CU P stage's B-16 tile at 720p (45 x 80 blocks, nb
    # 3,600) and on the CTU-16 small clips' padded 128x96
    H16 = 720
    cases16, err = check_me(dev, frames, H16, W, 16, S,
                            "720x1280, B=16, S=16")
    me_err = max(me_err, err)
    small16, err = check_me(dev, small16_frames, 96, 128, 16, S,
                            "96x128, B=16, S=16")
    me_err = max(me_err, err)
    # search 8, and other block sizes: the compile-time B=16 path and the
    # any-B kernel
    for fr, h, w, b, s in ((frames, H, W, B, 8), (small_frames, 96, 128, B, 8),
                           (small_frames, 96, 128, 16, 8),
                           (small_frames, 96, 120, 24, 7),
                           (small64_frames, 128, 192, 64, 8)):
        me_err = max(me_err, check_me(dev, fr, h, w, b, s,
                                      f"{h}x{w}, B={b}, S={s}")[1])

    # BASELINE.md configuration 4: 1080p, coded as 1088 rows of 32-CTUs
    H1, W1 = 1088, 1920
    cases1080, err = check_me(dev, frames1080, H1, W1, B, S,
                              "1088x1920, B=32, S=16")
    me_err = max(me_err, err)

    me_sites = [time_me(dev, *cases["real uint8"], H, W, B, S),
                time_me(dev, *cases64["real uint8"], H64, W, 64, S),
                time_me(dev, *cases1080["real uint8"], H1, W1, B, S),
                time_me(dev, *cases16["real uint8"], H16, W, 16, S)]
    records = {"me_sad": dict(
        name="me_sad", route="cuda", source=me.ME_SAD.source,
        replaces="homerhevc_tpu/ops/me_pallas.py:27", max_abs_err=me_err,
        **{k: me_sites[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "floor_ms",
                                       "library_ms")},
        sites=me_sites)}

    cur, ref, mc = cases["real uint8"]
    _, best = me.integer_me_plain(cur, ref, mc, B=B, search=S, pad=PAD)
    sites = gather_sites(dev, frames[0], best, H, W, B, S)
    gw_err = check_gather(dev, sites, "736x1280, fixed CU")
    cur_s, ref_s, mc_s = small["real uint8"]
    _, best_s = me.integer_me_plain(cur_s, ref_s, mc_s, B=B, search=S,
                                    pad=PAD)
    gw_err = max(gw_err, check_gather(
        dev, gather_sites(dev, small_frames[0], best_s, 96, 128, B, S),
        "96x128, fixed CU"))
    # the fixed-CU path at CU 64
    cur, ref, mc = cases64["real uint8"]
    _, best = me.integer_me_plain(cur, ref, mc, B=64, search=S, pad=PAD)
    sites64 = gather_sites(dev, frames[0], best, H64, W, 64, S)
    gw_err = max(gw_err, check_gather(dev, sites64, "768x1280, fixed CU 64"))
    cur_s, ref_s, mc_s = small64["real uint8"]
    _, best_s = me.integer_me_plain(cur_s, ref_s, mc_s, B=64, search=S,
                                    pad=PAD)
    gw_err = max(gw_err, check_gather(
        dev, gather_sites(dev, small64_frames[0], best_s, 128, 192, 64, S),
        "128x192, fixed CU 64"))
    sites.update(sites64)
    cur, ref, mc = cases1080["real uint8"]
    _, best = me.integer_me_plain(cur, ref, mc, B=B, search=S, pad=PAD)
    sites1080 = {f"1080p {k}": v for k, v in gather_sites(
        dev, frames1080[0], best, H1, W1, B, S).items()}
    gw_err = max(gw_err, check_gather(dev, sites1080, "1088x1920, fixed CU"))
    sites.update(sites1080)
    # the fixed-CU path at CU 16: luma G 25 and the G 11 pair, nb 3,600
    cur, ref, mc = cases16["real uint8"]
    _, best = me.integer_me_plain(cur, ref, mc, B=16, search=S, pad=PAD)
    sites16 = {f"CU 16 {k}": v for k, v in gather_sites(
        dev, frames[0], best, H16, W, 16, S).items()}
    gw_err = max(gw_err, check_gather(dev, sites16, "720x1280, fixed CU 16"))
    cur_s, ref_s, mc_s = small16["real uint8"]
    _, best_s = me.integer_me_plain(cur_s, ref_s, mc_s, B=16, search=S,
                                    pad=PAD)
    gw_err = max(gw_err, check_gather(
        dev, gather_sites(dev, small16_frames[0], best_s, 96, 128, 16, S),
        "96x128, fixed CU 16"))
    sites.update(sites16)
    # the quadtree path's sites, search 64 (frame 1 against frame 0): CU 16
    # and 32 at CTU 32, CU 8 and 64 at CTU 64
    for h, w, fr, sizes, label in (
            (H, W, frames, (16, 32), "736x1280, quadtree"),
            (96, 128, small_frames, (16, 32), "96x128, quadtree"),
            (H64, W, frames, (8, 64), "768x1280, quadtree CU 8 and 64"),
            (128, 192, small64_frames, (8, 64),
             "128x192, quadtree CU 8 and 64")):
        fast_sites = fast_gather_sites(dev, fr[1], fr[0], h, w, 64, sizes)
        gw_err = max(gw_err, check_gather(dev, fast_sites, label))
        if h >= H:
            sites.update(fast_sites)

    times = {name: time_gather(dev, name, *site)
             for name, site in sites.items()}
    keys = ("ms", "plain_ms", "floor_ms", "library_ms", "bound_ms")
    luma, chroma = times["luma G=41"], times["chroma pair G=19"]
    records["gather_win"] = dict(
        name="gather_win", route="cuda", source=gather.GATHER_WIN.source,
        replaces="homerhevc_tpu/ops/gather_pallas.py:30", max_abs_err=gw_err,
        bound_by="bytes", **{k: luma[k] for k in keys},
        **{f"chroma_pair_{k}": chroma[k] for k in keys},
        sites=list(times.values()))
    return records


# Launches per P frame. me_sad: one per fixed-CU P frame at search 16 (the
# quadtree stage sweeps its dense window without it). gather_win: the
# fixed-CU stage gathers the luma window and the chroma pair; the quadtree
# stage does so at each CU size (16 and 32 at CTU 32, 16, 32 and 64 at CTU
# 64, and 8 as well with FULL's 8x8 CUs), and above the dense-search
# threshold its hierarchical search gathers one refine window per CU size.
# A path with `seed` continues from another path's IDR planes: FULL codes
# the same IDR as FAST (same intra settings and QP), so its 8 P frames are
# compared with the fixture's without coding the 64-CTU IDR twice.
PATHS = {
    "fastest_720p": dict(run="720p", frames=9, me_sad=1, gather_win=2,
                         small="small"),
    "fast_720p": dict(run="fast_720p", frames=9, me_sad=0, gather_win=6,
                      small="fast_small"),
    # built as EncoderConfig(width=1280, height=720, qp=32): the defaults
    "default_720p": dict(run="default_720p", frames=9, me_sad=0,
                         gather_win=6, small="default_small", defaults=True),
    "full64_720p": dict(run="full64_720p", frames=9, me_sad=0, gather_win=12,
                        small="full64_small", seed="default_720p"),
    "fastest64_720p": dict(run="fastest64_720p", frames=9, me_sad=1,
                           gather_win=2, small="fastest64_small"),
    # rate control: the IDR's bits steer the P frames' QPs, so the IDR is
    # coded in the same session and the P frames are timed in this run
    "cbr_wpp_720p": dict(run="cbr_wpp_720p", frames=17, me_sad=0,
                         gather_win=6, small="cbr_wpp_small", rc=True),
    "vbr_fastest_720p": dict(run="vbr_fastest_720p", frames=17, me_sad=1,
                             gather_win=2, small="vbr_fastest_small",
                             rc=True),
    # BASELINE.md configuration 1: all-intra 720p, CTU 64, rd FAST, no SAO
    # (one split-RDO IDR, the first of the fixture's two; no kernel runs in
    # an IDR)
    "allintra_rdfast64_720p": dict(
        run="allintra_rdfast64_720p", frames=1, me_sad=0, gather_win=0,
        defaults=dict(cu_size=64, rd_mode="FAST",
                      sample_adaptive_offset=False, intra_period=1),
        small=("allintra_rd0_small", "allintra_rd1_small",
               "allintra_rd2_small", "allintra64_rd0_small",
               "allintra64_rd1_small", "allintra64_rd2_small")),
    # CTU 16: FASTEST (the fixed-CU IDR at B 16) and FASTER (the split-RDO
    # IDR on 16-CTUs), each with the fixed-CU P stage at B 16 (me_sad's
    # B-16 tile, gather_win G 25 and the G 11 pair); their streams drift in
    # a decoder (fault 2 of the reference), so the libde265 check, where it
    # runs, must find the drift
    "fastest16_720p": dict(run="fastest16_720p", frames=9, me_sad=1,
                           gather_win=2, drifts=True,
                           small=("fastest16_small", "vbr_fastest16_small",
                                  "fastest16_s64_small")),
    "faster16_720p": dict(run="faster16_720p", frames=9, me_sad=1,
                          gather_win=2, drifts=True,
                          small=("faster16_rd0_small", "faster16_rd1_small",
                                 "faster16_rd2_small", "faster16_tr0_small",
                                 "cbr_wpp_faster16_small")),
}

# IBP (gop_size 2) through push_frame / flush: I0 P2 B1 P4 B3 P6 B5 P8 B7,
# then the explicit P9 at flush. Launches per frame type: an anchor P as
# its performance mode's P frame; a B frame runs the integer search per
# list (me_sad at search <= 24, else the hierarchical search with one
# refine window), then gathers each list's luma window and chroma pair; an
# explicit P is a fixed-CU P frame (at search 64 through the hierarchical
# search: refine window, luma window, chroma pair)
IBP_PATHS = {
    "ibp_fastest_720p": dict(
        run="ibp_fastest_720p", frames=10, small="ibp_small",
        per_type=dict(idr=(0, 0), anchor=(1, 2), b=(2, 4), explicit=(1, 2))),
    "ibp_fast_720p": dict(
        run="ibp_fast_720p", frames=10, small="ibp_fast_small",
        per_type=dict(idr=(0, 0), anchor=(0, 6), b=(0, 6), explicit=(0, 3))),
    "ibp_fastest16_720p": dict(
        run="ibp_fastest16_720p", frames=10,
        small=("ibp_fastest16_small", "ibp_faster16_s64_small"),
        per_type=dict(idr=(0, 0), anchor=(1, 2), b=(2, 4), explicit=(1, 2))),
}


def run_path(dev, name, fixture, seeds, mesh=None, idr=None):
    """One main path at 720p through the session's entry points on the
    default device; returns its launch counts and the reference planes
    behind its IDR (numpy). The comparison and timing sessions continue
    from those planes (seed_reference) without coding the IDR again here:
    no kernel runs in an IDR, and the split-RDO IDR takes most of a minute.
    A path with a `seed` starts from `seeds[seed]`, and one given `idr`
    (its own IDR's planes, from an earlier run) from those. With a `mesh`
    (a list of devices) the sessions run every frame in its bands, the IDR
    included: the launches per P frame are the path's times the number of
    bands."""
    import copy

    import torch

    from homerhevc_tpu_torch.api import HomerEncoder
    from homerhevc_tpu_torch.ops.gather import GATHER_WIN
    from homerhevc_tpu_torch.ops.me import ME_SAD
    from homerhevc_tpu_torch.parallel.sharded import band_heights
    from homerhevc_tpu_torch.utils import fixtures as fx

    path = PATHS[name]
    path_name = name
    run = fx.RUNS[path["run"]]
    n = path["frames"]
    frames = fx.clip(path["run"])[:n]
    want = fixture[path["run"]]["aus"][:n]
    cfg = fx.run_config(path["run"])
    if path.get("defaults"):
        from homerhevc_tpu_torch.config import EncoderConfig, RDMode
        extra = dict(path["defaults"]) if isinstance(path["defaults"],
                                                     dict) else {}
        if "rd_mode" in extra:
            extra["rd_mode"] = RDMode[extra["rd_mode"]]
        default = EncoderConfig(width=run["width"], height=run["height"],
                                qp=32, **extra)
        # the fixture's fixed fields add only frame-level pipelining, which
        # changes no byte
        if dataclasses.replace(default, frame_pipeline_depth=2) != cfg:
            raise AssertionError(f"{name}: the fixture's configuration is "
                                 "not EncoderConfig's defaults")
        cfg = default
    seed = path.get("seed")
    if seed and want[0] != fixture[PATHS[seed]["run"]]["aus"][0]:
        raise AssertionError(f"{name}: the fixture's IDR differs from "
                             f"{seed}'s: cannot continue from its planes")
    ref0 = seeds[seed] if seed else idr
    seeded = ref0 is not None
    kernels = (ME_SAD, GATHER_WIN)
    for k in kernels:
        k.launches = 0
    # no device given: the card (the mesh's first device, with a mesh)
    enc = HomerEncoder(cfg, mesh=mesh)
    bands = (len(band_heights(cfg.padded_height // cfg.cu_size, len(mesh)))
             if mesh else 1)
    if mesh:
        name = f"{name} on a mesh of {len(mesh)} ({bands} bands)"
    if enc.device.type != "cuda":
        raise AssertionError(f"default device is {enc.device}, not the card")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if seeded:
        enc.seed_reference(ref0, poc=1, last_idr=0)
        aus = [None]
        idr_s = None
    else:
        aus = enc.encode_frames(frames[:1])
        ref0 = tuple(p.cpu().numpy() for p in enc._ref)
        torch.cuda.synchronize()
        idr_s = time.perf_counter() - t0
    rc0 = copy.deepcopy(enc._rc)            # rate control after the IDR
    t_p = time.perf_counter()
    aus += enc.encode_frames(frames[1:], chunk=run["chunk"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    p_secs = time.perf_counter() - t_p
    launches = {k.name: k.launches for k in kernels}
    idr_note = (f"; of it the first IDR through encode_frames, cold, "
                f"{idr_s:.2f} s" if idr_s else "")
    from_note = (f" (P frames from {seed or path_name}'s IDR planes)"
                 if seeded else "")
    log(f"  {name}: {cfg.performance_mode.name}, cu_size {cfg.cu_size}, "
        f"search {cfg.me_search_range}, {n} frames through the kernels"
        f"{from_note}: {secs:.2f} s (first run, includes warm-up"
        f"{idr_note}); launches {launches}")
    n_p = n - 1
    expect = {k.name: path[k.name] * n_p * bands for k in kernels}
    if launches != expect:
        raise AssertionError(f"{name}: launches {launches}, expected "
                             f"{expect} for {n_p} P frames")
    if path.get("rc"):
        log(f"  {name}: {n_p} P frames end to end in this run: "
            f"{p_secs * 1000:.1f} ms -> {n_p / p_secs:.2f} fps (slice QPs "
            f"issued by rate control: {enc.last_qp} last) on {card_line()}")
    got = fx.au_digest(aus[1:] if seeded else aus)
    want_c = want[1:] if seeded else want
    bad = [i for i, (a, b) in enumerate(zip(got, want_c)) if a != b]
    if len(got) != len(want_c) or bad:
        raise AssertionError(f"{name}: AUs differ from the JAX fixture at "
                             f"{bad} (sizes {[g['len'] for g in got]})")
    idr_note = "" if seeded else f"; IDR {got[0]['len']} bytes"
    log(f"  {name}: AUs == JAX fixture ({len(got)} AUs, "
        f"{sum(g['len'] for g in got)} bytes{idr_note})")

    if not seeded:
        decoded = fx.decode_check(aus,
                                  enc._ref[0].cpu().numpy()[:720, :1280])
        if decoded is None:
            log("  libde265 decode check: not run (libde265 does not load)")
        elif path.get("drifts"):
            if decoded:
                raise AssertionError("libde265 decode == the port's recon: "
                                     "fault 2 of the reference no longer "
                                     "shows")
            log("  libde265 decode check: ran, last frame != port recon "
                "(fault 2 of the reference, as the JAX package's stream)")
        elif not decoded:
            raise AssertionError("libde265 decode != the port's recon")
        else:
            log("  libde265 decode check: ran, last frame == port recon")
    enc.close()

    if not any(expect.values()):
        # all-intra: every frame is an IDR, which runs no kernel, so a
        # kernels=False run would code the same work again and prove nothing
        log(f"  {name}: kernels=False run skipped (no kernel runs on this "
            "path)")
    else:
        plain = HomerEncoder(cfg, device=dev, kernels=False, mesh=mesh)
        plain.seed_reference(ref0, poc=1, last_idr=0)
        plain._rc = copy.deepcopy(rc0)
        aus_plain = plain.encode_frames(frames[1:], chunk=run["chunk"])
        plain.close()
        if aus_plain != aus[1:]:
            raise AssertionError(f"{name}: kernels=False P AUs differ from "
                                 "kernel AUs")
        if {k.name: k.launches for k in kernels} != launches:
            raise AssertionError(f"{name}: kernels=False run launched a "
                                 "kernel")
        log(f"  {name}: kernels=False run of the {n_p} P frames: AUs "
            "identical, nothing launched")

    check_small(dev, path["small"], fixture, mesh)
    return launches, ref0


def check_small(dev, names, fixture, mesh=None) -> None:
    """The small fixture clips of a path on the card, with and without the
    kernels, through the run's own entry points (push_frame / flush or
    encode_frames), on `mesh` when given. A clip whose run launched no
    kernel (all-intra) is not run again with the plain versions: that run
    would repeat the same work."""
    from homerhevc_tpu_torch.api import HomerEncoder
    from homerhevc_tpu_torch.ops.gather import GATHER_WIN
    from homerhevc_tpu_torch.ops.me import ME_SAD
    from homerhevc_tpu_torch.utils import fixtures as fx

    for small_name in (names,) if isinstance(names, str) else names:
        small = fixture[small_name]
        launched = 0
        for use_kernels in (True, False):
            if not (use_kernels or launched):
                break
            before = ME_SAD.launches + GATHER_WIN.launches
            enc = HomerEncoder(fx.run_config(small_name), device=dev,
                               kernels=use_kernels, mesh=mesh)
            s_aus = fx.encode_run(enc, small_name)
            enc.close()
            launched += ME_SAD.launches + GATHER_WIN.launches - before
            if fx.au_digest(s_aus) != small["aus"]:
                raise AssertionError(f"{small_name}: AUs differ from the JAX "
                                     f"fixture (kernels={use_kernels})")
        log(f"  {small_name}: {small['width']}x{small['height']} AUs == JAX "
            f"fixture ({len(s_aus)} AUs), "
            + ("with and without kernels" if launched else
               "no kernel launched, so no plain re-run")
            + (f", on a mesh of {len(mesh)}" if mesh else ""))


def ibp_session(cfg, dev, kernels, events, mesh=None):
    """A session (on `mesh` when given) whose B frames and explicit P
    frames record (kind, launch deltas, host-clocked ms ending in a
    synchronize) into `events`."""
    import torch

    from homerhevc_tpu_torch.api import HomerEncoder
    from homerhevc_tpu_torch.ops.gather import GATHER_WIN
    from homerhevc_tpu_torch.ops.me import ME_SAD

    enc = (HomerEncoder(cfg, mesh=mesh) if dev is None  # the card by default
           else HomerEncoder(cfg, device=dev, kernels=kernels, mesh=mesh))

    def counted(kind, fn):
        def call(*args):
            before = (ME_SAD.launches, GATHER_WIN.launches)
            torch.cuda.synchronize()
            t = time.perf_counter()
            au = fn(*args)
            torch.cuda.synchronize()
            events.append((kind, (ME_SAD.launches - before[0],
                                  GATHER_WIN.launches - before[1]),
                           (time.perf_counter() - t) * 1e3))
            return au
        return call

    enc._encode_b = counted("b", enc._encode_b)
    enc._encode_p_explicit = counted("explicit", enc._encode_p_explicit)
    return enc


def push_all(enc, frames, d0, events):
    """Push frames (display indices d0, d0+1, ...) and flush; an anchor's
    launches are its push's less those of the B or explicit P it brought.
    Returns the AUs."""
    from homerhevc_tpu_torch.ops.gather import GATHER_WIN
    from homerhevc_tpu_torch.ops.me import ME_SAD

    aus = []
    for d, f in enumerate(frames, d0):
        before = (ME_SAD.launches, GATHER_WIN.launches)
        k = len(events)
        aus += enc.push_frame(*f)
        if d % 2 == 0:
            inner = [e[1] for e in events[k:]]
            events.insert(k, ("idr" if d == 0 else "anchor", (
                ME_SAD.launches - before[0] - sum(i[0] for i in inner),
                GATHER_WIN.launches - before[1] - sum(i[1] for i in inner)),
                None))
    return aus + enc.flush()


def run_ibp_path(dev, name, fixture, mesh=None):
    """One IBP path at 720p through push_frame / flush on the default
    device: its AUs against the fixture, with and without the kernels (the
    kernels=False session continues from the IDR's planes), launches per
    frame type. With a `mesh` (a list of devices) the sessions run every
    frame in its bands, the IDR and the B frames included: launches per
    frame type are the path's times the number of bands. Returns the
    launch counts and the IDR's planes."""
    import torch

    from homerhevc_tpu_torch.ops.gather import GATHER_WIN
    from homerhevc_tpu_torch.ops.me import ME_SAD
    from homerhevc_tpu_torch.parallel.sharded import band_heights
    from homerhevc_tpu_torch.utils import fixtures as fx

    path = IBP_PATHS[name]
    n = path["frames"]
    frames = fx.clip(path["run"])[:n]
    want = fixture[path["run"]]["aus"][:n]
    cfg = fx.run_config(path["run"])
    bands = (len(band_heights(cfg.padded_height // cfg.cu_size, len(mesh)))
             if mesh else 1)
    if mesh:
        name = f"{name} on a mesh of {len(mesh)} ({bands} bands)"
    for k in (ME_SAD, GATHER_WIN):
        k.launches = 0
    events = []
    enc = ibp_session(cfg, None, True, events, mesh)
    if enc.device.type != "cuda":
        raise AssertionError(f"default device is {enc.device}, not the card")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    aus = push_all(enc, frames[:1], 0, events)
    ref0 = tuple(p.cpu().numpy() for p in enc._ref)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    aus = aus[:1] + push_all(enc, frames[1:], 1, events)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {"me_sad": ME_SAD.launches, "gather_win": GATHER_WIN.launches}
    kinds = [e[0] for e in events]
    log(f"  {name}: {cfg.performance_mode.name}, cu_size {cfg.cu_size}, "
        f"search {cfg.me_search_range}, gop_size {cfg.gop_size}, {n} frames "
        f"through push_frame / flush (first run: IDR {t1 - t0:.2f} s, the "
        f"other {n - 1} frames {t2 - t1:.2f} s); launches {launches}; frame "
        f"types in coding order {kinds}")
    per_type = {kind: tuple(c * bands for c in counts)
                for kind, counts in path["per_type"].items()}
    bad = [(kind, got) for kind, got, _ in events if got != per_type[kind]]
    if bad or kinds.count("b") != (n - 1) // 2 or "explicit" not in kinds:
        raise AssertionError(f"{name}: launches (me_sad, gather_win) per "
                             f"frame {bad}, expected {per_type}; frames "
                             f"{kinds}")
    log(f"  {name}: launches (me_sad, gather_win) per frame type asserted: "
        f"{per_type}")
    got = fx.au_digest(aus)
    bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    if len(got) != len(want) or bad:
        raise AssertionError(f"{name}: AUs differ from the JAX fixture at "
                             f"{bad} (sizes {[g['len'] for g in got]})")
    log(f"  {name}: AUs == JAX fixture ({len(got)} AUs in decode order, "
        f"{sum(g['len'] for g in got)} bytes)")
    enc.close()

    plain = ibp_session(cfg, dev, False, [], mesh)
    plain.seed_reference(ref0, poc=0, last_idr=0)
    plain._disp = 1            # continue the display order after the IDR
    aus_plain = push_all(plain, frames[1:], 1, [])
    plain.close()
    if aus_plain != aus[1:]:
        raise AssertionError(f"{name}: kernels=False AUs differ from kernel "
                             "AUs")
    if {"me_sad": ME_SAD.launches,
            "gather_win": GATHER_WIN.launches} != launches:
        raise AssertionError(f"{name}: kernels=False run launched a kernel")
    log(f"  {name}: kernels=False run of the {n - 1} frames after the IDR: "
        "AUs identical, nothing launched")
    check_small(dev, path["small"], fixture, mesh)
    return launches, ref0


CLI_PATH = "cli_cbr_scene_fastest_1080p"


def run_cli(argv):
    """The port's CLI (homerhevc_tpu_torch.app.main) in this process, its
    standard output captured: (exit code, output text, per encode_frame
    call (launch deltas (me_sad, gather_win), host-clocked ms))."""
    import contextlib
    import io

    from homerhevc_tpu_torch import app
    from homerhevc_tpu_torch.api import HomerEncoder
    from homerhevc_tpu_torch.ops.gather import GATHER_WIN
    from homerhevc_tpu_torch.ops.me import ME_SAD

    frames = []
    encode_frame = HomerEncoder.encode_frame

    def counted(self, *args, **kw):
        before = (ME_SAD.launches, GATHER_WIN.launches)
        t = time.perf_counter()
        au = encode_frame(self, *args, **kw)
        frames.append(((ME_SAD.launches - before[0],
                        GATHER_WIN.launches - before[1]),
                       (time.perf_counter() - t) * 1e3))
        return au

    out = io.StringIO()
    HomerEncoder.encode_frame = counted
    try:
        with contextlib.redirect_stdout(out):
            rc = app.main(argv)
    finally:
        HomerEncoder.encode_frame = encode_frame
    return rc, out.getvalue(), frames


def run_cli_path(dev, fixture, workdir: str):
    """BASELINE.md configuration 4 at 1920x1080 (1088 coded rows) through
    the port's CLI on the default device: CBR at 1250 kbps with its VBV
    model, FASTEST, SAO, sign hiding, -metrics -o-raw -profiling, a scene
    cut at frame 5. The .265, the -o-raw file, the per-frame lines and the
    profiler's stage names must equal the JAX CLI's (the fixture's "cli"
    entry); then the same frames through HomerEncoder(cfg, kernels=False)
    frame by frame. Returns the launch counts and the per-frame record."""
    import hashlib

    import numpy as np

    from homerhevc_tpu_torch import app
    from homerhevc_tpu_torch.api import HomerEncoder
    from homerhevc_tpu_torch.ops.gather import GATHER_WIN
    from homerhevc_tpu_torch.ops.me import ME_SAD
    from homerhevc_tpu_torch.utils import fixtures as fx

    want = fixture["cli"][CLI_PATH]
    yuv, out, raw = (os.path.join(workdir, f) for f in ("in.yuv", "out.265",
                                                        "rec.yuv"))
    fx.write_cli_input(CLI_PATH, yuv)
    argv = fx.cli_argv(CLI_PATH, yuv, out, raw)
    for k in (ME_SAD, GATHER_WIN):
        k.launches = 0
    rc, text, frames = run_cli(argv)                # no -device: the card
    launches = {"me_sad": ME_SAD.launches, "gather_win": GATHER_WIN.launches}
    for line in text.splitlines():
        log("    | " + line)
    if rc != 0:
        raise AssertionError(f"{CLI_PATH}: the CLI exited with {rc}")
    rec = fx.cli_record(text, out, raw)
    for key in ("stream", "raw", "lines", "frames", "tail", "stages"):
        if rec[key] != want[key]:
            raise AssertionError(f"{CLI_PATH}: {key} differs from the JAX "
                                 f"CLI's: {rec[key]} != {want[key]}")
    types = [ln.split(", ")[1] for ln in rec["lines"]]
    if types != ["I"] + ["P"] * 4 + ["I"] + ["P"] * 4:
        raise AssertionError(f"{CLI_PATH}: frame types {types}")
    log(f"  {CLI_PATH}: the port CLI's .265 ({rec['stream']['len']} bytes, "
        f"SHA-256 {rec['stream']['sha256'][:16]}...) and -o-raw file "
        f"({rec['raw']['len']} bytes) == the JAX CLI's; every per-frame line "
        f"equal (I at POC 0 and 5: the scene-change IDR); stage names equal")
    # launches per frame: a P frame runs me_sad once and gathers the luma
    # window and the chroma pair; the scene-cut frame runs its P attempt,
    # then the IDR, which launches nothing
    per_frame = [f[0] for f in frames]
    expect = [(0, 0)] + [(1, 2)] * 9
    if per_frame != expect or launches != {"me_sad": 9, "gather_win": 18}:
        raise AssertionError(f"{CLI_PATH}: launches per frame {per_frame}, "
                             f"expected {expect}; totals {launches}")
    log(f"  {CLI_PATH}: launches (me_sad, gather_win) per frame {per_frame}"
        f" (the scene cut's P attempt at POC 5 included); totals {launches}")

    # the same frames through the API with the plain versions
    args = app.parse_args(argv)
    cfg = app.config_from_args(args, 1920, 1080)
    plain = HomerEncoder(cfg, device=dev, kernels=False)
    clip = fx.clip(CLI_PATH)
    t = time.perf_counter()
    aus = [plain.encode_frame(*clip[0])]
    idr_warm_s = time.perf_counter() - t
    aus += [plain.encode_frame(*f) for f in clip[1:]]
    plain.close()
    digest = hashlib.sha256(b"".join(aus)).hexdigest()
    if digest != want["stream"]["sha256"]:
        raise AssertionError(f"{CLI_PATH}: kernels=False AUs differ from the "
                             "JAX CLI's stream")
    if {"me_sad": ME_SAD.launches,
            "gather_win": GATHER_WIN.launches} != launches:
        raise AssertionError(f"{CLI_PATH}: kernels=False run launched a "
                             "kernel")
    with open(raw, "rb") as f:
        last = np.frombuffer(f.read(), np.uint8)[-1920 * 1080 * 3 // 2:]
    if not np.array_equal(last[:1920 * 1080].reshape(1080, 1920),
                          plain.last_recon[0]):
        raise AssertionError(f"{CLI_PATH}: kernels=False recon differs")
    log(f"  {CLI_PATH}: kernels=False run through HomerEncoder.encode_frame:"
        " AUs == the JAX CLI's stream, last recon == -o-raw, nothing "
        f"launched; its IDR (the second 1080p IDR of this process) "
        f"{idr_warm_s:.2f} s")
    return launches, dict(frames=frames, idr_warm_s=idr_warm_s)


def cli_timing(dev, fixture, workdir: str, first, card: str) -> None:
    """The CLI path's numbers: its first run's IDR (cold) and the warm
    IDR of the kernels=False session (phase 4), then the CLI once more,
    warm: per-frame ms (host clock; each frame ends in the -metrics recon
    fetch, which waits for the card), ms per P frame, the CLI's own fps
    and the profiler's stage breakdown."""
    from homerhevc_tpu_torch.utils import fixtures as fx

    yuv, out, raw = (os.path.join(workdir, f) for f in ("in.yuv", "out.265",
                                                        "rec.yuv"))
    rc, text, frames = run_cli(fx.cli_argv(CLI_PATH, yuv, out, raw))
    if rc != 0:
        raise AssertionError(f"{CLI_PATH}: the warm CLI run exited {rc}")
    rec = fx.cli_record(text, out, raw)
    if rec["stream"] != fixture["cli"][CLI_PATH]["stream"]:
        raise AssertionError(f"{CLI_PATH}: the warm CLI run's stream differs")
    lines = text.splitlines()
    final = next(ln for ln in lines if " frames in " in ln)
    ms = [f[1] for f in frames]
    p_ms = [m for k, m in enumerate(ms) if k not in (0, 5)]
    log(f"  {CLI_PATH}: IDR at POC 0, cold (first CLI run): "
        f"{first['frames'][0][1]:.1f} ms; IDR warm (kernels=False session): "
        f"{first['idr_warm_s'] * 1e3:.1f} ms; on {card}")
    log(f"  {CLI_PATH}: warm CLI run, ms per frame "
        f"{', '.join(f'{m:.1f}' for m in ms)} (POC 5: P attempt + scene-cut "
        f"IDR {ms[5]:.1f} ms); P frames mean {sum(p_ms) / len(p_ms):.1f} ms "
        f"with -metrics; the CLI's line: {final}; on {card}")
    report = lines[lines.index("profiler: stage breakdown") + 1:]
    log(f"  {CLI_PATH}: profiler (warm run): "
        + "; ".join(" ".join(ln.split()[:3]) for ln in report))


def ibp_timing(dev, name, ref0, card: str) -> None:
    """IBP end to end after the IDR, warm: the 9 frames (4 anchor P, 4 B,
    the explicit P) from the IDR's planes, twice; the second run's frames
    per second and its B frames' host-clocked milliseconds."""
    import torch

    from homerhevc_tpu_torch.utils import fixtures as fx

    path = IBP_PATHS[name]
    frames = fx.clip(path["run"])[1:path["frames"]]
    cfg = fx.run_config(path["run"])
    for rep in range(2):
        events = []
        enc = ibp_session(cfg, dev, True, events)
        enc.seed_reference(ref0, poc=0, last_idr=0)
        enc._disp = 1
        torch.cuda.synchronize()
        t = time.perf_counter()
        aus = push_all(enc, frames, 1, events)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        enc.close()
    b_ms = [e[2] for e in events if e[0] == "b"]
    p_ms = [e[2] for e in events if e[0] == "explicit"]
    log(f"  {name}: {len(frames)} frames after the IDR end to end (warm): "
        f"{secs * 1000:.1f} ms -> {len(frames) / secs:.2f} fps "
        f"({sum(len(a) for a in aus)} bytes); B frames "
        f"{', '.join(f'{m:.1f}' for m in b_ms)} ms (mean "
        f"{sum(b_ms) / len(b_ms):.1f} ms per B frame), explicit P "
        f"{p_ms[0]:.1f} ms; host-clocked, each ending in "
        f"torch.cuda.synchronize(), on {card}")


# The band-sharded fixed-CU stage at full size (phases 3 and 5), on a mesh
# that names the one card lanes x bands times. Lane g codes frame g + 1 of
# the clip against frame g, edge-padded to the coded size, at QP 32.
# 720p at CU 64: 4 bands of 3 CTU rows (halo 24 at search 16); 1080p at CU
# 32 with search 64: 2 bands of 17 CTU rows through the hierarchical search
# (halo 72 = PAD). Launches per step: me_sad one per band at search <= 24;
# gather_win the luma window and the chroma pair per band, and above search
# 24 the refine window of the hierarchical search too.
BAND_STEPS = {
    "band_720p_b64": dict(clip="720p", lanes=2, bands=4, height=768,
                          width=1280, B=64, search=16, me_sad=8,
                          gather_win=16),
    "band_1080p_b32_s64": dict(clip=CLI_PATH, lanes=1, bands=2, height=1088,
                               width=1920, B=32, search=64, me_sad=0,
                               gather_win=6),
}
# The quadtree stage with its deblocking at full size (phases 3 and 5), on
# a mesh that names the one card 4 times: frame 1 of the 720p clip against
# frame 0, edge-padded to the coded size, QP 32, the stage settings of a
# phase-4 path: default_720p (CTU 64, search 16) in bands of 3 CTU rows
# (192), fast_720p (CTU 32, search 64, intra-in-P) in bands of 6, 6, 6, 5
# (192 and 160 rows). Launches: gather_win the path's 6 per band.
TREE_BAND_STEPS = {
    "tree_720p_ctu64": dict(path="default_720p", bands=4, gather_win=24),
    "tree_720p_ctu32_s64": dict(path="fast_720p", bands=4, gather_win=24),
}
# The B stage in bands (phases 3 and 5), on a mesh that names the card 4
# times: frame 1 of the 720p clip between frames 0 and 2, edge-padded to
# 736 rows, at an IBP path's settings and its B frames' QP (34), in bands
# of 6, 6, 6, 5 CTU rows (192 and 160 rows): ibp_fastest_720p's (search
# 16: me_sad per list and band) and ibp_fast_720p's (search 64: the
# hierarchical search, halo 72 = PAD). Launches per step: per band and
# list me_sad 1 at search <= 24, gather_win the luma window and the chroma
# pair, and above search 24 the refine window.
B_BAND_STEPS = {
    "b_720p_s16": dict(path="ibp_fastest_720p", bands=4, me_sad=8,
                       gather_win=16),
    "b_720p_s64": dict(path="ibp_fast_720p", bands=4, me_sad=0,
                       gather_win=24),
}
# The IDR in bands at full size (phase 5), on a mesh that names the card 4
# times, on the padded first frame of the 720p clip: pass A of the
# split-RDO IDR (rd_mode FULL and FAST, TU split on) in bands of 6, 6, 6, 5
# CTU rows against its whole-frame run, and the fixed-CU IDR (FASTEST) at
# B 32 (6, 6, 6, 5) and B 64 (3, 3, 3, 3) with its deblocking and SAO
# against encode_frame_intra and the single-device filter. No kernel runs
# in an IDR.
INTRA_BAND_STEPS = {
    "pass_a_720p_rd1": dict(kind="pass_a", B=32, rd_mode=1),
    "pass_a_720p_rd2": dict(kind="pass_a", B=32, rd_mode=2),
    "idr_fixed_720p_b32": dict(kind="idr", B=32),
    "idr_fixed_720p_b64": dict(kind="idr", B=64),
    # CTU 16: 45 CTU rows in bands of 12, 11, 11, 11 (the second band starts
    # at row 192, the third at 368, 16 rows off the IDR's 32-row TU grid)
    "pass_a_720p_b16_rd1": dict(kind="pass_a", B=16, rd_mode=1),
    "idr_fixed_720p_b16": dict(kind="idr", B=16),
}
# the session paths of phase 4 run again on a mesh of the card named 4
# times: fastest_720p and fast_720p cut 23 CTU rows into bands of 6, 6, 6,
# 5, the CTU-64 paths 12 into 3, 3, 3, 3. The fixed-CU paths and fast_720p
# code their IDR in bands (fast_720p's split-RDO IDR: pass A and pass B's
# wavefront in bands, its kernels=False run continuing from that IDR's
# planes); default_720p and full64_720p continue from their IDR planes of
# phase 4 (full64_720p from default_720p's), and their small clips code the
# CTU-64 split-RDO IDR in bands
MESH_PATHS = ("fastest_720p", "fastest64_720p", "fast_720p", "default_720p",
              "full64_720p", "fastest16_720p")
MESH_IDR_PATHS = ("fastest_720p", "fastest64_720p", "fast_720p",
                  "fastest16_720p")
MESH_BANDS = 4
# the two-process GopPipeline: fastest_720p's configuration with an IDR
# every 6 frames, spans of 4, 9 frames (the IDR at POC 6 falls inside the
# second span); each child's time limit
GOP_FRAMES, GOP_SPAN, GOP_INTRA_PERIOD = 9, 4, 6
GOP_TIMEOUT_S = 300


def band_inputs(dev, st):
    """(current, reference) planes of a BAND_STEPS step: two lists of three
    (lanes, h, w) uint8 tensors on `dev`."""
    import numpy as np
    import torch

    from homerhevc_tpu_torch.utils import fixtures as fx

    frames = fx.clip(st["clip"])[:st["lanes"] + 1]
    H, W = st["height"], st["width"]

    def planes(idx):
        return [torch.as_tensor(np.stack([
            pad_plane(frames[i][k], H >> (k > 0), W >> (k > 0))
            for i in idx]), device=dev) for k in range(3)]

    lanes = list(range(st["lanes"]))
    return planes([g + 1 for g in lanes]), planes(lanes)


def band_step(dev, st, kernels: bool = True):
    """make_p_frame_sharded for a BAND_STEPS step on a mesh that names
    `dev` lanes x bands times."""
    from homerhevc_tpu_torch.parallel import sharded
    return sharded.make_p_frame_sharded(
        [[dev] * st["bands"]] * st["lanes"], B=st["B"], search=st["search"],
        me_precision=2, kernels=kernels)


def tree_step(dev, name, kernels: bool = True):
    """A TREE_BAND_STEPS step: (the step in bands, the single-device
    stage), each a callable that returns p_frame_tree_device's dict
    (deblocked), and the bands' row counts."""
    import numpy as np
    import torch

    from homerhevc_tpu_torch.api import HomerEncoder
    from homerhevc_tpu_torch.parallel import sharded
    from homerhevc_tpu_torch.pipeline import p_torch
    from homerhevc_tpu_torch.utils import fixtures as fx

    st = TREE_BAND_STEPS[name]
    cfg = fx.run_config(PATHS[st["path"]]["run"])
    enc = HomerEncoder(cfg, device=dev, kernels=kernels)
    kw = dict(enc._tree_kwargs(), qp=32, deblock=True)
    frames = [enc._pad_frame(*f) for f in fx.clip("720p")[:2]]
    enc.close()
    cur, ref = ([torch.as_tensor(np.ascontiguousarray(p), device=dev)
                 for p in f] for f in (frames[1], frames[0]))
    mesh = [dev] * st["bands"]
    rows, _ = sharded.band_rows(mesh, cfg.padded_height, cfg.cu_size)
    return (lambda: sharded.p_frame_tree_bands(mesh, *cur, *ref, **kw),
            lambda: p_torch.p_frame_tree_device(*cur, *ref, **kw), rows)


def b_step(dev, name, kernels: bool = True):
    """A B_BAND_STEPS step: (the B stage in bands, the single-device
    b_frame_device), each a callable that returns its dict, and the bands'
    row counts."""
    import numpy as np
    import torch

    from homerhevc_tpu_torch.api import HomerEncoder
    from homerhevc_tpu_torch.parallel import sharded
    from homerhevc_tpu_torch.pipeline import b_torch
    from homerhevc_tpu_torch.utils import fixtures as fx

    st = B_BAND_STEPS[name]
    cfg = fx.run_config(IBP_PATHS[st["path"]]["run"])
    enc = HomerEncoder(cfg, device=dev)
    frames = [enc._pad_frame(*f) for f in fx.clip("720p")[:3]]
    enc.close()
    cur, ref0, ref1 = ([torch.as_tensor(np.ascontiguousarray(p), device=dev)
                        for p in f] for f in (frames[1], frames[0],
                                              frames[2]))
    kw = dict(B=cfg.cu_size, qp=cfg.qp + 2, search=cfg.me_search_range,
              me_precision=int(cfg.motion_estimation_precision),
              sign_hiding=cfg.sign_hiding, vis=(cfg.height, cfg.width),
              kernels=kernels)
    mesh = [dev] * st["bands"]
    rows, _ = sharded.band_rows(mesh, cfg.padded_height, cfg.cu_size)
    return (lambda: sharded.b_frame_bands(mesh, *cur, *ref0, *ref1, **kw),
            lambda: b_torch.b_frame_device(*cur, *ref0, *ref1, **kw), rows)


def gather_site_kind(pair: bool, G: int) -> str:
    """What a gather_win call gathers, from its window side G: the chroma
    pair, the hierarchical search's refine window (S + 6) or the luma
    support window (S + 9)."""
    return ("chroma pair" if pair else
            "hier refine" if G - 6 in (8, 16, 32, 64) else "luma")


def phase_band_sites(dev, records) -> None:
    """The kernels at the band stages' call sites: one run of each
    BAND_STEPS, TREE_BAND_STEPS and B_BAND_STEPS step records the
    arguments of every distinct kernel call (shapes, B, G; the B stage's
    apart from the P stages'); each is held against its plain version
    (exact) and timed as the other sites are. Adds the sites to
    `records`."""
    import torch

    from homerhevc_tpu_torch.ops import gather, me
    from homerhevc_tpu_torch.pipeline import p_torch

    seen = {}
    wrappers = (me.integer_me_cuda, gather.gather_windows_cuda)

    def recorder(kind, fn, step):
        stage = "b" if step in B_BAND_STEPS else "p"

        def call(*args, **kw):
            if kind == "me_sad":
                key = (kind, tuple(args[0].shape), kw["B"], kw["search"])
            else:
                pair = isinstance(args[0], tuple)
                first = args[0][0] if pair else args[0]
                key = (kind, pair, tuple(first.shape), args[3])
            seen.setdefault(key + (stage,), (step, args, kw))
            return fn(*args, **kw)
        return call

    try:
        for name, st in BAND_STEPS.items():
            me.integer_me_cuda = recorder("me_sad", wrappers[0], name)
            gather.gather_windows_cuda = recorder("gather_win", wrappers[1],
                                                  name)
            cur, ref = band_inputs(dev, st)
            band_step(dev, st)(*cur, *ref, [32] * st["lanes"])
        for name in TREE_BAND_STEPS:
            me.integer_me_cuda = recorder("me_sad", wrappers[0], name)
            gather.gather_windows_cuda = recorder("gather_win", wrappers[1],
                                                  name)
            tree_step(dev, name)[0]()
        for name in B_BAND_STEPS:
            me.integer_me_cuda = recorder("me_sad", wrappers[0], name)
            gather.gather_windows_cuda = recorder("gather_win", wrappers[1],
                                                  name)
            b_step(dev, name)[0]()
    finally:
        me.integer_me_cuda, gather.gather_windows_cuda = wrappers
    torch.cuda.synchronize()
    for key, (step, args, kw) in seen.items():
        if key[0] == "me_sad":
            cur, ref_pad, mvcost = args
            H, W = cur.shape
            label = f"{step}: band {H}x{W}, B={kw['B']}, S={kw['search']}"
            ck, ik = me.integer_me_cuda(cur, ref_pad, mvcost, **kw)
            cp, ip = me.integer_me_plain(cur, ref_pad, mvcost, **kw)
            torch.cuda.synchronize()
            err = max(int((ck - cp).abs().max()), int((ik - ip).abs().max()))
            if err or ck.shape != cp.shape:
                raise AssertionError(f"me_sad != plain at {label}: max abs "
                                     f"difference {err}")
            log(f"  me_sad == plain at {label}")
            t = time_me(dev, cur, ref_pad, mvcost, H, W, kw["B"],
                        kw["search"])
            t["site"] = label
            records["me_sad"]["sites"].append(t)
        else:
            plane, by, bx, G = args
            rows = (plane[0].shape[0] * 2 if key[1]
                    else plane.shape[0]) - p_torch.PAD * 2
            label = (f"{step}: {rows}-row band {gather_site_kind(key[1], G)}"
                     f" G={G}")
            err = check_gather(dev, {label: (plane, by, bx, G)}, step)
            records["gather_win"]["max_abs_err"] = max(
                records["gather_win"]["max_abs_err"], err)
            records["gather_win"]["sites"].append(
                time_gather(dev, label, plane, by, bx, G))
    kinds = sorted(k[0] for k in seen)
    # the fixed-CU steps' 5 gathers and the quadtree's 6 on each of the
    # two band heights (192 and 160 rows): the two quadtree steps share
    # their 192-row sites (plane shape, nb and G; recorded under the first,
    # the CTU-64 step), whose G 73 and G 35 pair are the fixed-CU 720p
    # step's; the B stage's me_sad and its 3 gathers (luma G 41, the G 19
    # pair, the refine window G 38 at search 64) on each band height
    if kinds != ["gather_win"] * 23 + ["me_sad"] * 3:
        raise AssertionError(f"band sites recorded: {sorted(seen)}")


def run_band_steps(dev, card: str) -> dict:
    """Each BAND_STEPS step on the card with the launch counts set to 0
    just before it and read just after; then every output, lane by lane,
    against the single-device stage p_frame_device, and the step with
    kernels=False against it too; then the step's time against the
    single-device stage's on the same lanes. Returns {step: launches}."""
    import torch

    from homerhevc_tpu_torch.ops.gather import GATHER_WIN
    from homerhevc_tpu_torch.ops.me import ME_SAD
    from homerhevc_tpu_torch.parallel.sharded import OUTPUTS
    from homerhevc_tpu_torch.pipeline import p_torch

    out = {}
    for name, st in BAND_STEPS.items():
        cur, ref = band_inputs(dev, st)
        qps = [32] * st["lanes"]
        step = band_step(dev, st)
        for k in (ME_SAD, GATHER_WIN):
            k.launches = 0
        got = step(*cur, *ref, qps)
        torch.cuda.synchronize()
        launches = {"me_sad": ME_SAD.launches,
                    "gather_win": GATHER_WIN.launches}
        want = {"me_sad": st["me_sad"], "gather_win": st["gather_win"]}
        if launches != want:
            raise AssertionError(f"{name}: launches {launches}, expected "
                                 f"{want}")
        plain = band_step(dev, st, kernels=False)(*cur, *ref, qps)

        def single():
            return [p_torch.p_frame_device(
                *(p[g] for p in cur), *(p[g] for p in ref), B=st["B"],
                qp=32, search=st["search"], me_precision=2)
                for g in range(st["lanes"])]

        for g, one in enumerate(single()):
            for key, a, b in zip(OUTPUTS, got, plain):
                if not (torch.equal(a[g], one[key])
                        and torch.equal(b[g], one[key])):
                    raise AssertionError(f"{name}: {key} of lane {g} differs "
                                         "from the single-device stage")
        band_ms = synced_ms(lambda: step(*cur, *ref, qps), 3)
        single_ms = synced_ms(single, 3)
        log(f"  {name}: {st['lanes']} lane(s) x {st['bands']} bands of "
            f"{st['height'] // st['bands']} rows, {st['height']}x"
            f"{st['width']}, B {st['B']}, search {st['search']}: every "
            f"output == p_frame_device with and without the kernels; "
            f"launches {launches}; {band_ms:.1f} ms a step against "
            f"{single_ms:.1f} ms for the single-device stage on the same "
            f"lanes (host clock, best of 3, synchronised) on {card}")
        out[name] = launches
    return out


def run_tree_band_steps(dev, card: str) -> dict:
    """Each TREE_BAND_STEPS step on the card with the launch counts set to
    0 just before it and read just after; every output (unit maps, levels,
    wire, reconstruction, deblocked planes) against the single-device
    stage p_frame_tree_device, with and without the kernels; then the
    step's time against the single-device stage's. Returns {step:
    launches}."""
    import torch

    from homerhevc_tpu_torch.ops.gather import GATHER_WIN
    from homerhevc_tpu_torch.ops.me import ME_SAD

    out = {}
    for name, st in TREE_BAND_STEPS.items():
        bands, single, rows = tree_step(dev, name)
        for k in (ME_SAD, GATHER_WIN):
            k.launches = 0
        got = bands()
        torch.cuda.synchronize()
        launches = {"me_sad": ME_SAD.launches,
                    "gather_win": GATHER_WIN.launches}
        want = {"me_sad": 0, "gather_win": st["gather_win"]}
        if launches != want:
            raise AssertionError(f"{name}: launches {launches}, expected "
                                 f"{want}")
        plain = tree_step(dev, name, kernels=False)[0]()
        one = single()
        for key, w in one.items():
            if not (torch.equal(got[key], w) and torch.equal(plain[key], w)):
                raise AssertionError(f"{name}: {key} differs from the "
                                     "single-device stage")
        band_ms = synced_ms(bands, 3)
        single_ms = synced_ms(single, 3)
        log(f"  {name}: {PATHS[st['path']]['run']}'s stage settings, bands "
            f"of {rows} rows: every output == p_frame_tree_device (deblocked "
            f"too) with and without the kernels; launches {launches}; "
            f"{band_ms:.1f} ms a step against {single_ms:.1f} ms for the "
            f"single-device stage (host clock, best of 3, synchronised) on "
            f"{card}")
        out[name] = launches
    return out


def run_b_band_steps(dev, card: str) -> dict:
    """Each B_BAND_STEPS step on the card with the launch counts set to 0
    just before it and read just after; every output (idc, MVs, levels,
    reconstruction, the wire) against the single-device b_frame_device,
    with and without the kernels; then the step's time against the
    single-device stage's. Returns {step: launches}."""
    import torch

    from homerhevc_tpu_torch.ops.gather import GATHER_WIN
    from homerhevc_tpu_torch.ops.me import ME_SAD

    out = {}
    for name, st in B_BAND_STEPS.items():
        bands, single, rows = b_step(dev, name)
        for k in (ME_SAD, GATHER_WIN):
            k.launches = 0
        got = bands()
        torch.cuda.synchronize()
        launches = {"me_sad": ME_SAD.launches,
                    "gather_win": GATHER_WIN.launches}
        want = {"me_sad": st["me_sad"], "gather_win": st["gather_win"]}
        if launches != want:
            raise AssertionError(f"{name}: launches {launches}, expected "
                                 f"{want}")
        plain = b_step(dev, name, kernels=False)[0]()
        one = single()
        if got.keys() != one.keys():
            raise AssertionError(f"{name}: outputs {sorted(got)}")
        for key, w in one.items():
            if not (torch.equal(got[key], w) and torch.equal(plain[key], w)):
                raise AssertionError(f"{name}: {key} differs from the "
                                     "single-device stage")
        band_ms = synced_ms(bands, 3)
        single_ms = synced_ms(single, 3)
        log(f"  {name}: {IBP_PATHS[st['path']]['run']}'s B frame settings, "
            f"bands of {rows} rows: every output == b_frame_device (the "
            f"wire too) with and without the kernels; launches {launches}; "
            f"{band_ms:.1f} ms a step against {single_ms:.1f} ms for the "
            f"single-device stage (host clock, best of 3, synchronised) on "
            f"{card}")
        out[name] = launches
    return out


def run_intra_band_steps(dev, card: str) -> None:
    """Each INTRA_BAND_STEPS step on the card: pass A in bands against the
    whole frame's maps, the fixed-CU IDR in bands (deblocking and SAO
    included) against encode_frame_intra's every output and the
    single-device filter's planes and parameters; both timed (host clock,
    synchronised), in bands and on one device. Asserts that no kernel
    runs."""
    import numpy as np
    import torch

    from homerhevc_tpu_torch import tables
    from homerhevc_tpu_torch.ops.gather import GATHER_WIN
    from homerhevc_tpu_torch.ops.me import ME_SAD
    from homerhevc_tpu_torch.ops.sao import sao_stage_device
    from homerhevc_tpu_torch.parallel import intra_bands, sharded
    from homerhevc_tpu_torch.pipeline import intra_torch, p_torch
    from homerhevc_tpu_torch.utils import fixtures as fx

    qp = 32
    qp_t = torch.tensor(qp, dtype=torch.int32, device=dev)
    lam = torch.as_tensor(tables.LAMBDA_FX, device=dev)[qp_t]
    first = fx.clip("720p")[0]
    for name, st in INTRA_BAND_STEPS.items():
        B = st["B"]
        H = -(-720 // B) * B
        planes = [torch.as_tensor(pad_plane(p, H >> (k > 0), 1280 >> (k > 0)),
                                  device=dev) for k, p in enumerate(first)]
        mesh = [dev] * MESH_BANDS
        rows, devs = sharded.band_rows(mesh, H, B)
        before = ME_SAD.launches + GATHER_WIN.launches
        if st["kind"] == "pass_a":
            kw = dict(strong_smoothing=True, rd_mode=st["rd_mode"],
                      tu_split=True)

            def bands():
                parts = intra_bands.open_loop_maps_bands(
                    planes[0], rows, devs, qp=qp, B=B, **kw)
                return [torch.cat([p[k] for p in parts]) for k in range(4)]

            def single():
                return intra_torch._open_loop_maps(planes[0], B=B, qp=qp_t,
                                                   lam_fx=lam, **kw)
            reps = 2
        else:
            kw = dict(B=B, qp=qp, sign_hiding=True, split_rdo=False)

            def bands():
                return intra_bands.intra_frame_bands(
                    mesh, *planes, deblock=True, sao=True, **kw)

            def single():
                out = intra_torch.encode_frame_intra(*planes, **kw)
                fy = p_torch.deblock_intra_device(
                    out["recon_y"], out["recon_u"], out["recon_v"], qp=qp,
                    depth_units=out["depth_units"])
                info, filt = sao_stage_device(
                    planes, fy, B, qp, int(tables.chroma_qp_from_luma(qp)))
                out.update(sao_info=info, **{f"ref_{k}": f for k, f in
                                             zip("yuv", filt)})
                return out
            reps = 1
        band_ms = synced_ms(bands, reps)
        got = bands()
        single_ms = synced_ms(single, reps)
        want = single()
        torch.cuda.synchronize()
        if ME_SAD.launches + GATHER_WIN.launches != before:
            raise AssertionError(f"{name}: a kernel was launched")
        if isinstance(want, dict):
            info_g, info_w = got.pop("sao_info"), want.pop("sao_info")
            same = got.keys() == want.keys() and all(
                torch.equal(got[k], want[k]) for k in want) and all(
                np.array_equal(np.asarray(info_g[c][k]),
                               np.asarray(info_w[c][k]))
                for c in ("luma", "cb", "cr") for k in info_w[c]) and all(
                np.array_equal(info_g[k], info_w[k])
                for k in ("merge_left", "merge_up"))
        else:
            same = all(torch.equal(g, w) for g, w in zip(got, want))
        if not same:
            raise AssertionError(f"{name}: the bands differ from the "
                                 "single-device function")
        log(f"  {name}: {H}x1280 in bands of {rows} rows: every output == "
            "the single-device function's" + (
                " (deblocked and SAO-filtered planes, SAO parameters "
                "included)" if st["kind"] == "idr" else " (unit maps)")
            + f"; no kernel launched; {band_ms:.1f} ms in bands against "
            f"{single_ms:.1f} ms on one device (host clock, "
            f"{'best of 2' if reps == 2 else 'one call'}, synchronised) on "
            f"{card}")


def mesh_timing(dev, name, ref0, card: str) -> None:
    """8 P frames end to end from a path's IDR planes, warm, on one device
    and on the mesh, in turns (one device, mesh, mesh, one device)."""
    import torch

    from homerhevc_tpu_torch.api import HomerEncoder
    from homerhevc_tpu_torch.utils import fixtures as fx

    path = PATHS[name]
    cfg = fx.run_config(path["run"])
    frames = fx.clip(path["run"])[1:9]
    ms = {"one device": [], "mesh": []}
    for label in ("mesh", "one device", "mesh", "mesh", "one device"):
        mesh = [dev] * MESH_BANDS if label == "mesh" else None
        enc = HomerEncoder(cfg, device=dev, mesh=mesh)
        enc.seed_reference(ref0, poc=1, last_idr=0)
        torch.cuda.synchronize()
        t = time.perf_counter()
        enc.encode_frames(frames, chunk=8)
        torch.cuda.synchronize()
        ms[label].append((time.perf_counter() - t) * 1e3)
        enc.close()
    ms["mesh"] = ms["mesh"][1:]                 # the first was the warm-up
    log(f"  {name}: 8 P frames end to end, warm: one device "
        f"{', '.join(f'{m:.1f}' for m in ms['one device'])} ms, mesh of "
        f"{MESH_BANDS} {', '.join(f'{m:.1f}' for m in ms['mesh'])} ms "
        f"(runs in turns) on {card}")


def run_wpp_shards(dev, fixture) -> dict:
    """fastest_720p with wpp_shards 4 and no mesh: the session builds one
    only where the machine has 4 CUDA devices; the AUs are the fixture's
    either way. Returns the launches."""
    import torch

    from homerhevc_tpu_torch.api import HomerEncoder
    from homerhevc_tpu_torch.ops.gather import GATHER_WIN
    from homerhevc_tpu_torch.ops.me import ME_SAD
    from homerhevc_tpu_torch.utils import fixtures as fx

    path = PATHS["fastest_720p"]
    n = path["frames"]
    cfg = dataclasses.replace(fx.run_config(path["run"]), wpp_shards=4)
    for k in (ME_SAD, GATHER_WIN):
        k.launches = 0
    enc = HomerEncoder(cfg)
    meshed = torch.cuda.device_count() >= 4
    if (enc._mesh is not None) != meshed:
        raise AssertionError(f"wpp_shards=4 with {torch.cuda.device_count()}"
                             f" CUDA device(s): mesh {enc._mesh}")
    aus = enc.encode_frames(fx.clip(path["run"])[:n], chunk=8)
    enc.close()
    torch.cuda.synchronize()
    launches = {"me_sad": ME_SAD.launches, "gather_win": GATHER_WIN.launches}
    bands = 4 if meshed else 1
    want = {k: path[k] * (n - 1) * bands for k in launches}
    if launches != want:
        raise AssertionError(f"wpp_shards=4: launches {launches}, expected "
                             f"{want}")
    if fx.au_digest(aus) != fixture[path["run"]]["aus"][:n]:
        raise AssertionError("wpp_shards=4: AUs differ from the JAX fixture")
    log(f"  fastest_720p with wpp_shards=4 on {torch.cuda.device_count()} "
        f"CUDA device(s): {'a mesh of 4' if meshed else 'no mesh'}, AUs == "
        f"JAX fixture ({n} AUs), launches {launches}")
    return launches


def gop_config():
    """The GopPipeline's configuration: fastest_720p's with an IDR every
    GOP_INTRA_PERIOD frames."""
    from homerhevc_tpu_torch.utils import fixtures as fx
    return dataclasses.replace(fx.run_config(PATHS["fastest_720p"]["run"]),
                               intra_period=GOP_INTRA_PERIOD)


def gop_worker(argv) -> int:
    """One process of the GopPipeline (chip_smoke.py --gop-worker RANK
    WORLD PORT OUT): joins the gloo group on 127.0.0.1:PORT, encodes its
    spans on the card and writes the stitched stream's AU digests and its
    own launch counts to OUT (JSON)."""
    from homerhevc_tpu_torch.ops.gather import GATHER_WIN
    from homerhevc_tpu_torch.ops.me import ME_SAD
    from homerhevc_tpu_torch.parallel import multihost
    from homerhevc_tpu_torch.utils import fixtures as fx

    rank, world, port, out = int(argv[0]), int(argv[1]), argv[2], argv[3]
    multihost.init(rank, world, coordinator=f"127.0.0.1:{port}")
    pipe = multihost.GopPipeline(gop_config(), span=GOP_SPAN)
    try:
        aus = pipe.encode(fx.clip("720p")[:GOP_FRAMES])
    finally:
        pipe.close()
    with open(out, "w") as f:
        json.dump(dict(aus=fx.au_digest(aus), launches={
            "me_sad": ME_SAD.launches, "gather_win": GATHER_WIN.launches}), f)
    return 0


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_gop_pipeline(card: str) -> dict:
    """The GopPipeline in two child processes sharing the card, over gloo
    on a free 127.0.0.1 port: both stitched streams must equal the
    single-process session's (encode_frame frame by frame, in this
    process). Each child is killed at its time limit; a non-zero exit
    fails. Returns the children's launches together."""
    import torch

    from homerhevc_tpu_torch.api import HomerEncoder
    from homerhevc_tpu_torch.utils import fixtures as fx

    frames = fx.clip("720p")[:GOP_FRAMES]
    enc = HomerEncoder(gop_config())
    t = time.perf_counter()
    want = fx.au_digest([enc.encode_frame(*f) for f in frames])
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t
    enc.close()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_gop_")
    outs = [os.path.join(workdir, f"rank{r}.json") for r in range(2)]
    port = str(free_port())
    t = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--gop-worker", str(r),
         "2", port, outs[r]], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    texts = []
    try:
        for p in procs:
            texts.append(p.communicate(timeout=GOP_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    pipe_s = time.perf_counter() - t
    for r, (p, text) in enumerate(zip(procs, texts)):
        if p.returncode != 0:
            raise AssertionError(f"GopPipeline rank {r} exited "
                                 f"{p.returncode}:\n{text[-4000:]}")
    res = []
    for path in outs:
        with open(path) as f:
            res.append(json.load(f))
    shutil.rmtree(workdir)
    for r, got in enumerate(res):
        if got["aus"] != want:
            raise AssertionError(f"GopPipeline rank {r}: stream differs from "
                                 "the single-process session's")
    # rank 0 codes spans 0 and 2 (P frames 1-3 and 8), rank 1 span 1 (P
    # frames 4, 5 and 7; 6 is the IDR): one me_sad and two gathers each
    per_rank = [r["launches"] for r in res]
    if per_rank != [{"me_sad": 4, "gather_win": 8},
                    {"me_sad": 3, "gather_win": 6}]:
        raise AssertionError(f"GopPipeline launches per rank {per_rank}")
    log(f"  GopPipeline, 2 processes over gloo sharing the card: both "
        f"stitched streams ({GOP_FRAMES} AUs, span {GOP_SPAN}, IDR at POC 0 "
        f"and {GOP_INTRA_PERIOD}) == the single-process session's; launches "
        f"per rank {per_rank}; {pipe_s:.1f} s from spawn to both exits "
        f"(process start, CUDA set-up and kernel loading included), against "
        f"{single_s:.1f} s for the single-process session's frames (warm "
        f"process) on {card}")
    return {k: sum(r[k] for r in per_rank) for k in per_rank[0]}


def phase_mesh(dev, fixture, by_path, card: str) -> None:
    """Multi-device on the one card: the band stages at full size, the
    session on a mesh of 4 (MESH_PATHS) and with wpp_shards 4, the
    two-process GopPipeline. Adds each run's launches to `by_path`."""
    for name, launches in run_band_steps(dev, card).items():
        by_path[name] = (launches, None)
    for name, launches in run_tree_band_steps(dev, card).items():
        by_path[name] = (launches, None)
    for name, launches in run_b_band_steps(dev, card).items():
        by_path[name] = (launches, None)
    run_intra_band_steps(dev, card)
    seeds = {p: r[1] for p, r in by_path.items()}
    for name in MESH_PATHS:
        idr = None if name in MESH_IDR_PATHS else by_path[name][1]
        by_path[f"{name}_mesh{MESH_BANDS}"] = run_path(
            dev, name, fixture, seeds, mesh=[dev] * MESH_BANDS, idr=idr)
    by_path[f"ibp_fastest_720p_mesh{MESH_BANDS}"] = run_ibp_path(
        dev, "ibp_fastest_720p", fixture, mesh=[dev] * MESH_BANDS)
    mesh_timing(dev, "fastest_720p", by_path["fastest_720p"][1], card)
    by_path["wpp_shards4_720p"] = (run_wpp_shards(dev, fixture), None)
    by_path["gop_pipeline_720p"] = (run_gop_pipeline(card), None)


def synced_ms(fn, reps: int = 1) -> float:
    """Least host-clock milliseconds of `reps` synchronised calls of fn."""
    import torch
    best = None
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t) * 1e3
        best = dt if best is None else min(best, dt)
    return best


def phase_timing(dev, name, n_p: int, ref0, card: str):
    """End-to-end and device-stage times of one path at 720p; the sessions
    continue from the planes `ref0` behind the IDR. A fixed-CU IDR's device
    stage is timed warm (phase 4 coded it once). A split-RDO IDR takes most
    of a minute or more, the same cold and warm: phase 4 printed its time,
    and only its pass A is timed here."""
    import numpy as np
    import torch

    from homerhevc_tpu_torch.api import HomerEncoder
    from homerhevc_tpu_torch.pipeline import intra_torch, p_chunk
    from homerhevc_tpu_torch.utils import fixtures as fx

    run = PATHS[name]["run"]
    frames = fx.clip("720p")[:n_p + 1]         # both runs share the clip
    cfg = fx.run_config(run)
    enc = HomerEncoder(cfg, device=dev)
    enc.seed_reference(ref0, poc=1, last_idr=0)
    enc.encode_frames(frames[1:9], chunk=8)         # warm-up chunk
    enc2 = HomerEncoder(cfg, device=dev)
    enc2.seed_reference(ref0, poc=1, last_idr=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    aus = enc2.encode_frames(frames[1:], chunk=8)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    log(f"  {name}: {n_p} P frames end to end: {secs * 1000:.1f} ms -> "
        f"{n_p / secs:.2f} fps ({sum(len(a) for a in aus)} bytes) on {card}")

    # device-only view of the same work: one chunk of 8 P frames, and the IDR
    # (of a split-RDO IDR, pass A alone)
    padded = [enc2._pad_frame(*f) for f in frames[1:9]]
    ys, us, vs = (torch.as_tensor(np.stack([p[k] for p in padded]),
                                  device=dev) for k in range(3))
    qps = torch.full((8,), cfg.qp, dtype=torch.int32, device=dev)
    ref = enc._ref
    ms = synced_ms(lambda: p_chunk.p_chunk_device(
        ys, us, vs, *ref, qps, deblock=True, sao=True, cap=enc._chunk_cap,
        tree=enc.inter_split, **enc._tree_kwargs()), 3)
    log(f"  {name}: P chunk of 8 (device, sync'd): {ms:.1f} ms -> "
        f"{8e3 / ms:.2f} fps on {card}")
    yp = tuple(torch.as_tensor(p, device=dev)
               for p in enc2._pad_frame(*frames[0]))
    tu = enc.params.max_tr_depth_intra
    if enc.intra_split:
        pass_a_timing(dev, name, yp[0], cfg, bool(tu), card)
    else:
        ms = synced_ms(lambda: intra_torch.encode_frame_intra(
            *yp, B=enc.ctu, qp=cfg.qp, sign_hiding=True, split_rdo=False,
            tu_depth=tu))
        log(f"  {name}: IDR device stage (warm): {ms:.1f} ms on {card}")
    enc.close()
    enc2.close()


def pass_a_timing(dev, name, y, cfg, tu_split: bool, card: str,
                  rd_modes=None) -> float:
    """Warm device time of the split-RDO IDR's pass A (open-loop decisions)
    on a padded luma plane, in the configuration's rd_mode or in each of
    `rd_modes`; returns the last one's milliseconds."""
    import torch

    from homerhevc_tpu_torch import tables
    from homerhevc_tpu_torch.pipeline import intra_torch

    qp_t = torch.tensor(cfg.qp, dtype=torch.int32, device=dev)
    lam = torch.as_tensor(tables.LAMBDA_FX, device=dev)[qp_t]
    parts = []
    for rd in rd_modes or (int(cfg.rd_mode),):
        ms_a = synced_ms(lambda: intra_torch._open_loop_maps(
            y, B=min(cfg.cu_size, 32), qp=qp_t, lam_fx=lam,
            strong_smoothing=True, rd_mode=rd, tu_split=tu_split), 2)
        parts.append(f"rd_mode {rd} {ms_a:.1f} ms")
    log(f"  {name}: IDR pass A (open-loop decisions, warm, timed alone): "
        f"{', '.join(parts)} on {card}")
    return ms_a


GRAPH_CONFIG = os.path.join(ROOT, "hevc_bench", "configs",
                            "ldp_1080p_fastest.json")


def graph_config():
    """The benchmark's 1080p configuration (its `encoder` keywords, enums by
    value) with the batch traffic's two chunks in flight."""
    from homerhevc_tpu_torch.config import EncoderConfig
    with open(GRAPH_CONFIG) as f:
        kw = dict(json.load(f)["encoder"], frame_pipeline_depth=2)
    defaults = EncoderConfig()
    for k, v in kw.items():
        cur = getattr(defaults, k)
        if isinstance(cur, enum.Enum):
            kw[k] = type(cur)(v)
    return EncoderConfig(**kw)


def trace_device(fn) -> dict:
    """torch.profiler (CPU and CUDA) over fn(): the kernels that ran on the
    card (copies and sets left out) by name, the port's gather kernels
    among them (by the names hevc_bench's reader matches) and the device's
    busy milliseconds (the union of its kernels, copies and sets)."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans, names = [], collections.Counter()
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type().name != "CUDA":
            continue
        spans.append((ev.start_ns(), ev.start_ns() + ev.duration_ns()))
        if not ev.name().startswith(("Memcpy", "Memset")):
            names[ev.name()] += 1
    gathers = sum(n for name, n in names.items()
                  if ("gather_kernel<" in name or "gather_span_kernel" in name
                      or "gather_generic_kernel" in name)
                  and "at::native" not in name)
    busy, end = 0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return dict(names=names, kernels=sum(names.values()), gathers=gathers,
                busy_ms=busy * 1e-6)


def phase_graphs(dev, card: str) -> None:
    """The fixed-CU P step's CUDA graphs at the benchmark's configuration:
    24 P frames through each path, graphed against the step called
    directly, then 8 more of each under the profiler; see the module
    docstring, phase 4."""
    import torch

    from homerhevc_tpu_torch.api import HomerEncoder
    from homerhevc_tpu_torch.ops.gather import GATHER_WIN
    from homerhevc_tpu_torch.pipeline.p_graph import P_GRAPH
    from homerhevc_tpu_torch.utils.synth import synth_clip

    cfg = graph_config()
    frames = list(synth_clip(cfg.width, cfg.height, 33, seed=0))
    enc = HomerEncoder(cfg, device=dev)
    idr = enc.encode_frame(*frames[0])
    ref0 = tuple(p.cpu().numpy() for p in enc._ref)
    enc.close()
    n_gather = 3                 # luma G 73, the chroma pair G 35, refine
    paths = ("chunk", "frame")
    how = {True: "graphed", False: "step called directly"}

    def session(graphed: bool):
        enc = HomerEncoder(cfg, device=dev, fetch_recon=False)
        if enc._graphs is None:
            raise AssertionError("a CUDA session with no mesh has no graphs")
        if not graphed:
            enc._graphs = None       # the step called directly
        enc.seed_reference(ref0, poc=1, last_idr=0)
        return enc

    def code(enc, path, lo, hi):
        if path == "chunk":
            return enc.encode_frames(frames[lo:hi], chunk=8)
        return [enc.encode_frame(*f) for f in frames[lo:hi]]

    ms = {}
    for path in paths:
        runs = {}
        for graphed in (True, False):
            enc = session(graphed)
            counts = dict(vars(P_GRAPH))
            g0 = GATHER_WIN.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            aus = code(enc, path, 1, 9)          # warm-up, capture
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            aus += code(enc, path, 9, 25)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            moved = {k: v - counts[k] for k, v in vars(P_GRAPH).items()}
            gathers = GATHER_WIN.launches - g0
            want = (dict(captures=1, replays=23, eager=1) if graphed
                    else dict(captures=0, replays=0, eager=0))
            if moved != want or gathers != n_gather * 24:
                raise AssertionError(f"graphs, {path}, {how[graphed]}: "
                                     f"P_GRAPH moved {moved}, expected "
                                     f"{want}; gather_win {gathers} "
                                     f"launches, expected {n_gather * 24}")
            runs[graphed] = (aus, tuple(p.cpu() for p in enc._ref))
            ms[path, graphed] = (t2 - t1) * 1e3 / 16
            log(f"  graphs, {path} path, {how[graphed]}: frames 1-8 "
                f"(warm-up{' and capture' if graphed else ''}) "
                f"{(t1 - t0) * 1e3:.1f} ms, frames 9-24 "
                f"{ms[path, graphed]:.2f} ms per P frame; P_GRAPH moved "
                f"{moved} on {card}")
            enc.close()
        if runs[True][0] != runs[False][0]:
            bad = [i for i, (a, b) in enumerate(zip(*(runs[g][0]
                                                      for g in (True, False))))
                   if a != b]
            raise AssertionError(f"graphs, {path}: graphed AUs differ from "
                                 f"the direct step's at P frames {bad}")
        if not all(torch.equal(a, b) for a, b in zip(runs[True][1],
                                                     runs[False][1])):
            raise AssertionError(f"graphs, {path}: reference planes differ")
        log(f"  graphs, {path} path: 24 P AUs byte-identical to the direct "
            f"step's ({sum(len(a) for a in runs[True][0])} bytes; IDR "
            f"{len(idr)} bytes), reference planes equal; ms per P frame "
            f"{ms[path, True]:.2f} graphed, {ms[path, False]:.2f} direct")

    # the profiler last: once it has run, its hooks slow the host for the
    # rest of the process
    for path in paths:
        names = {}
        for graphed in (True, False):
            enc = session(graphed)
            code(enc, path, 1, 9)                # warm-up, capture
            g0 = GATHER_WIN.launches
            tr = trace_device(lambda: code(enc, path, 9, 17))
            if tr["gathers"] != GATHER_WIN.launches - g0:
                raise AssertionError(
                    f"graphs, {path}, {how[graphed]}: the profiler saw "
                    f"{tr['gathers']} gather kernels, GATHER_WIN counted "
                    f"{GATHER_WIN.launches - g0}")
            names[graphed] = tr["names"]
            log(f"  graphs, {path} path, {how[graphed]}, traced 8 frames: "
                f"{tr['kernels'] / 8:.2f} kernels and "
                f"{tr['busy_ms'] / 8:.3f} busy device ms per frame, "
                f"{tr['gathers']} gather kernels == GATHER_WIN's count")
            enc.close()
        diff = {name[:100]: (names[True][name] - names[False][name]) / 8
                for name in names[True] | names[False]
                if names[True][name] != names[False][name]}
        log(f"  graphs, {path} path: kernels per frame, graphed less "
            f"direct, by name: {diff}")

    # what feeding the reference by copy costs the device per frame (the
    # graph reads the planes from its own buffers)
    planes = tuple(torch.as_tensor(p, device=dev) for p in ref0)
    dst = tuple(torch.empty_like(p) for p in planes)
    ms = cuda_ms(lambda: [d.copy_(p) for d, p in zip(dst, planes)], 50)
    log(f"  graphs: the three reference planes' copy into the graph's "
        f"inputs {ms * 1e3:.2f} us on {card}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    if sys.argv[1:2] == ["--gop-worker"]:
        return gop_worker(sys.argv[2:])
    with open(FIXTURE) as f:
        fixture = json.load(f)
    from homerhevc_tpu_torch.device import require_cuda
    from homerhevc_tpu_torch.entropy import native_backend
    from homerhevc_tpu_torch.kernels import build
    from homerhevc_tpu_torch.ops.gather import GATHER_WIN
    from homerhevc_tpu_torch.ops.me import ME_SAD
    from homerhevc_tpu_torch.utils.fixtures import clip, run_config

    dev = require_cuda()
    card = card_line()
    log(f"[1/6] device: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}, max SM clock "
        f"{max_sm_hz() / 1e6:.0f} MHz")

    t0 = time.perf_counter()
    libs = build.build_all([k.name for k in (ME_SAD, GATHER_WIN)])
    for k in (ME_SAD, GATHER_WIN):
        k.load()
    t1 = time.perf_counter()
    henc = native_backend.build_library()
    log(f"[2/6] build: kernels {t1 - t0:.2f} s (nvcc -gencode "
        f"arch=compute_90a,code=sm_90a, ctypes binding), libhenc "
        f"{time.perf_counter() - t1:.2f} s (g++, {os.path.basename(henc)})")
    for lib in libs:
        for line in build.ptxas_log(lib).read_text().splitlines():
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line:
                log("  " + line.replace("ptxas info    : ", ""))

    frames = clip("720p")
    log("[3/6] kernels vs plain (exact equality):")
    records = phase_kernels(dev, frames, clip("small"), clip("default_small"),
                            clip(CLI_PATH)[:2], clip("fastest16_small"))
    phase_band_sites(dev, records)

    log("[4/6] main paths at 1280x720:")
    by_path = {}
    for name in PATHS:
        by_path[name] = run_path(dev, name, fixture,
                                 {p: r[1] for p, r in by_path.items()})
    for name in IBP_PATHS:
        by_path[name] = run_ibp_path(dev, name, fixture)
    log("[4/6] BASELINE.md configuration 4 at 1920x1080 through the port's "
        "CLI:")
    workdir = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    by_path[CLI_PATH] = run_cli_path(dev, fixture, workdir)
    log("[4/6] CUDA graphs of the fixed-CU P step at 1920x1080:")
    phase_graphs(dev, card)
    log("[5/6] multi-device on the one card (meshes that name it several "
        "times; two processes sharing it):")
    phase_mesh(dev, fixture, by_path, card)
    for kernel, rec in records.items():
        rec["launches_by_path"] = {p: c[0][kernel]
                                   for p, c in by_path.items()}
        rec["launches"] = sum(rec["launches_by_path"].values())
        if not rec["launches"]:
            raise AssertionError(f"{kernel} was launched on no main path")

    log("[6/6] timing:")
    for name, n_p in (("fastest_720p", 16), ("fast_720p", 8),
                      ("default_720p", 8), ("fastest16_720p", 16),
                      ("faster16_720p", 8)):
        phase_timing(dev, name, n_p, by_path[name][1], card)
    run = PATHS["allintra_rdfast64_720p"]["run"]
    y = torch.as_tensor(pad_plane(clip(run)[0][0], 768, 1280), device=dev)
    pass_a_timing(dev, "allintra_rdfast64_720p", y, run_config(run), True,
                  card, rd_modes=(2, 1, 0))
    for name in IBP_PATHS:
        ibp_timing(dev, name, by_path[name][1], card)
    cli_timing(dev, fixture, workdir, by_path[CLI_PATH][1], card)
    shutil.rmtree(workdir)

    print(json.dumps({"kernels": list(records.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
