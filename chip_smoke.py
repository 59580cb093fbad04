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
               uint8 and int16 planes, at 736x1280 (B 32, S 16), at the
               128x96 fixture's shapes and at search 8; gather_win on real
               and random data with planted out-of-range starts, one plane
               (G 41) and the chroma pair in one launch (G 19), at both
               sizes. Then times from CUDA events at the 720p call sites:
               kernel, plain version, an empty kernel of the same grid
               (floor_ms), one PyTorch indexing call for the same gather
               (library_ms), and the bound computed from the shapes
  4. slice   — HomerEncoder(cfg).encode_frames on synth_clip(1280, 720, 17):
               one IDR then two chunks of 8 P frames at pipeline depth 2;
               every AU's SHA-256 must equal tests/fixtures/
               torch_port_aus.json (written from the JAX package); the run
               must have launched me_sad 16 times and gather_win 32 times;
               the same run with kernels=False must give identical AUs;
               libde265 decode check where the library loads; the 128x96
               fixture clip too
  5. timing  — after warm-up, one window of 16 P frames end to end

The last three lines are the per-kernel JSON record, the card's name and
power limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
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


def check_gather(dev, frames, best, H, W, B, S, label):
    """gather_win == plain at both call sites of one size, on real starts
    and on random data with planted out-of-range starts; returns the
    sites and the largest absolute difference seen (0, or the check
    raises)."""
    import numpy as np
    import torch

    from homerhevc_tpu_torch.ops import gather

    rng = np.random.default_rng(2)
    sites = gather_sites(dev, frames[0], best, H, W, B, S)
    worst = 0
    for name, (plane, by, bx, G) in sites.items():
        first = plane[0] if isinstance(plane, tuple) else plane
        Hp, Wp = first.shape

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
        for kind, (p, yy, xx) in (("real", (plane, by, bx)),
                                  ("random", (rand_plane, rand_by,
                                              rand_bx))):
            a = gather.gather_windows_cuda(p, yy, xx, G)
            b = gather.gather_windows_plain(p, yy, xx, G)
            torch.cuda.synchronize()
            if a.shape != b.shape:
                raise AssertionError(f"gather_win shape != plain at {name} "
                                     f"({kind}, {label})")
            err = int((a.to(torch.int32) - b.to(torch.int32)).abs().max())
            if err:
                raise AssertionError(f"gather_win != plain at {name} "
                                     f"({kind}, {label}): max abs "
                                     f"difference {err}")
            worst = max(worst, err)
            log(f"  gather_win == plain at {name} on {kind} data ({label}, "
                f"plane {Hp}x{Wp}, nb={by.shape[0]})")
    return sites, worst


def phase_kernels(dev, frames, small_frames):
    """Kernel vs plain at the 720p call sites, the 128x96 fixture's shapes
    and search 8; times and bounds at 720p. Returns per-kernel records."""
    import torch

    from homerhevc_tpu_torch.ops import gather, me
    from homerhevc_tpu_torch.pipeline.p_torch import PAD

    H, W, B, S = 736, 1280, 32, 16
    # max_abs_err of a kernel: the largest difference over all its checks
    cases, me_err = check_me(dev, frames, H, W, B, S, "736x1280, B=32, S=16")
    small, err = check_me(dev, small_frames, 96, 128, B, S,
                          "96x128, B=32, S=16")
    me_err = max(me_err, err)
    # search 8, and other block sizes: the compile-time B=16 path and the
    # any-B kernel
    for fr, h, w, b, s in ((frames, H, W, B, 8), (small_frames, 96, 128, B, 8),
                           (small_frames, 96, 128, 16, 8),
                           (small_frames, 96, 120, 24, 7)):
        me_err = max(me_err, check_me(dev, fr, h, w, b, s,
                                      f"{h}x{w}, B={b}, S={s}")[1])

    cur, ref, mc = cases["real uint8"]
    nblocks = (H // B) * (W // B)
    n = 2 * S + 1
    me_ms = cuda_ms(lambda: me.integer_me_cuda(cur, ref, mc, B=B, search=S,
                                               pad=PAD), 50)
    me_plain_ms = cuda_ms(lambda: me.integer_me_plain(cur, ref, mc, B=B,
                                                      search=S, pad=PAD), 3)
    def stream():        # the current stream: a graph capture's own, inside
        return torch.cuda.current_stream(dev).cuda_stream

    me_floor_ms = cuda_ms(lambda: me.ME_SAD.launch_floor(H, W, B, S,
                                                         stream()), 50)
    diffs = nblocks * n * n * B * B
    rate = DIFFS_PER_INSTRUCTION * INT_LANES_PER_SM * SMS * max_sm_hz()
    me_bytes = (cur.numel() * cur.element_size()
                + ref.numel() * ref.element_size()
                + mc.numel() * 4 + 2 * nblocks * 4)
    me_ops_ms = diffs / rate * 1e3
    me_bytes_ms = me_bytes / HBM_BYTES_PER_S * 1e3
    log(f"  me_sad: kernel {me_ms:.4f} ms, plain {me_plain_ms:.4f} ms, "
        f"empty grid {me_floor_ms:.4f} ms; bound {me_ops_ms:.4f} ms by "
        f"operations ({diffs:.3e} differences, {DIFFS_PER_INSTRUCTION} per "
        f"instruction), {me_bytes_ms:.4f} ms by bytes ({me_bytes} B)")
    records = {"me_sad": dict(
        name="me_sad", route="cuda", source=me.ME_SAD.source,
        replaces="homerhevc_tpu/ops/me_pallas.py:27", max_abs_err=me_err,
        ms=me_ms, plain_ms=me_plain_ms,
        bound_ms=max(me_ops_ms, me_bytes_ms),
        bound_by="operations" if me_ops_ms >= me_bytes_ms else "bytes",
        floor_ms=me_floor_ms, library_ms=None)}

    _, best = me.integer_me_plain(cur, ref, mc, B=B, search=S, pad=PAD)
    sites, gw_err = check_gather(dev, frames, best, H, W, B, S, "736x1280")
    cur_s, ref_s, mc_s = small["real uint8"]
    _, best_s = me.integer_me_plain(cur_s, ref_s, mc_s, B=B, search=S,
                                    pad=PAD)
    gw_err = max(gw_err, check_gather(dev, small_frames, best_s, 96, 128, B,
                                      S, "96x128")[1])

    times = {}
    for name, (plane, by, bx, G) in sites.items():
        nplanes = len(plane) if isinstance(plane, tuple) else 1
        nb = by.shape[0]
        y0, x0 = clamped_starts(plane, by, bx, G)
        lib = torch.stack(library_gather(plane, y0, x0, G))
        if not torch.equal(lib.reshape(-1), gather.gather_windows_plain(
                plane, by, bx, G).reshape(-1)):
            raise AssertionError(f"library gather != plain at {name}")
        t = dict(
            ms=cuda_ms(lambda: gather.gather_windows_cuda(plane, by, bx, G),
                       100),
            plain_ms=cuda_ms(lambda: gather.gather_windows_plain(
                plane, by, bx, G), 50),
            floor_ms=cuda_ms(lambda: gather.GATHER_WIN.launch_floor(
                nb, nplanes, stream()), 100),
            library_ms=cuda_ms(lambda: library_gather(plane, y0, x0, G), 50),
            # every window read once and written once, and the starts
            bound_ms=(2 * nplanes * nb * G * G * 2 + 2 * nb * 4)
            / HBM_BYTES_PER_S * 1e3)
        times[name] = t
        log(f"  gather_win {name}: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, empty grid {t['floor_ms']:.4f} ms, "
            f"one indexing call per plane {t['library_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms by bytes")
    luma, chroma = times["luma G=41"], times["chroma pair G=19"]
    records["gather_win"] = dict(
        name="gather_win", route="cuda", source=gather.GATHER_WIN.source,
        replaces="homerhevc_tpu/ops/gather_pallas.py:30", max_abs_err=gw_err,
        bound_by="bytes", **luma,
        **{f"chroma_pair_{k}": v for k, v in chroma.items()})
    return records


def phase_slice(dev, frames, fixture):
    """The port's main path at 720p; returns the launch counts."""
    import torch

    from homerhevc_tpu_torch.api import HomerEncoder
    from homerhevc_tpu_torch.ops.gather import GATHER_WIN
    from homerhevc_tpu_torch.ops.me import ME_SAD
    from homerhevc_tpu_torch.utils import fixtures as fx

    want = fixture["720p"]["aus"]
    cfg = fx.slice_config(1280, 720)
    kernels = (ME_SAD, GATHER_WIN)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    enc = HomerEncoder(cfg)                  # no device given: the card
    if enc.device.type != "cuda":
        raise AssertionError(f"default device is {enc.device}, not the card")
    aus = enc.encode_frames(frames, chunk=8)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    log(f"  720p x{len(frames)} through the kernels: {secs:.2f} s "
        f"(first run, includes warm-up); launches {launches}")
    # 16 P frames: one SAD sweep each, one luma gather and one gather of
    # the chroma pair each
    n_p = len(frames) - 1
    if launches != {"me_sad": n_p, "gather_win": 2 * n_p}:
        raise AssertionError(f"launches {launches}, expected me_sad {n_p} "
                             f"and gather_win {2 * n_p}")
    got = fx.au_digest(aus)
    bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    if len(got) != len(want) or bad:
        raise AssertionError(f"720p AUs differ from the JAX fixture at "
                             f"{bad} (sizes {[g['len'] for g in got]})")
    log(f"  720p AUs == JAX fixture ({len(got)} AUs, "
        f"{sum(g['len'] for g in got)} bytes; IDR {got[0]['len']} bytes)")

    decoded = fx.decode_check(aus, enc._ref[0].cpu().numpy()[:720, :1280])
    if decoded is None:
        log("  libde265 decode check: not run (libde265 does not load)")
    elif not decoded:
        raise AssertionError("libde265 decode != the port's recon")
    else:
        log("  libde265 decode check: ran, last frame == port recon")
    enc.close()

    before = {k.name: k.launches for k in kernels}
    plain = HomerEncoder(cfg, device=dev, kernels=False)
    aus_plain = plain.encode_frames(frames, chunk=8)
    plain.close()
    if aus_plain != aus:
        raise AssertionError("kernels=False AUs differ from kernel AUs")
    if {k.name: k.launches for k in kernels} != before:
        raise AssertionError("kernels=False run launched a kernel")
    log("  kernels=False run: AUs identical")

    small = fixture["small"]
    for use_kernels in (True, False):
        enc = HomerEncoder(fx.slice_config(small["width"], small["height"]),
                           device=dev, kernels=use_kernels)
        s_aus = enc.encode_frames(fx.clip("small"), chunk=small["chunk"])
        enc.close()
        if fx.au_digest(s_aus) != small["aus"]:
            raise AssertionError("128x96 AUs differ from the JAX fixture "
                                 f"(kernels={use_kernels})")
    log(f"  128x96 AUs == JAX fixture ({len(s_aus)} AUs), with and without "
        "kernels")
    return launches


def phase_timing(dev, frames, card: str):
    import numpy as np
    import torch

    from homerhevc_tpu_torch.api import HomerEncoder
    from homerhevc_tpu_torch.pipeline import intra_torch, p_chunk
    from homerhevc_tpu_torch.utils.fixtures import slice_config

    cfg = slice_config(1280, 720)
    enc = HomerEncoder(cfg, device=dev)
    enc.encode_frames(frames[:1])                   # IDR
    enc.encode_frames(frames[1:9], chunk=8)         # warm-up chunk
    enc2 = HomerEncoder(cfg, device=dev)
    enc2.encode_frames(frames[:1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    aus = enc2.encode_frames(frames[1:17], chunk=8)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    fps = 16 / secs
    log(f"  16 P frames end to end: {secs * 1000:.1f} ms -> {fps:.2f} fps "
        f"({sum(len(a) for a in aus)} bytes) on {card}")

    # device-only view of the same work: one chunk of 8 P frames, and the IDR
    padded = [enc2._pad_frame(*f) for f in frames[1:9]]
    ys, us, vs = (torch.as_tensor(np.stack([p[k] for p in padded]),
                                  device=dev) for k in range(3))
    qps = torch.full((8,), 32, dtype=torch.int32, device=dev)
    ref = enc._ref

    def chunk():
        p_chunk.p_chunk_device(ys, us, vs, *ref, qps, ctu=32, search=16,
                               me_precision=2, sign_hiding=True,
                               deblock=True, sao=True, cap=enc._chunk_cap)

    wall = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        chunk()
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t)
    log(f"  P chunk of 8 (device, sync'd): {min(wall) * 1000:.1f} ms "
        f"-> {8 / min(wall):.2f} fps")
    yp = tuple(torch.as_tensor(p, device=dev)
               for p in enc2._pad_frame(*frames[0]))
    torch.cuda.synchronize()
    t = time.perf_counter()
    intra_torch.encode_frame_intra(*yp, B=32, qp=32, sign_hiding=True)
    torch.cuda.synchronize()
    log(f"  IDR device stage: {(time.perf_counter() - t) * 1000:.1f} ms")
    enc.close()
    enc2.close()
    return fps


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    with open(FIXTURE) as f:
        fixture = json.load(f)
    from homerhevc_tpu_torch.device import require_cuda
    from homerhevc_tpu_torch.entropy import native_backend
    from homerhevc_tpu_torch.kernels import build
    from homerhevc_tpu_torch.ops.gather import GATHER_WIN
    from homerhevc_tpu_torch.ops.me import ME_SAD
    from homerhevc_tpu_torch.utils.fixtures import clip

    dev = require_cuda()
    card = card_line()
    log(f"[1/5] device: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}, max SM clock "
        f"{max_sm_hz() / 1e6:.0f} MHz")

    t0 = time.perf_counter()
    libs = build.build_all([k.name for k in (ME_SAD, GATHER_WIN)])
    for k in (ME_SAD, GATHER_WIN):
        k.load()
    t1 = time.perf_counter()
    henc = native_backend.build_library()
    log(f"[2/5] build: kernels {t1 - t0:.2f} s (nvcc -gencode "
        f"arch=compute_90a,code=sm_90a, ctypes binding), libhenc "
        f"{time.perf_counter() - t1:.2f} s (g++, {os.path.basename(henc)})")
    for lib in libs:
        for line in build.ptxas_log(lib).read_text().splitlines():
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line:
                log("  " + line.replace("ptxas info    : ", ""))

    frames = clip("720p")
    log("[3/5] kernels vs plain (exact equality):")
    records = phase_kernels(dev, frames, clip("small"))

    log("[4/5] slice at 1280x720:")
    launches = phase_slice(dev, frames, fixture)
    for name, cnt in launches.items():
        records[name]["launches"] = cnt

    log("[5/5] timing:")
    phase_timing(dev, frames, card)

    print(json.dumps({"kernels": list(records.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
