#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (homerhevc_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (non-zero exit, no result line):
  1. device  — require CUDA; print the card's name and power limit
  2. build   — build the hand-written CUDA kernels from kernels/*.cu
  3. kernels — each kernel against its plain PyTorch version at the main
               path's call-site shapes (random and real 720p data), exact
               equality; kernel and plain times from CUDA events
  4. slice   — HomerEncoder.encode_frames on synth_clip(1280, 720, 17):
               one IDR then two chunks of 8 P frames at pipeline depth 2;
               every AU's SHA-256 must equal tests/fixtures/
               torch_port_aus.json (written from the JAX package); every
               kernel must have been launched by this run; the same run with
               kernels=False must give identical AUs; libde265 decode check
               where the library loads; the 128x96 fixture clip too
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


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call of fn, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def phase_kernels(dev, frames):
    """Kernel vs plain at the 720p call sites; returns per-kernel records."""
    import numpy as np
    import torch

    from homerhevc_tpu_torch.device import edge_pad
    from homerhevc_tpu_torch.ops import gather, me
    from homerhevc_tpu_torch.pipeline import p_torch
    from homerhevc_tpu_torch.tables import LAMBDA_ME_FX_P

    PAD = p_torch.PAD

    H, W, B, S = 736, 1280, 32, 16
    n = 2 * S + 1
    nby, nbx = H // B, W // B
    rng = np.random.default_rng(1)
    lam = int(LAMBDA_ME_FX_P[32])
    mvcost = torch.as_tensor((lam * p_torch._mv_bits_grid(S)) >> 8,
                             device=dev)

    def pad_plane(p, h, w):
        return np.pad(p, ((0, h - p.shape[0]), (0, w - p.shape[1])),
                      mode="edge")

    # real data: frame 1 against frame 0, padded as the session pads them
    y0 = torch.as_tensor(pad_plane(frames[0][0], H, W), device=dev)
    y1 = torch.as_tensor(pad_plane(frames[1][0], H, W), device=dev)
    u0 = torch.as_tensor(pad_plane(frames[0][1], H // 2, W // 2), device=dev)
    me_cases = {
        "real": (y1.to(torch.int16), edge_pad(y0.to(torch.int16), PAD),
                 mvcost),
        "random": (torch.as_tensor(rng.integers(0, 256, (H, W)),
                                   dtype=torch.int16, device=dev),
                   torch.as_tensor(rng.integers(0, 256, (H + 2 * PAD,
                                                         W + 2 * PAD)),
                                   dtype=torch.int16, device=dev), mvcost),
        "ties": (torch.full((H, W), 9, dtype=torch.int16, device=dev),
                 torch.full((H + 2 * PAD, W + 2 * PAD), 9,
                            dtype=torch.int16, device=dev),
                 torch.zeros_like(mvcost)),
    }
    err_me = 0
    for name, (cur, ref, mc) in me_cases.items():
        ck, ik = me.integer_me_cuda(cur, ref, mc, B=B, search=S, pad=PAD)
        cp, ip = me.integer_me_plain(cur, ref, mc, B=B, search=S, pad=PAD)
        if not (torch.equal(ck, cp) and torch.equal(ik, ip)):
            raise AssertionError(f"me_sad != plain on {name} data")
        err_me = max(err_me, int((ck - cp).abs().max()),
                     int((ik - ip).abs().max()))
        log(f"  me_sad == plain on {name} data (736x1280, B=32, S=16)")
    cur, ref, mc = me_cases["real"]
    me_ms = cuda_ms(lambda: me.integer_me_cuda(cur, ref, mc, B=B, search=S,
                                               pad=PAD), 20)
    me_plain_ms = cuda_ms(lambda: me.integer_me_plain(cur, ref, mc, B=B,
                                                      search=S, pad=PAD), 3)
    log(f"  me_sad: kernel {me_ms:.4f} ms, plain {me_plain_ms:.4f} ms")

    # window gathers at the call sites of the P stage: luma G=41 on the
    # padded (880, 1424) plane, chroma G=19 on (440, 712), nb = 920
    _, best = me.integer_me_plain(cur, ref, mc, B=B, search=S, pad=PAD)
    r = torch.arange(nby * nbx, device=dev) // nbx
    c = torch.arange(nby * nbx, device=dev) % nbx
    vy = (best.reshape(-1) // n - S).to(torch.int64)
    vx = (best.reshape(-1) % n - S).to(torch.int64)
    sites = {
        "luma G=41": (ref, r * B + vy - 4 + PAD, c * B + vx - 4 + PAD, B + 9),
        "chroma G=19": (edge_pad(u0.to(torch.int16), PAD // 2),
                        r * 16 + ((4 * vy) >> 3) + PAD // 2 - 1,
                        c * 16 + ((4 * vx) >> 3) + PAD // 2 - 1, 19),
    }
    err_g = 0
    times = {}
    for name, (plane, by, bx, G) in sites.items():
        Hp, Wp = plane.shape
        rand_plane = torch.as_tensor(rng.integers(-300, 300, (Hp, Wp)),
                                     dtype=torch.int16, device=dev)
        rand_by = by + torch.as_tensor(rng.integers(-8, 9, by.shape),
                                       device=dev)
        rand_by[:3] = torch.tensor([-5, 10 ** 5, Hp - G], device=dev)
        for label, (p, yy, xx) in (("real", (plane, by, bx)),
                                   ("random", (rand_plane, rand_by, bx))):
            yy = yy.to(torch.int32)
            xx = xx.to(torch.int32)
            a = gather.gather_windows_cuda(p, yy, xx, G)
            b = gather.gather_windows_plain(p, yy, xx, G)
            if not torch.equal(a, b):
                raise AssertionError(f"gather_win != plain at {name} "
                                     f"({label})")
            err_g = max(err_g, int((a.to(torch.int32)
                                    - b.to(torch.int32)).abs().max()))
            log(f"  gather_win == plain at {name} on {label} data "
                f"(plane {Hp}x{Wp}, nb={by.shape[0]})")
        yy, xx = by.to(torch.int32), bx.to(torch.int32)
        times[name] = (
            cuda_ms(lambda: gather.gather_windows_cuda(plane, yy, xx, G), 50),
            cuda_ms(lambda: gather.gather_windows_plain(plane, yy, xx, G),
                    50))
        log(f"  gather_win {name}: kernel {times[name][0]:.4f} ms, plain "
            f"{times[name][1]:.4f} ms")
    g_ms, g_plain = times["luma G=41"]
    return {
        "me_sad": dict(name="me_sad", route="cuda", source=me.ME_SAD.source,
                       replaces="homerhevc_tpu/ops/me_pallas.py:27",
                       max_abs_err=err_me, ms=me_ms, plain_ms=me_plain_ms),
        "gather_win": dict(name="gather_win", route="cuda",
                           source=gather.GATHER_WIN.source,
                           replaces="homerhevc_tpu/ops/gather_pallas.py:30",
                           max_abs_err=err_g, ms=g_ms, plain_ms=g_plain),
    }


def phase_slice(dev, frames, fixture):
    """The port's main path at 720p; returns the launch counts."""
    import torch

    import make_torch_fixtures as fx
    from homerhevc_tpu_torch.api import HomerEncoder
    from homerhevc_tpu_torch.ops.gather import GATHER_WIN
    from homerhevc_tpu_torch.ops.me import ME_SAD

    want = fixture["720p"]["aus"]
    cfg = fx.slice_config(1280, 720)
    kernels = (ME_SAD, GATHER_WIN)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    enc = HomerEncoder(cfg, device=dev)
    aus = enc.encode_frames(frames, chunk=8)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    log(f"  720p x{len(frames)} through the kernels: {secs:.2f} s "
        f"(first run, includes warm-up); launches {launches}")
    for name, cnt in launches.items():
        if cnt == 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 "main path")
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
    enc = HomerEncoder(fx.slice_config(small["width"], small["height"]),
                       device=dev)
    s_aus = enc.encode_frames(fx.clip("small"), chunk=small["chunk"])
    enc.close()
    if fx.au_digest(s_aus) != small["aus"]:
        raise AssertionError("128x96 AUs differ from the JAX fixture")
    log(f"  128x96 AUs == JAX fixture ({len(s_aus)} AUs)")
    return launches


def phase_timing(dev, frames, card: str):
    import numpy as np
    import torch

    from homerhevc_tpu_torch.api import HomerEncoder
    from homerhevc_tpu_torch.pipeline import intra_torch, p_chunk
    from make_torch_fixtures import slice_config

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
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]
    with open(FIXTURE) as f:
        fixture = json.load(f)
    from homerhevc_tpu_torch.device import require_cuda
    from make_torch_fixtures import clip
    from homerhevc_tpu_torch.ops.gather import GATHER_WIN
    from homerhevc_tpu_torch.ops.me import ME_SAD

    dev = require_cuda()
    card = card_line()
    log(f"[1/5] device: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    for k in (ME_SAD, GATHER_WIN):
        k.load()
    log(f"[2/5] build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc -gencode arch=compute_90a,code=sm_90a, ctypes binding)")

    frames = clip("720p")
    log("[3/5] kernels vs plain (exact equality):")
    records = phase_kernels(dev, frames)

    log("[4/5] slice at 1280x720:")
    launches = phase_slice(dev, frames, fixture)
    for name, cnt in launches.items():
        records[name]["launches"] = cnt

    log("[5/5] timing:")
    phase_timing(dev, frames, card)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms")
    print(json.dumps({"kernels": [{k: rec[k] for k in keys}
                                  for rec in records.values()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
