"""Console app of the PyTorch/CUDA port: reads a YUV420 8-bit file, drives
HomerEncoder, writes an Annex-B .265 file (and optionally the reconstructed
YUV), prints per-frame stats and the final fps.

    python3 homer_app_torch.py -i in.yuv -o out.265 -widthxheight 1920x1080 \\
        -performance_mode 3 -bitrate_mode 1 -bitrate 1250 -metrics -profiling

The port's counterpart of the JAX package's homer_app.py: the same flags,
defaults and mapping to EncoderConfig, the same printed lines and the same
output bytes. With -gop_size >= 2 the frames stream through push_frame /
flush (IBP; -o-raw is not written there, as in homer_app.py); otherwise
they are coded one by one through encode_frame. There is no -backend and
no batch IBP; -device names the torch device, by default the GPU (the
encoder raises without one). A setting the port does not support exits
non-zero with the NotImplementedError's message before any file is written.
"""

from __future__ import annotations

import argparse
import sys
import time

from .api import HomerEncoder
from .config import (BitrateMode, EncoderConfig, MEPrecision,
                     PerformanceMode, RDMode)
from .utils.profiler import Profiler
from .utils.psnr import psnr
from .utils.yuv import frame_size_bytes, read_yuv_frame, write_yuv_frame


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="homer_app_torch", description=__doc__,
                                 formatter_class=(
                                     argparse.RawDescriptionHelpFormatter))
    ap.add_argument("-i", dest="input", required=True, help="input YUV420 file")
    ap.add_argument("-o", dest="output", help="output .265 file")
    ap.add_argument("-o-raw", dest="output_raw", help="write reconstructed YUV")
    ap.add_argument("-widthxheight", dest="size", default="1280x720")
    ap.add_argument("-frame_rate", type=float, default=25.0)
    ap.add_argument("-cu_size", type=int, default=32, choices=(16, 32, 64))
    ap.add_argument("-intra_period", type=int, default=100)
    ap.add_argument("-gop_size", type=int, default=1,
                    help="0: all intra, 1: IPPP, 2: IBP (one B between anchors)")
    ap.add_argument("-qp", type=int, default=32)
    ap.add_argument("-motion_estimation_precision", type=int, default=2,
                    choices=(0, 1, 2))
    ap.add_argument("-chroma_qp_offset", type=int, default=0)
    ap.add_argument("-sign_hiding", type=int, default=0)
    ap.add_argument("-sao", type=int, default=0)
    ap.add_argument("-deblocking", type=int, default=1)
    ap.add_argument("-bitrate_mode", type=int, default=0,
                    help="0=FIXED_QP 1=CBR 2=VBR")
    ap.add_argument("-bitrate", type=int, default=1250, help="kbps")
    ap.add_argument("-vbv_size", type=float, default=1.0,
                    help="in units of bitrate (seconds)")
    ap.add_argument("-vbv_init", type=float, default=0.35,
                    help="in units of vbv_size")
    ap.add_argument("-n_wpp_threads", type=int, default=0,
                    help="0: no WPP; >0: per-CTU-row entropy substreams")
    ap.add_argument("-search_range", type=int, default=16)
    ap.add_argument("-rd", "-rd_mode", dest="rd_mode", type=int, default=1,
                    help="0=DIST_ONLY 1=FULL 2=FAST (HOMER_RD_MODES)")
    ap.add_argument("-performance_mode", type=int, default=1,
                    help="0=FULL (8x8 inter CUs) 1=FAST 2=FASTER 3=FASTEST")
    ap.add_argument("-max_intra_tr_depth", type=int, default=1)
    ap.add_argument("-max_inter_tr_depth", type=int, default=1)
    ap.add_argument("-n_frames", type=int, default=1000)
    ap.add_argument("-skipped_frames", type=int, default=0)
    ap.add_argument("-device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "plain versions of the kernels on the CPU)")
    ap.add_argument("-metrics", action="store_true",
                    help="print per-frame PSNR (role of COMPUTE_METRICS)")
    ap.add_argument("-profiling", action="store_true",
                    help="print stage timing breakdown (role of _TIME_PROFILING_)")
    return ap.parse_args(argv)


def read_yuv_frames(path, w, h, n, skip=0):
    """Up to n (y, u, v) frames of a planar YUV420 file, after `skip`."""
    with open(path, "rb") as f:
        f.seek(skip * frame_size_bytes(w, h))
        for _ in range(n):
            frame = read_yuv_frame(f, w, h)
            if frame is None:
                return
            yield frame


def config_from_args(args, w: int, h: int) -> EncoderConfig:
    """homer_app.py's mapping of the flags to EncoderConfig."""
    return EncoderConfig(
        width=w, height=h, frame_rate=args.frame_rate, cu_size=args.cu_size,
        intra_period=(1 if args.gop_size == 0 else args.intra_period),
        gop_size=args.gop_size, qp=args.qp,
        chroma_qp_offset=args.chroma_qp_offset,
        bitrate_mode=BitrateMode(args.bitrate_mode), bitrate=args.bitrate,
        vbv_size=int(args.vbv_size * args.bitrate),
        vbv_init=int(args.vbv_init * args.vbv_size * args.bitrate),
        sign_hiding=bool(args.sign_hiding),
        sample_adaptive_offset=bool(args.sao),
        deblocking=bool(args.deblocking),
        motion_estimation_precision=MEPrecision(args.motion_estimation_precision),
        me_search_range=args.search_range,
        rd_mode=RDMode(args.rd_mode),
        performance_mode=PerformanceMode(args.performance_mode),
        max_intra_tr_depth=args.max_intra_tr_depth,
        max_inter_tr_depth=args.max_inter_tr_depth,
        wpp=args.n_wpp_threads > 0)


def main(argv=None) -> int:
    args = parse_args(argv if argv is not None else sys.argv[1:])
    w, h = map(int, args.size.lower().split("x"))
    cfg = config_from_args(args, w, h)
    prof = Profiler(enabled=args.profiling)
    ibp = args.gop_size >= 2
    try:
        enc = HomerEncoder(cfg, device=args.device, profiler=prof,
                           fetch_recon=(bool(args.output_raw or args.metrics)
                                        if ibp else True))
    except NotImplementedError as e:
        print(f"homer_app_torch: {e}", file=sys.stderr)
        return 2
    frames = read_yuv_frames(args.input, w, h, args.n_frames,
                             args.skipped_frames)
    if ibp:
        return _main_ibp(args, enc, frames, prof)

    out_f = open(args.output, "wb") if args.output else None
    raw_f = open(args.output_raw, "wb") if args.output_raw else None
    n = 0
    t0 = time.time()
    for y, u, v in frames:
        au = enc.encode_frame(y, u, v)
        if out_f:
            out_f.write(au)
        if raw_f:
            write_yuv_frame(raw_f, *enc.last_recon)
        psnr_txt = ""
        if args.metrics:
            ry, ru, rv = enc.last_recon
            psnr_txt = (f", PSNR Y:{psnr(y, ry):.2f} U:{psnr(u, ru):.2f}"
                        f" V:{psnr(v, rv):.2f}")
        ptype = 'I' if n == enc.last_idr else 'P'
        print(f"POC:{n}, {ptype}, bits:{len(au) * 8}, qp: {enc.last_qp}"
              f"{psnr_txt}", flush=True)
        n += 1
    dt = time.time() - t0
    if out_f:
        out_f.close()
    if raw_f:
        raw_f.close()
    enc.close()
    print(f"{n} frames in {dt*1000:.0f} milliseconds: {n/dt:f} fps")
    if args.profiling:
        print(prof.report())
    return 0


def _main_ibp(args, enc, frames, prof) -> int:
    """Streaming IBP: push_frame holds each B until its future anchor
    arrives and returns AUs in decode order; flush codes the last one."""
    out_f = open(args.output, "wb") if args.output else None
    n_out, total = 0, 0
    t0 = time.time()
    for y, u, v in frames:
        for au in enc.push_frame(y, u, v):
            total += len(au)
            if out_f:
                out_f.write(au)
            n_out += 1
    for au in enc.flush():
        total += len(au)
        if out_f:
            out_f.write(au)
        n_out += 1
    dt = max(time.time() - t0, 1e-9)
    print(f"{n_out} frames in {dt * 1000:.0f} milliseconds:"
          f" {n_out / dt:f} fps ({total * 8 * 25 / max(n_out,1) / 1000:.1f}"
          f" kbps est)")
    if args.profiling:
        print(prof.report())
    if out_f:
        out_f.close()
    return 0
