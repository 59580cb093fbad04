"""What the compiler made of the port's CUDA kernels, and how fast they run
beside other designs (one GPU; 1280x720 call-site shapes).

    python3 tools/kernel_report.py [--old DIR]

Builds kernels/me_sad.cu and kernels/gather_win.cu, then
  * prints what `-Xptxas -v` said (registers, shared memory, spills);
  * disassembles each library with `cuobjdump -sass`, writes the listings to
    <out>/sass_<kernel>.txt and prints, per kernel function, how often
    each opcode of interest occurs (is VABSDIFF4 there, or was vabsdiff4
    expanded into other instructions?);
  * checks both kernels against the plain PyTorch version (exact equality)
    and times them (chip_smoke.cuda_ms: a CUDA graph of the launches,
    replayed between CUDA events), beside an empty kernel of the same grid,
    in the order a, b, ..., b, a; me_sad at B 32 (736x1280) and B 64
    (768x1280), S 16, also beside its generic (any-B) kernel, which a
    second build of kernels/me_sad.cu with -DME_SAD_GENERIC_ONLY takes at
    every B;
  * builds tools/gather_variants.cu (two other designs of the gather: a warp
    per window row, and the window staged in shared memory and written as
    16-byte vectors), checks them the same way and times them in the same
    loop as the kernel the port ships;
  * builds tools/int_rate.cu and prints the measured throughput of
    vabsdiff4 (with accumulate) and of mad.lo.u32 in lanes per clock and SM,
    which says what instruction bound applies to me_sad;
  * with --old DIR (a directory holding an earlier version of the two .cu
    files whose launchers have the first version's signatures: me_sad with
    int16 planes, gather_win with one plane), times those in the same
    process, so old and new are compared on one card in one run.

    python3 tools/kernel_report.py --sweep

only builds kernels/gather_win.cu, prints what `-Xptxas -v` said of it,
and at each 720p call site whose window is small (G 7-25: the quadtree
path's CU-8 and CU-16 sites and the CU-32 chroma pair, whether the
launcher takes the span path there or not) holds the span path
at every width W it takes, and the span path's other design (variant 3 of
tools/gather_variants.cu: no shared-memory stage), against the plain
version (exact), then times, in the order a, b, ..., b, a: the window path,
its empty grid, the span path, variant 3 and the empty grid of their
launch shape at each W, and one PyTorch indexing call per plane. That is
how gather_win.cu's span widths and its span design were chosen.
Listings and built libraries go to the directory REPORT_DIR names
(default report_out/, listed in .gitignore). Needs a CUDA device with nvcc
and cuobjdump; imports no JAX.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, os.environ.get("REPORT_DIR", "report_out"))
OPCODES = ("VABSDIFF4", "VABSDIFF", "LDS", "STS", "LDG", "STG", "SHF", "PRMT",
           "IADD3", "IMAD", "LOP3", "ISETP", "SHFL", "BAR", "BRA")


def sass_report(name: str, lib) -> None:
    from torch.utils.cpp_extension import CUDA_HOME
    exe = os.path.join(CUDA_HOME, "bin", "cuobjdump")
    res = subprocess.run([exe, "-sass", str(lib)], capture_output=True,
                         text=True, check=True)
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, f"sass_{name}.txt"), "w") as f:
        f.write(res.stdout)
    func, counts, total = None, {}, {}
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            func = m.group(1)
            counts[func] = collections.Counter()
            total[func] = 0
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\d+\s+)?([A-Z0-9_]+)",
                     line)
        if m and func:
            total[func] += 1
            op = m.group(1)
            for key in OPCODES:
                if op == key:
                    counts[func][key] += 1
    for func in counts:
        shown = ", ".join(f"{k} {v}" for k, v in counts[func].items())
        print(f"  sass {func}: {total[func]} instructions; {shown}")


def build_so(src: str, so_name: str, show: bool = False,
             flags: tuple = ()) -> str:
    """Compile one .cu with the port's flags (and `flags`) into OUT, with
    `show` printing what `-Xptxas -v` said of it. Returns the library's
    path."""
    from homerhevc_tpu_torch.kernels import build
    so = os.path.join(OUT, so_name)
    os.makedirs(OUT, exist_ok=True)
    res = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, *flags,
                          "-o", so, src], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{res.stderr}")
    if show:
        print(f"== {os.path.basename(src)}")
        print(res.stderr)
    return so


def int_rates(dev) -> None:
    """Measured throughput of vabsdiff4 and mad.lo.u32 (tools/int_rate.cu)."""
    import torch

    import chip_smoke as cs
    fn = ctypes.CDLL(build_so(os.path.join(ROOT, "tools", "int_rate.cu"),
                              "int_rate.so")).int_rate_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes, fn.restype = [I, P, I, I, I, P], I
    blocks, threads, iters = cs.SMS * 8, 256, 2048
    out = torch.empty(blocks * threads, dtype=torch.int32, device=dev)
    hz = cs.max_sm_hz()
    for op, name in ((0, "vabsdiff4.add"), (1, "mad.lo.u32")):
        def run():
            rc = fn(op, out.data_ptr(), blocks, threads, iters,
                    torch.cuda.current_stream(dev).cuda_stream)
            assert rc == 0, rc
        ms = cs.cuda_ms(run, 5)
        lanes = blocks * threads * iters * 64 / (ms * 1e-3)
        print(f"  {name}: {ms:.4f} ms per launch, {lanes:.4e} lane-"
              f"instructions/s, {lanes / hz / cs.SMS:.2f} lanes per clock "
              f"and SM at the maximum SM clock of {hz / 1e6:.0f} MHz")


def old_kernels(old_dir: str):
    """Build and bind the earlier versions of the two kernels."""
    P, I = ctypes.c_void_p, ctypes.c_int
    sigs = {"me_sad": [P, P, P, P, P, I, I, I, I, I, I, P],
            "gather_win": [P, P, P, P, I, I, I, I, P]}
    fns = {}
    for name, argtypes in sigs.items():
        so = build_so(os.path.join(old_dir, f"{name}.cu"), f"old_{name}.so")
        fn = getattr(ctypes.CDLL(so), f"{name}_launch")
        fn.argtypes, fn.restype = argtypes, I
        fns[name] = fn
    return fns


def gather_sweep(dev) -> None:
    """The span path of gather_win at every width W it takes, beside the
    window path, at the 720p small-window sites (see the module's doc)."""
    import torch

    import chip_smoke as cs
    from homerhevc_tpu_torch.ops import gather
    from homerhevc_tpu_torch.utils.fixtures import clip

    def stream():        # the current stream: a graph capture's own, inside
        return torch.cuda.current_stream(dev).cuda_stream

    P_, I_ = ctypes.c_void_p, ctypes.c_int
    direct_fn = ctypes.CDLL(build_so(
        os.path.join(ROOT, "tools", "gather_variants.cu"),
        "gather_variants.so")).gather_span_direct_launch
    direct_fn.argtypes = [P_] * 4 + [I_, P_, P_, P_] + [I_] * 5 + [P_]
    direct_fn.restype = I_

    def direct(plane, by, bx, G, w):
        planes = plane if isinstance(plane, tuple) else (plane,)
        out = torch.empty((len(planes), by.shape[0], G, G),
                          dtype=torch.int16, device=dev)
        ptrs = [p.data_ptr() for p in planes] + [None] * (4 - len(planes))
        rc = direct_fn(*ptrs, len(planes), by.data_ptr(), bx.data_ptr(),
                       out.data_ptr(), by.shape[0], *planes[0].shape, G, w,
                       stream())
        assert rc == 0, rc
        return out

    frames = clip("720p")
    sites = {}
    for H, sizes in ((768, (8,)), (736, (16, 32))):
        for name, site in cs.fast_gather_sites(dev, frames[1], frames[0], H,
                                               1280, 64, sizes).items():
            if site[3] <= 25:     # the G with a span-path instance
                sites[f"{H}x1280 {name}"] = site
    for name, (plane, by, bx, G) in sites.items():
        by, bx = by.to(torch.int32), bx.to(torch.int32)
        nb = by.shape[0]
        P = len(plane) if isinstance(plane, tuple) else 1
        want = gather.gather_windows_plain(plane, by, bx, G).reshape(-1)
        # every W the span kernel takes: a multiple of 8, at most 4 chunks
        # of 8 samples a thread of 256
        widths = [w for w in range(8, 257, 8) if w * G * G <= 4 * 8 * 256]
        runs = [("window path", lambda: cs.gather_entry(
                    "gather_win_window_launch", plane, by, bx, G)),
                ("window path, empty grid",
                 lambda: gather.GATHER_WIN.launch_floor(nb, P, G, 0,
                                                        stream()))]
        for w in widths:
            got = cs.gather_entry("gather_win_span_launch", plane, by, bx, G,
                                  w)
            assert torch.equal(got.reshape(-1), want), (name, w)
            got = direct(plane, by, bx, G, w)
            assert torch.equal(got.reshape(-1), want), (name, w, "direct")
            runs.append((f"span W {w} ({-(-nb * P // w)} CTAs)",
                         lambda w=w: cs.gather_entry(
                             "gather_win_span_launch", plane, by, bx, G, w)))
            runs.append((f"span W {w}, direct (variant 3)",
                         lambda w=w: direct(plane, by, bx, G, w)))
            runs.append((f"span W {w}, empty grid",
                         lambda w=w: gather.GATHER_WIN.launch_floor(
                             nb, P, G, w, stream())))
        y0, x0 = cs.clamped_starts(plane, by, bx, G)
        runs.append(("one indexing call per plane",
                     lambda: cs.library_gather(plane, y0, x0, G)))
        print(f"gather_win {name} (G {G}, nb {nb} x {P}; the launcher takes "
              f"W {cs.span_width(G)}; ms per call, 100 calls):")
        for label, fn in runs + runs[::-1]:
            print(f"  {label}: {cs.cuda_ms(fn, 100):.4f}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", default=None)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from homerhevc_tpu_torch.device import require_cuda
    from homerhevc_tpu_torch.kernels import build
    from homerhevc_tpu_torch.ops import gather, me
    from homerhevc_tpu_torch.pipeline.p_torch import PAD
    from homerhevc_tpu_torch.utils.fixtures import clip

    dev = require_cuda()
    print(f"card: {cs.card_line()}; max SM clock "
          f"{cs.max_sm_hz() / 1e6:.0f} MHz")
    if args.sweep:
        lib = build.build_library("gather_win")
        print(build.ptxas_log(lib).read_text())
        gather_sweep(dev)
        return 0
    names = ("me_sad", "gather_win")
    for name, lib in zip(names, build.build_all(names)):
        print(f"== {name}: {lib.name}")
        print(build.ptxas_log(lib).read_text())
        sass_report(name, lib)
    print("integer instruction throughput:")
    int_rates(dev)
    old = old_kernels(args.old) if args.old else {}

    frames = clip("720p")
    W, S = 1280, 16

    def stream():        # the current stream: a graph capture's own, inside
        return torch.cuda.current_stream(dev).cuda_stream

    P, I = ctypes.c_void_p, ctypes.c_int
    generic_lib = ctypes.CDLL(build_so(
        os.path.join(ROOT, "homerhevc_tpu_torch", "kernels", "me_sad.cu"),
        "me_sad_generic.so", flags=("-DME_SAD_GENERIC_ONLY",)))
    generic_me = generic_lib.me_sad_launch
    generic_me.argtypes, generic_me.restype = me.ME_SAD.argtypes, I
    for H, B in ((768, 64), (736, 32)):
        cases = cs.me_cases(dev, frames[1], frames[0], H, W, S)
        want = {k: me.integer_me_plain(*v, B=B, search=S, pad=PAD)
                for k, v in cases.items()}
        runs = []
        for k, v in cases.items():
            got = me.integer_me_cuda(*v, B=B, search=S, pad=PAD)
            assert all(torch.equal(a, b) for a, b in zip(got, want[k])), k
        for dt in ("uint8", "int16"):
            cur, ref, mc = cases[f"real {dt}"]
            runs.append((f"me_sad, cur {dt}",
                         lambda cur=cur, ref=ref, mc=mc: me.integer_me_cuda(
                             cur, ref, mc, B=B, search=S, pad=PAD)))
        cur, ref, mc = cases["real uint8"]
        cost = torch.empty((H // B, W // B), dtype=torch.int32, device=dev)
        idx = torch.empty_like(cost)

        def generic(cur=cur, ref=ref, mc=mc, cost=cost, idx=idx, H=H, B=B):
            rc = generic_me(cur.data_ptr(), ref.data_ptr(), mc.data_ptr(),
                            cost.data_ptr(), idx.data_ptr(), H, W,
                            ref.shape[1], B, S, PAD, 1,
                            int(ref.dtype == torch.uint8), stream())
            assert rc == 0, rc
        generic()
        assert torch.equal(cost, want["real uint8"][0])
        assert torch.equal(idx, want["real uint8"][1])
        runs.append(("me_sad generic (any-B) kernel, cur uint8", generic))
        runs.append(("me_sad, empty grid",
                     lambda H=H, B=B: me.ME_SAD.launch_floor(H, W, B, S,
                                                             stream())))
        if B == 64:
            print(f"me_sad, {H}x{W}, B {B}, S {S} (ms per launch, 50 "
                  "launches):")
            for label, fn in runs + runs[::-1]:
                print(f"  {label}: {cs.cuda_ms(fn, 50):.4f}")
    # B 32 goes on below with the old kernels, where --old names them
    cur, ref, mc = cases["real int16"]
    if old:
        cost = torch.empty((H // B, W // B), dtype=torch.int32, device=dev)
        idx = torch.empty_like(cost)

        def old_me():
            rc = old["me_sad"](cur.data_ptr(), ref.data_ptr(), mc.data_ptr(),
                               cost.data_ptr(), idx.data_ptr(), H, W,
                               ref.shape[1], B, S, PAD, stream())
            assert rc == 0, rc
        old_me()
        assert torch.equal(cost, want["real int16"][0])
        runs = [("me_sad old", old_me)] + runs + [("me_sad old", old_me)]
    print("me_sad, 736x1280, B 32, S 16 (ms per launch, 50 launches):")
    for label, fn in runs + runs[::-1]:
        print(f"  {label}: {cs.cuda_ms(fn, 50):.4f}")

    _, best = want["real uint8"]
    sites = cs.gather_sites(dev, frames[0], best, H, W, B, S)
    variants = ctypes.CDLL(build_so(
        os.path.join(ROOT, "tools", "gather_variants.cu"),
        "gather_variants.so", show=True)).gather_variants_launch
    variants.argtypes = [P, P, P, P, I, P, P, P, I, I, I, I, I, P]
    variants.restype = I
    for name, (plane, by, bx, G) in sites.items():
        ref_out = gather.gather_windows_plain(plane, by, bx, G)
        planes = plane if isinstance(plane, tuple) else (plane,)
        ptrs = [p.data_ptr() for p in planes] + [None] * (4 - len(planes))
        vout = torch.empty((len(planes), by.shape[0], G, G),
                           dtype=torch.int16, device=dev)

        def other(which):
            rc = variants(*ptrs, len(planes), by.data_ptr(), bx.data_ptr(),
                          vout.data_ptr(), by.shape[0], planes[0].shape[0],
                          planes[0].shape[1], G, which, stream())
            assert rc == 0, rc

        assert torch.equal(gather.gather_windows_cuda(plane, by, bx, G),
                           ref_out), name
        runs = [("shipped kernel (gather_win_launch's path at this G)",
                 lambda: gather.gather_windows_cuda(plane, by, bx, G))]
        for which, vname in ((1, "rows (a warp per row, 4-byte stores)"),
                             (2, "staged (shared memory, 16-byte stores)")):
            vout.zero_()
            other(which)
            assert torch.equal(vout.reshape(-1), ref_out.reshape(-1)), \
                (name, vname)
            runs.append((vname, lambda which=which: other(which)))
        runs.append(("empty grid", lambda: gather.GATHER_WIN.launch_floor(
            by.shape[0], len(planes), G, -1, stream())))
        y0, x0 = cs.clamped_starts(plane, by, bx, G)
        runs.append(("one indexing call per plane",
                     lambda: cs.library_gather(plane, y0, x0, G)))
        if old:
            outs = [torch.empty((by.shape[0], G, G), dtype=torch.int16,
                                device=dev) for _ in planes]

            def old_gather():
                for p, o in zip(planes, outs):
                    rc = old["gather_win"](p.data_ptr(), by.data_ptr(),
                                           bx.data_ptr(), o.data_ptr(),
                                           by.shape[0], p.shape[0],
                                           p.shape[1], G, stream())
                    assert rc == 0, rc
            old_gather()
            assert torch.equal(torch.stack(outs).reshape(-1),
                               ref_out.reshape(-1))
            runs = ([("old (one launch per plane)", old_gather)] + runs
                    + [("old (one launch per plane)", old_gather)])
        print(f"gather_win {name} (ms per call, 200 calls):")
        for label, fn in runs + runs[::-1]:
            print(f"  {label}: {cs.cuda_ms(fn, 200):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
