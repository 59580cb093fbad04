"""homerhevc_tpu_torch — the PyTorch/CUDA port of the homerhevc_tpu encoder.

The JAX package `homerhevc_tpu` is the reference: every Access Unit this
package writes must equal, byte for byte, what `homerhevc_tpu.api.
HomerEncoder(cfg, backend="jax")` writes for the same frames. This package
imports torch and never jax, and nothing of the JAX package either: it
keeps its own copies of the host modules it needs (config, numpy tables,
entropy coding with its own build of libhenc, AU assembly, the host SAO and
merge/AMVP derivations, synthetic clips, libde265 validation), under the
same names and layout. Only the tests import both packages.

Supported (what `api.check_slice` admits): cu_size 32 and 64 in every
performance mode — FASTEST_COMPUTATION (IDR at CU = TU = min(CTU, 32),
fixed-CU P frames), FASTER_COMPUTATION (split-RDO IDR, fixed-CU P frames),
FAST_COMPUTATION (split-RDO IDR, inter CU quadtree P frames with
hierarchical ME, inter TU split and intra-in-P at CTU 32) and
FULL_COMPUTATION (the quadtree down to 8x8 inter CUs) — and cu_size 16 in
FASTEST and FASTER; fixed QP, CBR or VBR (per-CTU-row QPs on the quadtree
path); WPP or not; every rd_mode (FULL, FAST, DIST_ONLY); all-intra
(intra_period 1); and B frames (gop_size >= 2: IBP through push_frame /
flush) at cu_size 16 and 32; several devices: a band mesh
(`HomerEncoder(mesh=...)`, or `wpp_shards` > 1 where the machine has that
many CUDA devices) runs every frame in bands of CTU rows, and the
GopPipeline spreads frame spans over processes (torch.distributed, gloo).
FAST and FULL at cu_size 16 (the JAX package fails there), B frames at
cu_size 64 and bit_depth != 8 raise NotImplementedError naming the
setting.

Layer map:
  app.py                  — the console app (homer_app_torch.py launches
                            it): homer_app.py's flags and printed lines
  api.py                  — HomerEncoder session (IDR + chunked P frames,
                            per-frame encode_frame, streaming IBP; an
                            optional stage profiler), write_annex_b; runs
                            on the CUDA device unless told device="cpu"
  config.py               — EncoderConfig and its enums
  device.py               — device checks and int32 helpers
  tables.py               — numpy spec tables + torch twins
  entropy/                — bitstream, headers, CABAC (Python oracle) and
                            libhenc (C++, built with g++ at first use)
  ops/                    — transforms, quant, intra prediction, deblock, SAO
                            (device and host derivation), inter candidate
                            decisions (P and B), and the two kernel-backed
                            ops (me.py, gather.py)
  pipeline/               — intra_torch (IDR wavefront, fixed CU or decided
                            quadtree), p_torch (fixed-CU and quadtree P
                            stages), b_torch (B stage), p_chunk (K-frame
                            device loop + wire), b_golden (host plans of
                            B frames), assemble (headers + slice data ->
                            Annex-B)
  parallel/               — sharded (the band- and lane-sharded fixed-CU P
                            stage on a mesh of devices, halo exchange
                            device to device), multihost (the round-robin
                            frame-span GopPipeline across processes)
  kernels/                — hand-written CUDA kernels for sm_90a + build
  utils/, validate/       — synthetic clips, YUV file I/O, PSNR, the stage
                            profiler, the reference runs' fixtures helpers,
                            libde265 decode check
"""

__version__ = "0.4.0"
