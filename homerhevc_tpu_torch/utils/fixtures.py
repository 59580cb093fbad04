"""The port's reference runs: the configurations, the seeded clips, the AU
digest and the decoder check that chip_smoke.py and the tests share.

tests/fixtures/torch_port_aus.json holds the SHA-256 and length of every AU
the JAX package writes for each of RUNS (tools/make_torch_fixtures.py writes
it, with the same RUNS and the same configuration keywords); the port's AUs
must hash the same. All runs share quarter-pel, fixed QP 32, deblocking +
SAO + sign hiding, intra_period 100, frame_pipeline_depth 2; the runs
under rate control start at QP 32 and move from there.
`slice_kwargs` is the fixed-CU configuration (cu_size 32,
FASTEST_COMPUTATION, search 16); `fast_kwargs` is the configuration the
repository's bench.py times (FAST_COMPUTATION, search 64: CU quadtree P
frames with hierarchical ME, intra-in-P, inter RQT, and the split-RDO IDR);
`ctu64_kwargs` is the JAX package's default configuration (cu_size 64,
FAST_COMPUTATION, search 16); `full_kwargs` is FULL_COMPUTATION (8x8 inter
CUs) at cu_size 32, search 64:

  small:          synth_clip(128, 96, 6, seed=3), slice, chunk 3
  720p:           synth_clip(1280, 720, 17, seed=0), slice, chunk 8
  fast_small:     synth_clip(128, 96, 6, seed=3), fast, chunk 3
  fast_720p:      synth_clip(1280, 720, 9, seed=0), fast, chunk 8
  default_720p:   synth_clip(1280, 720, 9, seed=0), ctu64, chunk 8
  full64_720p:    the same clip, ctu64 with FULL and search 64
  fastest64_720p: the same clip, ctu64 with FASTEST
  full32_small:   synth_clip(128, 96, 4, seed=3), full, chunk 3

and small variants with single settings replaced (`over`): of the fast
configuration (also at a size that needs padding, 120x88; with search 16
the clip's motion leaves the window, so that run re-encodes frames of a
chunk as IDR: scene cuts), of the CTU-64 one on synth_clip(192, 128, 4,
seed=3) (2 x 3 CTUs, so a wavefront diagonal holds two lanes), and of the
FULL one at search 16. Rate control and WPP: CBR, VBR, CBR + WPP and WPP
alone in FAST at 128x96, VBR in FASTEST, CBR with scene cuts at 120x88
(search 16), CBR in FULL at 192x128 and in FASTEST at CTU 64, and the two
720p paths of chip_smoke.py, `cbr_wpp_720p` and `vbr_fastest_720p`
(synth_clip(1280, 720, 17, seed=0), chunk 8, 400 kbps). DECODER_RUNS are
CBR runs of the CTU-64 quadtree path, which the JAX package cannot code:
they are held to libde265 alone.
Multi-device (`plain_kwargs`: EncoderConfig's defaults at cu_size 32, the
configurations of the JAX package's tests/test_multichip.py and
tests/test_multihost.py): runs with `mesh` = n go through a session with a
band mesh of n devices (in the JAX package a jax Mesh of n of the test
conftest's 8 virtual CPU devices; in the port ["cpu"] * n), the
`mesh_wpp_shards_small` run through wpp_shards = 4; the tool records them
from the JAX session with and without its mesh, asserting the two equal
(the session on a mesh codes every frame in bands: IDR, P and B).
Runs with `per_frame` go through encode_frame frame by frame; runs with
`seeded` start from their first frame as the reference (seed_reference,
poc 1) and code the others as P frames, no IDR. The `mh_*`
runs are the single-process streams the two-process GopPipeline must write.
INTRA_CASES are single frames (`intra_frame`) through the split-RDO IDR
stage alone; the fixture holds a SHA-256 per output array for them.
SHARDED_CASES are single P steps of the band-sharded stage
(parallel/sharded.make_p_frame_sharded) on synth_clip frames; the fixture
holds per output a SHA-256 of the JAX package's sharded step and of its
single-device stage, lane by lane.
CLI_RUNS go through the JAX package's CLI (homer_app.py) and the port's
(app.py) on the same .yuv file and flags; the fixture's "cli" entry holds
what cli_record reads off the JAX CLI's outputs.
"""

from __future__ import annotations

import hashlib

import numpy as np

from ..config import BitrateMode, EncoderConfig, PerformanceMode, RDMode
from ..validate import de265
from .synth import synth_clip

# rate-control settings of the small runs (kbps, kbit): a bitrate and
# buffer a few P frames of these clips overrun
_RC8 = dict(bitrate=8, vbv_size=16, vbv_init=8)
_RC16 = dict(bitrate=16, vbv_size=32, vbv_init=16)

_FASTER16 = dict(cu_size=16, performance_mode="FASTER_COMPUTATION")
CTU16_RUNS = {
    "fastest16_small": dict(width=120, height=88, frames=6, seed=3, chunk=3,
                            over=dict(cu_size=16)),
    **{f"faster16_rd{rd}_small": dict(
        width=120, height=88, frames=4, seed=3, chunk=3,
        over=dict(_FASTER16, rd_mode=RDMode(rd).name)) for rd in (0, 1, 2)},
    "faster16_tr0_small": dict(width=120, height=88, frames=4, seed=3,
                               chunk=3, over=dict(_FASTER16,
                                                  max_intra_tr_depth=0)),
    "ibp_fastest16_small": dict(width=120, height=88, frames=6, seed=3,
                                chunk=3, push=True,
                                over=dict(cu_size=16, gop_size=2)),
    "ibp_faster16_s64_small": dict(width=120, height=88, frames=6, seed=3,
                                   chunk=3, push=True,
                                   over=dict(_FASTER16, gop_size=2,
                                             me_search_range=64)),
    "cbr_wpp_faster16_small": dict(width=120, height=88, frames=8, seed=3,
                                   chunk=2, over=dict(_FASTER16, **_RC8,
                                                      bitrate_mode="CBR",
                                                      wpp=True)),
    "vbr_fastest16_small": dict(width=120, height=88, frames=6, seed=3,
                                chunk=2, over=dict(_RC8, cu_size=16,
                                                   bitrate_mode="VBR")),
    "fastest16_s64_small": dict(width=120, height=88, frames=4, seed=3,
                                chunk=3, over=dict(cu_size=16,
                                                   me_search_range=64)),
}

RUNS = {
    "small": dict(width=128, height=96, frames=6, seed=3, chunk=3),
    "720p": dict(width=1280, height=720, frames=17, seed=0, chunk=8),
    "fast_small": dict(width=128, height=96, frames=6, seed=3, chunk=3,
                       config="fast"),
    "fast_720p": dict(width=1280, height=720, frames=9, seed=0, chunk=8,
                      config="fast"),
    "faster_small": dict(width=128, height=96, frames=4, seed=3, chunk=3,
                         config="fast",
                         over=dict(performance_mode="FASTER_COMPUTATION")),
    "fast_s16_small": dict(width=128, height=96, frames=4, seed=3, chunk=3,
                           config="fast", over=dict(me_search_range=16)),
    "fast_inter_tr0_small": dict(width=128, height=96, frames=4, seed=3,
                                 chunk=3, config="fast",
                                 over=dict(max_inter_tr_depth=0)),
    "fast_intra_tr0_small": dict(width=128, height=96, frames=4, seed=3,
                                 chunk=3, config="fast",
                                 over=dict(max_intra_tr_depth=0)),
    "fast_padded_small": dict(width=120, height=88, frames=4, seed=3,
                              chunk=3, config="fast"),
    "default_720p": dict(width=1280, height=720, frames=9, seed=0, chunk=8,
                         config="ctu64"),
    "full64_720p": dict(width=1280, height=720, frames=9, seed=0, chunk=8,
                        config="ctu64",
                        over=dict(performance_mode="FULL_COMPUTATION",
                                  me_search_range=64)),
    "fastest64_720p": dict(width=1280, height=720, frames=9, seed=0,
                           chunk=8, config="ctu64",
                           over=dict(performance_mode="FASTEST_COMPUTATION")),
    "default_small": dict(width=192, height=128, frames=4, seed=3, chunk=3,
                          config="ctu64"),
    "faster64_small": dict(width=192, height=128, frames=4, seed=3, chunk=3,
                           config="ctu64",
                           over=dict(performance_mode="FASTER_COMPUTATION")),
    "faster64_s64_small": dict(width=192, height=128, frames=4, seed=3,
                               chunk=3, config="ctu64",
                               over=dict(performance_mode="FASTER_COMPUTATION",
                                         me_search_range=64)),
    "fastest64_small": dict(width=192, height=128, frames=4, seed=3, chunk=3,
                            config="ctu64",
                            over=dict(performance_mode="FASTEST_COMPUTATION")),
    "full64_small": dict(width=192, height=128, frames=4, seed=3, chunk=3,
                         config="ctu64",
                         over=dict(performance_mode="FULL_COMPUTATION",
                                   me_search_range=64)),
    "full64_s16_small": dict(width=192, height=128, frames=4, seed=3,
                             chunk=3, config="ctu64",
                             over=dict(performance_mode="FULL_COMPUTATION")),
    "full32_small": dict(width=128, height=96, frames=4, seed=3, chunk=3,
                         config="full"),
    "full32_s16_small": dict(width=128, height=96, frames=4, seed=3, chunk=3,
                             config="full", over=dict(me_search_range=16)),
    # rate control: settings under which the small runs take three or more
    # slice QPs, plan row QPs that differ within a frame, and run the VBV
    # buffer dry (its guardrails raise the QP)
    "cbr_fast_small": dict(width=128, height=96, frames=10, seed=3, chunk=2,
                           config="fast", over=dict(_RC8, bitrate_mode="CBR")),
    "vbr_fast_small": dict(width=128, height=96, frames=10, seed=3, chunk=2,
                           config="fast", over=dict(_RC8, bitrate_mode="VBR")),
    "cbr_wpp_small": dict(width=128, height=96, frames=10, seed=3, chunk=2,
                          config="fast",
                          over=dict(_RC8, bitrate_mode="CBR", wpp=True)),
    "wpp_fast_small": dict(width=128, height=96, frames=4, seed=3, chunk=3,
                           config="fast", over=dict(wpp=True)),
    "vbr_fastest_small": dict(width=128, height=96, frames=5, seed=3,
                              chunk=2, over=dict(_RC8, bitrate_mode="VBR")),
    "cbr_scene_small": dict(width=120, height=88, frames=8, seed=3,
                            chunk=2, config="fast",
                            over=dict(_RC8, bitrate_mode="CBR",
                                      me_search_range=16)),
    "cbr_full_small": dict(width=192, height=128, frames=8, seed=3, chunk=2,
                           config="full",
                           over=dict(_RC16, bitrate_mode="CBR")),
    "cbr_fastest64_small": dict(width=192, height=128, frames=5, seed=3,
                                chunk=2, config="ctu64",
                                over=dict(_RC16, bitrate_mode="CBR",
                                          performance_mode=(
                                              "FASTEST_COMPUTATION"))),
    "cbr_wpp_720p": dict(width=1280, height=720, frames=17, seed=0, chunk=8,
                         config="fast", over=dict(bitrate_mode="CBR",
                                                  bitrate=400, wpp=True)),
    "vbr_fastest_720p": dict(width=1280, height=720, frames=17, seed=0,
                             chunk=8, over=dict(bitrate_mode="VBR",
                                                bitrate=400)),
    # B frames (gop_size 2): IBP through push_frame / flush ("push")
    "ibp_small": dict(width=128, height=96, frames=8, seed=3, chunk=3,
                      push=True, over=dict(gop_size=2, intra_period=0)),
    "ibp_ip4_small": dict(width=128, height=96, frames=6, seed=3, chunk=3,
                          push=True, over=dict(gop_size=2, intra_period=4)),
    "ibp_odd_small": dict(width=128, height=96, frames=5, seed=3, chunk=3,
                          push=True, over=dict(gop_size=2)),
    "ibp_vbr_small": dict(width=128, height=96, frames=10, seed=3, chunk=3,
                          push=True,
                          over=dict(_RC8, gop_size=2, bitrate_mode="VBR")),
    "ibp_cbr_fast_small": dict(width=128, height=96, frames=8, seed=3,
                               chunk=3, push=True, config="fast",
                               over=dict(_RC8, gop_size=2,
                                         bitrate_mode="CBR")),
    "ibp_fast_small": dict(width=128, height=96, frames=8, seed=3, chunk=3,
                           push=True, config="fast", over=dict(gop_size=2)),
    "ibp_wpp_small": dict(width=128, height=96, frames=6, seed=3, chunk=3,
                          push=True, config="fast",
                          over=dict(gop_size=2, wpp=True)),
    "ibp_padded_small": dict(width=120, height=88, frames=6, seed=3,
                             chunk=3, push=True, config="fast",
                             over=dict(gop_size=2)),
    "ibp_scene_small": dict(width=128, height=96, frames=6, seed=3, chunk=3,
                            push=True, cut=4, over=dict(gop_size=2)),
    "ibp_frames_small": dict(width=128, height=96, frames=6, seed=3,
                             chunk=3, config="fast", over=dict(gop_size=2)),
    "ibp_fastest_720p": dict(width=1280, height=720, frames=10, seed=0,
                             chunk=8, push=True, over=dict(gop_size=2)),
    "ibp_fast_720p": dict(width=1280, height=720, frames=10, seed=0,
                          chunk=8, push=True, config="fast",
                          over=dict(gop_size=2)),
    # all-intra (intra_period 1) in every rd_mode; the last is BASELINE.md's
    # configuration 1 (CTU 64, rd FAST, no SAO)
    **{f"allintra_rd{rd}_small": dict(
        width=128, height=96, frames=2, seed=3, chunk=3, config="fast",
        over=dict(intra_period=1, rd_mode=RDMode(rd).name))
       for rd in (0, 1, 2)},
    **{f"allintra_fastest_rd{rd}_small": dict(
        width=128, height=96, frames=2, seed=3, chunk=3,
        over=dict(intra_period=1, rd_mode=RDMode(rd).name))
       for rd in (0, 2)},
    **{f"allintra64_rd{rd}_small": dict(
        width=192, height=128, frames=2, seed=3, chunk=3, config="ctu64",
        over=dict(intra_period=1, rd_mode=RDMode(rd).name))
       for rd in (0, 1, 2)},
    "allintra_rdfast64_720p": dict(width=1280, height=720, frames=2, seed=0,
                                   chunk=8, config="ctu64",
                                   over=dict(intra_period=1, rd_mode="FAST",
                                             sample_adaptive_offset=False)),
    # a band mesh of 4 (tests/test_multichip.py's configurations, then an
    # uneven cut: 5 CTU rows in bands of 2, 1, 1, 1; CTU 64: 3 rows in 3
    # bands; IBP: anchors and the explicit P frames in bands)
    "mesh_fastest_small": dict(width=160, height=128, frames=4, seed=0,
                               chunk=3, per_frame=True, mesh=4,
                               config="plain", over=dict(
                                   me_search_range=8,
                                   performance_mode="FASTEST_COMPUTATION")),
    "mesh_fast_small": dict(width=160, height=128, frames=4, seed=0, chunk=3,
                            per_frame=True, mesh=4, config="plain",
                            over=dict(me_search_range=8)),
    "mesh_fast_chunk_small": dict(width=160, height=128, frames=7, seed=1,
                                  chunk=3, mesh=4, config="plain",
                                  over=dict(me_search_range=8)),
    "mesh_wpp_shards_small": dict(width=128, height=96, frames=3, seed=2,
                                  chunk=3, per_frame=True, config="plain",
                                  over=dict(me_search_range=8, wpp_shards=4)),
    "mesh_uneven_small": dict(width=160, height=160, frames=6, seed=3,
                              chunk=3, mesh=4, config="plain", over=dict(
                                  me_search_range=8,
                                  performance_mode="FASTEST_COMPUTATION")),
    "mesh_ctu64_small": dict(width=128, height=192, frames=4, seed=3,
                             chunk=3, per_frame=True, mesh=4, config="plain",
                             over=dict(cu_size=64,
                                       performance_mode="FASTEST_COMPUTATION")),
    "mesh_ibp_small": dict(width=128, height=96, frames=6, seed=3, chunk=3,
                           push=True, mesh=4, config="plain", over=dict(
                               performance_mode="FASTEST_COMPUTATION",
                               gop_size=2)),
    # the quadtree stage and the loop filter in bands ("seeded": the session
    # starts from the clip's first frame as its reference, poc 1, and codes
    # the rest as P frames; no IDR): the defaults at CTU 64 in bands of one
    # CTU row; FULL's 8x8 CUs; the hierarchical search (search 64) in bands
    # of 64 and 32 rows, shorter than its 72-row halo; CBR without WPP (row
    # QPs that differ within a frame: each band's decoded-QP start comes
    # from the band above); CTU 32 in bands of 2, 1, 1, 1 CTU rows, the third
    # starting at the odd row 3, with intra-in-P CUs accepted in the first
    # rows of the second and fourth bands
    "mesh_default_small": dict(width=128, height=256, frames=4, seed=0,
                               chunk=3, seeded=True, mesh=4, config="plain",
                               over=dict(cu_size=64)),
    "mesh_full_small": dict(width=160, height=128, frames=4, seed=1,
                            chunk=3, seeded=True, per_frame=True, mesh=4,
                            config="plain", over=dict(
                                performance_mode="FULL_COMPUTATION")),
    "mesh_hier_small": dict(width=128, height=160, frames=4, seed=2, chunk=2,
                            seeded=True, mesh=4, config="fast"),
    "mesh_cbr_tree_small": dict(width=128, height=128, frames=10, seed=3,
                                chunk=2, seeded=True, mesh=4, config="fast",
                                over=dict(_RC8, bitrate_mode="CBR")),
    "mesh_intra_p_odd_small": dict(width=160, height=160, frames=6, seed=0,
                                   chunk=3, seeded=True, mesh=4,
                                   config="plain"),
    # the IDR and the B frames in bands: IBP in FAST (the split-RDO IDR in
    # bands of 2, 1, 1, 1 CTU rows; the hierarchical B search, search 64,
    # on bands shorter than its 72-row halo); all-intra in rd_mode FAST
    # (pass A's refinement and pass B across bands in every frame, a band
    # starting at the odd CTU row 3); ibp_scene_small's scene-cut IDR,
    # re-encoded in bands beside a waiting B
    "mesh_ibp_fast_small": dict(width=128, height=160, frames=6, seed=2,
                                chunk=3, push=True, mesh=4, config="fast",
                                over=dict(gop_size=2)),
    "mesh_allintra_rdfast_small": dict(width=160, height=160, frames=3,
                                       seed=1, chunk=3, mesh=4,
                                       config="fast", over=dict(
                                           intra_period=1, rd_mode="FAST")),
    "mesh_ibp_scene_small": dict(width=128, height=96, frames=6, seed=3,
                                 chunk=3, push=True, cut=4, mesh=4,
                                 over=dict(gop_size=2)),
    # CTU 16 (FASTEST and FASTER; the JAX package has no quadtree P stage
    # there, fault 1), at a size that needs padding (120x88 -> 8 x 6 CTUs):
    # FASTEST; FASTER in every rd_mode and without the intra TU split; IBP
    # in FASTEST, and in FASTER at search 64 (the hierarchical search at B
    # 16); CBR with WPP in FASTER and VBR in FASTEST; FASTEST at search 64
    **CTU16_RUNS,
    # each of them again on a band mesh of 4 (6 CTU rows in bands of 2, 2,
    # 1, 1: the second band starts at row 32, the third at row 64, the
    # fourth at row 80, off the IDR's 32-row deblocking grid)
    **{"mesh_" + k: dict(v, mesh=4) for k, v in CTU16_RUNS.items()},
    # the three 720p paths of chip_smoke.py at CTU 16
    "fastest16_720p": dict(width=1280, height=720, frames=9, seed=0,
                           chunk=8, over=dict(cu_size=16)),
    "faster16_720p": dict(width=1280, height=720, frames=9, seed=0,
                          chunk=8, over=dict(
                              cu_size=16,
                              performance_mode="FASTER_COMPUTATION")),
    "ibp_fastest16_720p": dict(width=1280, height=720, frames=10, seed=0,
                               chunk=8, push=True,
                               over=dict(cu_size=16, gop_size=2)),
    # the two-process GopPipeline's streams (span 4; the IDR at POC 6 falls
    # inside the second span)
    **{f"mh_ip{ip}_small": dict(width=128, height=64, frames=8, seed=3,
                                chunk=3, per_frame=True, config="plain",
                                over=dict(qp=30, intra_period=ip))
       for ip in (0, 6)},
}

# Runs the JAX package cannot code (it raises TypeError building the
# decoded-QP maps of the quadtree path at CTU 64 under rate control): the
# port's streams are held to libde265 alone
DECODER_RUNS = {
    "cbr64_small": dict(width=192, height=128, frames=10, seed=3, chunk=2,
                        config="ctu64", over=dict(_RC16, bitrate_mode="CBR",
                                                  me_search_range=64)),
    "cbr_full64_small": dict(width=192, height=128, frames=10, seed=3,
                             chunk=2, config="ctu64",
                             over=dict(_RC16, bitrate_mode="CBR",
                                       performance_mode="FULL_COMPUTATION",
                                       me_search_range=64)),
}

# The CLI's reference runs: homer_app.py (the JAX package's CLI) and
# homer_app_torch.py (the port's) on the same .yuv file with the same flags.
# The clip is synth_clip(width, height, frames, seed), the frames from `cut`
# on negatives (a scene cut); `args` are the flags besides -i, -o, -o-raw
# (given where `write_raw`), -widthxheight and -n_frames. The fixture's "cli"
# entry holds, per run, what cli_record reads off the outputs, and whether
# libde265 decodes the JAX CLI's .265 to its own -o-raw file.
CLI_RUNS = {
    # IPPP FASTEST at a size that needs padding, SAO and sign hiding on
    "cli_fastest_small": dict(
        width=120, height=88, frames=5, seed=3, write_raw=True,
        args=("-performance_mode", "3", "-sao", "1", "-sign_hiding", "1",
              "-metrics", "-profiling")),
    # FAST under CBR at 8 kbps, frame by frame: row QPs that differ within
    # a frame, and a scene cut at frame 5
    "cli_cbr_fast_small": dict(
        width=120, height=88, frames=8, seed=3, cut=5, write_raw=True,
        args=("-performance_mode", "1", "-bitrate_mode", "1", "-bitrate",
              "8", "-metrics")),
    # streaming IBP through push_frame / flush (the explicit P at flush)
    "cli_ibp_small": dict(
        width=128, height=96, frames=6, seed=3,
        args=("-gop_size", "2", "-performance_mode", "3", "-profiling")),
    # BASELINE.md configuration 1 at a small size: all-intra, CTU 64, rd FAST
    "cli_allintra64_small": dict(
        width=192, height=128, frames=2, seed=3, write_raw=True,
        args=("-gop_size", "0", "-cu_size", "64", "-rd", "2", "-sao", "0")),
    # CTU 16 in FASTEST (the CLI's default mode, FAST, stays refused there)
    "cli_fastest16_small": dict(
        width=120, height=88, frames=5, seed=3, write_raw=True,
        args=("-cu_size", "16", "-performance_mode", "3", "-sao", "1",
              "-sign_hiding", "1", "-metrics")),
    # BASELINE.md configuration 4 at the reference's default operating point
    # (1250 kbps, rd FAST, SAO and sign hiding), in FASTEST, with a scene cut
    "cli_cbr_scene_fastest_1080p": dict(
        width=1920, height=1080, frames=10, seed=0, cut=5, write_raw=True,
        args=("-performance_mode", "3", "-cu_size", "32", "-search_range",
              "16", "-bitrate_mode", "1", "-bitrate", "1250", "-rd", "2",
              "-sao", "1", "-sign_hiding", "1", "-metrics", "-profiling")),
}

# single P steps of the band-sharded stage: a (lanes, bands) mesh, the
# frames (height x width) of synth_clip(width, height, frame + 1, seed) per
# lane (frame `frame` against frame - 1), QP 32, quarter-pel. "dryrun" is
# the JAX package's own dryrun; "b32_s64" takes the hierarchical search
# (bands of 96 rows, halo 72); in "merge_top" the JAX package's sharded step
# differs from its single-device stage (a band's first block row gets no
# merge candidate from the block row above)
SHARDED_CASES = {
    "dryrun": dict(lanes=2, bands=4, height=128, width=64, B=16, search=8,
                   seeds=(0, 1), frame=1),
    "b32_s16": dict(lanes=2, bands=2, height=128, width=128, B=32,
                    search=16, seeds=(3, 4), frame=1),
    "b32_s64": dict(lanes=2, bands=2, height=192, width=128, B=32,
                    search=64, seeds=(3, 4), frame=1),
    "merge_top": dict(lanes=1, bands=4, height=64, width=128, B=16, search=8,
                      seeds=(0,), frame=1),
}
SHARDED_KEYS = ("mvs", "lev_y", "lev_u", "lev_v", "recon_y", "recon_u",
                "recon_v")


def sharded_frames(name: str):
    """(current, reference) planes of one of SHARDED_CASES: two lists of
    three (lanes, h, w) uint8 arrays (chroma (lanes, h/2, w/2))."""
    c = SHARDED_CASES[name]
    clips = [list(synth_clip(c["width"], c["height"], c["frame"] + 1,
                             seed=s)) for s in c["seeds"]]
    return tuple([np.stack([cl[f][i] for cl in clips]) for i in range(3)]
                 for f in (c["frame"], c["frame"] - 1))


# single frames through encode_frame_intra(split_rdo=True): (width, height,
# tu_depth), the frame is intra_frame(width, height, seed=5)
INTRA_CASES = {
    "96x64_tu1": dict(width=96, height=64, tu_depth=1, seed=5),
    "96x64_tu0": dict(width=96, height=64, tu_depth=0, seed=5),
    "128x96_tu1": dict(width=128, height=96, tu_depth=1, seed=5),
    "128x96_tu0": dict(width=128, height=96, tu_depth=0, seed=5),
}
# single frames through encode_frame_intra at B 16: the split-RDO IDR
# (pass A and pass B) in every rd_mode with and without the TU split, and
# the fixed-CU IDR (FASTEST's, the 35-mode battery per 16-block) in rd_mode
# FULL and FAST; the frame is intra_frame(width, height, seed=5)
INTRA16_CASES = {
    **{f"split_rd{rd}_tu{tu}": dict(width=96, height=64, split=True,
                                    rd_mode=rd, tu_depth=tu, seed=5)
       for rd in (0, 1, 2) for tu in (0, 1)},
    **{f"fixed_rd{rd}": dict(width=96, height=64, split=False, rd_mode=rd,
                             tu_depth=0, seed=5) for rd in (1, 2)},
}
INTRA_KEYS = ("wire", "modes", "mode_units", "depth_units", "part_units",
              "trd_units", "lev_y", "lev_u", "lev_v", "recon_y", "recon_u",
              "recon_v")


def slice_kwargs(width: int, height: int, **over) -> dict:
    """Keywords of the fixed-CU configuration, enums by name, so either
    package can build its own EncoderConfig from them, with `over`
    replacing single settings."""
    kw = dict(width=width, height=height, qp=32, cu_size=32,
              intra_period=100, me_search_range=16, sign_hiding=True,
              deblocking=True, sample_adaptive_offset=True,
              frame_pipeline_depth=2,
              performance_mode="FASTEST_COMPUTATION")
    kw.update(over)
    return kw


def fast_kwargs(width: int, height: int, **over) -> dict:
    """Keywords of the configuration bench.py times (FAST_COMPUTATION,
    search 64), with `over` replacing single settings."""
    kw = slice_kwargs(width, height)
    kw.update(me_search_range=64, performance_mode="FAST_COMPUTATION")
    kw.update(over)
    return kw


def ctu64_kwargs(width: int, height: int, **over) -> dict:
    """Keywords of the JAX package's default configuration (EncoderConfig()
    codes 64x64 CTUs in FAST_COMPUTATION with search 16) under the fixed
    fields above, with `over` replacing single settings."""
    kw = slice_kwargs(width, height)
    kw.update(cu_size=64, performance_mode="FAST_COMPUTATION")
    kw.update(over)
    return kw


def full_kwargs(width: int, height: int, **over) -> dict:
    """Keywords of FULL_COMPUTATION (the inter quadtree down to 8x8 CUs) at
    cu_size 32, search 64, with `over` replacing single settings."""
    return fast_kwargs(width, height, **{
        "performance_mode": "FULL_COMPUTATION", **over})


def plain_kwargs(width: int, height: int, **over) -> dict:
    """Keywords of EncoderConfig's defaults at cu_size 32 (FAST_COMPUTATION,
    search 16, QP 32), with `over` replacing single settings."""
    kw = dict(width=width, height=height, cu_size=32,
              performance_mode="FAST_COMPUTATION")
    kw.update(over)
    return kw


_KWARGS = {None: slice_kwargs, "fast": fast_kwargs, "ctu64": ctu64_kwargs,
           "full": full_kwargs, "plain": plain_kwargs}


def run_spec(name: str) -> dict:
    """The entry of one of RUNS or DECODER_RUNS."""
    return RUNS[name] if name in RUNS else DECODER_RUNS[name]


def run_kwargs(name: str) -> dict:
    """Configuration keywords of one of RUNS or DECODER_RUNS."""
    r = run_spec(name)
    return _KWARGS[r.get("config")](r["width"], r["height"],
                                    **r.get("over", {}))


def config_from(kw: dict) -> EncoderConfig:
    kw = dict(kw)
    kw["performance_mode"] = PerformanceMode[kw["performance_mode"]]
    if "bitrate_mode" in kw:
        kw["bitrate_mode"] = BitrateMode[kw["bitrate_mode"]]
    if "rd_mode" in kw:
        kw["rd_mode"] = RDMode[kw["rd_mode"]]
    return EncoderConfig(**kw)


def slice_config(width: int, height: int) -> EncoderConfig:
    return config_from(slice_kwargs(width, height))


def fast_config(width: int, height: int, **over) -> EncoderConfig:
    return config_from(fast_kwargs(width, height, **over))


def run_config(name: str) -> EncoderConfig:
    return config_from(run_kwargs(name))


def clip(name: str) -> list:
    """The frames [(y, u, v), ...] of one of RUNS, DECODER_RUNS or
    CLI_RUNS, made from its seed; in a run with `cut` = k the frames from k
    on are negatives (255 - sample), a scene cut at frame k."""
    r = CLI_RUNS[name] if name in CLI_RUNS else run_spec(name)
    frames = list(synth_clip(r["width"], r["height"], r["frames"],
                             seed=r["seed"]))
    k = r.get("cut", len(frames))
    return frames[:k] + [tuple(255 - p for p in f) for f in frames[k:]]


def _smooth(rng, h: int, w: int, amp: float, cell: int) -> np.ndarray:
    """Low-pass noise: random values on a coarse grid, bilinearly
    interpolated."""
    g = rng.uniform(-amp, amp, (h // cell + 2, w // cell + 2))
    ys, xs = np.arange(h) / cell, np.arange(w) / cell
    y0, x0 = ys.astype(int), xs.astype(int)
    fy, fx = (ys - y0)[:, None], (xs - x0)[None, :]
    return (g[y0][:, x0] * (1 - fy) * (1 - fx)
            + g[y0][:, x0 + 1] * (1 - fy) * fx
            + g[y0 + 1][:, x0] * fy * (1 - fx)
            + g[y0 + 1][:, x0 + 1] * fy * fx)


def intra_frame(width: int, height: int, seed: int) -> tuple:
    """One (y, u, v) uint8 frame that drives every branch of the split-RDO
    intra quadtree at QP 32: detail grows from left to right (whole 32x32
    CUs, then 16x16 and 8x8 CUs, then NxN leaves in the noise), and a band
    of oblique stripes of drifting contrast, which one directional mode
    predicts the better the nearer its reference samples (TU splits)."""
    rng = np.random.default_rng(seed)
    H, W = height, width
    yy, xx = np.mgrid[:H, :W]
    gain = np.linspace(0, 1, W)[None, :]
    y = (128 + _smooth(rng, H, W, 50, 32) + gain * _smooth(rng, H, W, 70, 4)
         + gain ** 2 * rng.normal(0, 45, (H, W)))
    band = slice(21, 53)
    y[band] = 128 + (40 + 0.4 * xx[band]) * np.sin(
        (xx[band] + 2 * yy[band]) / 5.0)
    u, v = (128 + _smooth(rng, H // 2, W // 2, 25, 8)
            + rng.normal(0, 2, (H // 2, W // 2)) for _ in range(2))
    return tuple(np.clip(np.rint(p), 0, 255).astype(np.uint8)
                 for p in (y, u, v))


def array_digest(a) -> str:
    """SHA-256 of an integer array's values and shape (as little-endian
    int32, whatever type either package holds it in)."""
    a = np.ascontiguousarray(np.asarray(a).astype("<i4"))
    return hashlib.sha256(repr(a.shape).encode() + a.tobytes()).hexdigest()


def au_digest(aus) -> list:
    return [{"sha256": hashlib.sha256(a).hexdigest(), "len": len(a)}
            for a in aus]


def _pad_edge(a: np.ndarray, h: int, w: int) -> np.ndarray:
    """A plane edge-padded to (h, w), as both sessions pad a frame."""
    return np.pad(a, ((0, h - a.shape[0]), (0, w - a.shape[1])), mode="edge")


def encode_run(enc, name: str) -> list:
    """AUs of one of RUNS through an encoder session of either package:
    frame by frame through push_frame and then flush where the run says
    "push", through encode_frame where it says "per_frame", else through
    encode_frames in chunks of its "chunk". A "seeded" run installs its
    first frame, padded, as the reference (seed_reference, poc 1) and codes
    the others."""
    r = run_spec(name)
    frames = clip(name)
    if r.get("seeded"):
        c = enc.cfg
        enc.seed_reference([_pad_edge(p, c.padded_height >> (k > 0),
                                      c.padded_width >> (k > 0))
                            for k, p in enumerate(frames[0])],
                           poc=1, last_idr=0)
        frames = frames[1:]
    if r.get("per_frame"):
        return [enc.encode_frame(*f) for f in frames]
    if not r.get("push"):
        return enc.encode_frames(frames, chunk=r["chunk"])
    aus = []
    for f in frames:
        aus += enc.push_frame(*f)
    return aus + enc.flush()


def decode_check(aus, recon_y):
    """Decode the stream in libde265 and compare its last luma plane with
    `recon_y`: True or False, or None where libde265 does not load."""
    if not de265.available():
        return None
    dec = de265.decode_annexb(b"".join(aus))
    return len(dec) == len(aus) and np.array_equal(dec[-1][0], recon_y)


def write_cli_input(name: str, path: str) -> None:
    """The clip of one of CLI_RUNS as a planar YUV420 file."""
    with open(path, "wb") as f:
        for frame in clip(name):
            for p in frame:
                f.write(np.ascontiguousarray(p).tobytes())


def cli_argv(name: str, yuv: str, out: str, raw: str) -> list:
    """The command line of one of CLI_RUNS (either package's CLI)."""
    r = CLI_RUNS[name]
    return (["-i", yuv, "-o", out] + (["-o-raw", raw] if r.get("write_raw") else [])
            + ["-widthxheight", f"{r['width']}x{r['height']}",
               "-n_frames", str(r["frames"]), *r["args"]])


def _file_digest(path: str):
    """SHA-256 and length of a file, or None where it was not written."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        return None
    return {"sha256": hashlib.sha256(data).hexdigest(), "len": len(data)}


def cli_record(text: str, out: str, raw: str) -> dict:
    """What a CLI run printed and wrote, without its timings: the .265's
    and the -o-raw file's digests, the per-frame lines, the frame count and
    what follows "fps" on the last line, and the profiler's stage names."""
    lines = text.splitlines()
    final = next(ln for ln in lines if " frames in " in ln)
    stages = []
    if "profiler: stage breakdown" in lines:
        for ln in lines[lines.index("profiler: stage breakdown") + 1:]:
            name = ln.split()[0]
            if name == "total":
                break
            stages.append(name)
    return {"stream": _file_digest(out), "raw": _file_digest(raw),
            "lines": [ln for ln in lines if ln.startswith("POC:")],
            "frames": int(final.split()[0]),
            "tail": final.split(" fps", 1)[1], "stages": sorted(stages)}


def cli_decode_check(out: str, raw: str, width: int, height: int):
    """Decode a CLI's .265 in libde265 and compare every picture with the
    -o-raw file: {"match": bool, "decoded": n, "first_diff": [frame,
    plane] or None}, or None where libde265 does not load."""
    if not de265.available():
        return None
    with open(out, "rb") as f:
        dec = de265.decode_annexb(f.read())
    with open(raw, "rb") as f:
        data = np.frombuffer(f.read(), np.uint8)
    shapes = ((height, width), (height // 2, width // 2),
              (height // 2, width // 2))
    fsize = width * height * 3 // 2
    first = None
    for k in range(len(data) // fsize):
        o = k * fsize
        for pi, (h, w) in enumerate(shapes):
            want = data[o:o + h * w].reshape(h, w)
            o += h * w
            if first is None and (k >= len(dec)
                                  or not np.array_equal(dec[k][pi], want)):
                first = [k, pi]
    n = len(data) // fsize
    return {"match": first is None and len(dec) == n, "decoded": len(dec),
            "first_diff": first}
