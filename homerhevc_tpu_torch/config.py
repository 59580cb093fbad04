"""Encoder configuration (the port's own copy of homerhevc_tpu/config.py:
the same fields, enums and validation, so one keyword dictionary builds an
equal configuration in either package).

Python-idiomatic equivalent of the reference's flat config struct
(``HVENC_Cfg``, homer_lib/homer_hevc_enc_api.h:138-167)
plus its enums (:46-89). Validation/clipping mirrors the semantics of
``HOMER_enc_control(HOMER_SETCFG)`` (hmr_encoder_lib.c:740-746, 992-1012).
"""

from __future__ import annotations

import dataclasses
import enum


class Profile(enum.IntEnum):
    MAIN = 1
    MAIN10 = 2


class RDMode(enum.IntEnum):
    DIST_ONLY = 0
    FULL = 1
    FAST = 2


class BitrateMode(enum.IntEnum):
    FIXED_QP = 0
    CBR = 1
    VBR = 2


class PerformanceMode(enum.IntEnum):
    FULL_COMPUTATION = 0
    FAST_COMPUTATION = 1
    FASTER_COMPUTATION = 2
    FASTEST_COMPUTATION = 3


class ImageType(enum.IntEnum):
    AUTO = 0
    B = 1
    P = 2
    I = 3


class MEPrecision(enum.IntEnum):
    PEL = 0
    HALF_PEL = 1
    QUARTER_PEL = 2


@dataclasses.dataclass
class EncoderConfig:
    width: int = 1280
    height: int = 720
    frame_rate: float = 25.0
    profile: Profile = Profile.MAIN

    # Coding structure.
    cu_size: int = 64                 # CTU size: 16, 32 or 64
    max_pred_partition_depth: int = 4  # CU quadtree depth (1..4)
    max_intra_tr_depth: int = 1       # residual-quadtree depth for intra
    max_inter_tr_depth: int = 1       # residual-quadtree depth for inter
    intra_period: int = 100           # distance between I frames (0 = first only)
    gop_size: int = 0                 # 0 = IPPP..., >=2 enables B frames
    num_b: int = 0
    num_ref_frames: int = 1
    motion_estimation_precision: MEPrecision = MEPrecision.QUARTER_PEL
    me_search_range: int = 16         # integer-pel window radius; > 24 uses
                                      # the hierarchical coarse+refine search

    # Rate control.
    qp: int = 32
    chroma_qp_offset: int = 0
    bitrate_mode: BitrateMode = BitrateMode.FIXED_QP
    bitrate: int = 1250               # kbps (CBR/VBR)
    vbv_size: int = 1500              # kbps
    vbv_init: int = 750               # kbps
    reinit_gop_on_scene_change: bool = True

    # Tools.
    sign_hiding: bool = True
    sample_adaptive_offset: bool = True
    deblocking: bool = True
    # Intra RD depth (reference HOMER_RD_MODES, homer_hevc_enc_api.h:60-64).
    # Default FULL: the batched device battery makes the all-35-mode search
    # nearly free, unlike the reference's scalar loop where FAST is the
    # default. FAST = 11-candidate battery + angular refinement; DIST_ONLY
    # = pure-distortion decisions (lambda = 0 in the search).
    rd_mode: RDMode = RDMode.FULL
    performance_mode: PerformanceMode = PerformanceMode.FAST_COMPUTATION

    # WPP: entropy_coding_sync per-CTU-row substreams (reference default on,
    # wfpp_num_threads=10, homer_app.c:320).
    wpp: bool = False

    # Parallelism (devices): replaces wfpp_num_threads / num_enc_engines.
    # Number of devices over which CTU rows are sharded within a frame, and
    # number of frames encoded in a pipelined fashion across the mesh.
    wpp_shards: int = 1
    frame_pipeline_depth: int = 1

    # Internal.
    bit_depth: int = 8

    def validate(self) -> "EncoderConfig":
        cfg = dataclasses.replace(self)
        if cfg.cu_size not in (16, 32, 64):
            raise ValueError(f"cu_size must be 16/32/64, got {cfg.cu_size}")
        max_depth = {64: 4, 32: 3, 16: 2}[cfg.cu_size]
        cfg.max_pred_partition_depth = min(max(cfg.max_pred_partition_depth, 1), max_depth)
        # 0 disables the residual quadtree (TU = CU); the RD search itself
        # currently evaluates one split level (depth 1)
        cfg.max_intra_tr_depth = min(max(cfg.max_intra_tr_depth, 0), 4)
        cfg.max_inter_tr_depth = min(max(cfg.max_inter_tr_depth, 0), 4)
        cfg.qp = min(max(cfg.qp, 0), 51)
        if cfg.width % 2 or cfg.height % 2:
            raise ValueError("width/height must be even for YUV420")
        if cfg.num_ref_frames < 1:
            cfg.num_ref_frames = 1
        # ME window vs reference-plane padding (pipeline/p_golden.PAD=72):
        # dense sweep (<=24) and hierarchical coarse+refine (<=64, 4-aligned)
        # both need MC support (search + 8-tap) inside the pad — reject
        # ranges that would silently read wrapped/clamped reference pixels.
        if cfg.me_search_range < 1 or cfg.me_search_range > 64:
            raise ValueError(
                f"me_search_range must be in 1..64, got {cfg.me_search_range}")
        if cfg.me_search_range > 24 and cfg.me_search_range % 4:
            raise ValueError("me_search_range > 24 (hierarchical search) "
                             "must be a multiple of 4")
        return cfg

    # --- Derived geometry -------------------------------------------------
    @property
    def ctu_size(self) -> int:
        return self.cu_size

    @property
    def pic_width_in_ctus(self) -> int:
        return -(-self.width // self.ctu_size)

    @property
    def pic_height_in_ctus(self) -> int:
        return -(-self.height // self.ctu_size)

    @property
    def padded_width(self) -> int:
        return self.pic_width_in_ctus * self.ctu_size

    @property
    def padded_height(self) -> int:
        return self.pic_height_in_ctus * self.ctu_size
