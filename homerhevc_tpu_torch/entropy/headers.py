"""VPS / SPS / PPS / slice-segment-header writers (spec 7.3.2, 7.3.6).

Role of the reference's hmr_headers.c
(homer_lib/hmr_headers.c:99/204/312/375), re-written
directly from ITU-T H.265 syntax tables.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from .bitstream import BitWriter

# Slice types (spec 7.4.7.1).
SLICE_B, SLICE_P, SLICE_I = 0, 1, 2

LOG2_MAX_POC_LSB = 8  # log2_max_pic_order_cnt_lsb_minus4 = 4


@dataclass
class StRefPicSet:
    """Short-term RPS (spec 7.3.7): past (negative) and future (positive)
    reference deltas — positives are used by B pictures (IBP GOP)."""
    delta_pocs: tuple = (1,)           # positive magnitudes of negative deltas
    used: tuple = (True,)
    pos_delta_pocs: tuple = ()         # magnitudes of positive deltas
    pos_used: tuple = ()


@dataclass
class StreamParams:
    """Everything the header writers need; derived from EncoderConfig."""
    width: int
    height: int
    pad_right: int = 0
    pad_bottom: int = 0
    ctu_log2: int = 6
    min_cu_log2: int = 3
    min_tu_log2: int = 2
    max_tu_log2: int = 5
    max_tr_depth_intra: int = 0
    max_tr_depth_inter: int = 0
    sao_enabled: bool = False
    sign_hiding: bool = False
    deblocking_disabled: bool = True
    wpp_enabled: bool = False
    init_qp: int = 32
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    num_ref_frames: int = 1
    rps_list: tuple = (StRefPicSet(),)
    amp_enabled: bool = False
    strong_intra_smoothing: bool = True
    temporal_mvp: bool = False
    cu_qp_delta_enabled: bool = False
    cu_qp_delta_depth: int = 0
    num_reorder_pics: int = 0          # 1 when B pictures are present


def _profile_tier_level(bw: BitWriter, params: StreamParams) -> None:
    """profile_tier_level() with maxNumSubLayersMinus1 = 0 (spec 7.3.3)."""
    bw.write(0, 2)            # general_profile_space
    bw.write(0, 1)            # general_tier_flag (Main tier)
    bw.write(1, 5)            # general_profile_idc = Main
    compat = 1 << (31 - 1)    # compatibility flag[1] (Main)
    bw.write(compat, 32)
    bw.write(1, 1)            # general_progressive_source_flag
    bw.write(0, 1)            # general_interlaced_source_flag
    bw.write(0, 1)            # general_non_packed_constraint_flag
    bw.write(1, 1)            # general_frame_only_constraint_flag
    bw.write(0, 44)           # general_reserved_zero_44bits
    # Level: 3.1 covers 720p, 4.1 covers 1080p, 5.0 beyond.
    pixels = params.width * params.height
    level = 93 if pixels <= 983040 else (123 if pixels <= 2228224 else 150)
    bw.write(level, 8)


def write_vps(params: StreamParams) -> bytes:
    bw = BitWriter()
    bw.write(0, 4)            # vps_video_parameter_set_id
    bw.write(3, 2)            # base_layer_internal/available flags
    bw.write(0, 6)            # vps_max_layers_minus1
    bw.write(0, 3)            # vps_max_sub_layers_minus1
    bw.write(1, 1)            # vps_temporal_id_nesting_flag
    bw.write(0xFFFF, 16)      # vps_reserved_0xffff_16bits
    _profile_tier_level(bw, params)
    bw.write(1, 1)            # vps_sub_layer_ordering_info_present_flag
    bw.write_ue(params.num_ref_frames + params.num_reorder_pics)
    bw.write_ue(params.num_reorder_pics)  # vps_max_num_reorder_pics
    bw.write_ue(0)            # vps_max_latency_increase_plus1
    bw.write(0, 6)            # vps_max_layer_id
    bw.write_ue(0)            # vps_num_layer_sets_minus1
    bw.write(0, 1)            # vps_timing_info_present_flag
    bw.write(0, 1)            # vps_extension_flag
    bw.rbsp_trailing_bits()
    return bw.get_bytes()


def _write_st_ref_pic_set(bw: BitWriter, rps: StRefPicSet, idx: int) -> None:
    """st_ref_pic_set() (spec 7.3.7)."""
    if idx != 0:
        bw.write(0, 1)        # inter_ref_pic_set_prediction_flag
    bw.write_ue(len(rps.delta_pocs))   # num_negative_pics
    bw.write_ue(len(rps.pos_delta_pocs))  # num_positive_pics
    prev = 0
    for d, u in zip(rps.delta_pocs, rps.used):
        bw.write_ue(d - prev - 1)       # delta_poc_s0_minus1
        bw.write_flag(u)                # used_by_curr_pic_s0_flag
        prev = d
    prev = 0
    for d, u in zip(rps.pos_delta_pocs, rps.pos_used):
        bw.write_ue(d - prev - 1)       # delta_poc_s1_minus1
        bw.write_flag(u)                # used_by_curr_pic_s1_flag
        prev = d


def write_sps(params: StreamParams) -> bytes:
    bw = BitWriter()
    bw.write(0, 4)            # sps_video_parameter_set_id
    bw.write(0, 3)            # sps_max_sub_layers_minus1
    bw.write(1, 1)            # sps_temporal_id_nesting_flag
    _profile_tier_level(bw, params)
    bw.write_ue(0)            # sps_seq_parameter_set_id
    bw.write_ue(1)            # chroma_format_idc = 4:2:0
    bw.write_ue(params.width + params.pad_right)
    bw.write_ue(params.height + params.pad_bottom)
    if params.pad_right or params.pad_bottom:
        bw.write(1, 1)        # conformance_window_flag
        bw.write_ue(0)                        # left (units of SubWidthC=2)
        bw.write_ue(params.pad_right // 2)    # right
        bw.write_ue(0)                        # top
        bw.write_ue(params.pad_bottom // 2)   # bottom
    else:
        bw.write(0, 1)
    bw.write_ue(0)            # bit_depth_luma_minus8
    bw.write_ue(0)            # bit_depth_chroma_minus8
    bw.write_ue(LOG2_MAX_POC_LSB - 4)  # log2_max_pic_order_cnt_lsb_minus4
    bw.write(1, 1)            # sps_sub_layer_ordering_info_present_flag
    bw.write_ue(params.num_ref_frames + params.num_reorder_pics)
    bw.write_ue(params.num_reorder_pics)  # sps_max_num_reorder_pics
    bw.write_ue(0)            # sps_max_latency_increase_plus1
    bw.write_ue(params.min_cu_log2 - 3)  # log2_min_luma_coding_block_size_minus3
    bw.write_ue(params.ctu_log2 - params.min_cu_log2)
    bw.write_ue(params.min_tu_log2 - 2)  # log2_min_luma_transform_block_size_minus2
    bw.write_ue(params.max_tu_log2 - params.min_tu_log2)
    bw.write_ue(params.max_tr_depth_inter)
    bw.write_ue(params.max_tr_depth_intra)
    bw.write(0, 1)            # scaling_list_enabled_flag
    bw.write_flag(params.amp_enabled)
    bw.write_flag(params.sao_enabled)
    bw.write(0, 1)            # pcm_enabled_flag
    bw.write_ue(len(params.rps_list))   # num_short_term_ref_pic_sets
    for i, rps in enumerate(params.rps_list):
        _write_st_ref_pic_set(bw, rps, i)
    bw.write(0, 1)            # long_term_ref_pics_present_flag
    bw.write_flag(params.temporal_mvp)  # sps_temporal_mvp_enabled_flag
    bw.write_flag(params.strong_intra_smoothing)
    bw.write(0, 1)            # vui_parameters_present_flag
    bw.write(0, 1)            # sps_extension_flag
    bw.rbsp_trailing_bits()
    return bw.get_bytes()


def write_pps(params: StreamParams) -> bytes:
    bw = BitWriter()
    bw.write_ue(0)            # pps_pic_parameter_set_id
    bw.write_ue(0)            # pps_seq_parameter_set_id
    bw.write(0, 1)            # dependent_slice_segments_enabled_flag
    bw.write(0, 1)            # output_flag_present_flag
    bw.write(0, 3)            # num_extra_slice_header_bits
    bw.write_flag(params.sign_hiding)   # sign_data_hiding_enabled_flag
    bw.write(0, 1)            # cabac_init_present_flag
    bw.write_ue(0)            # num_ref_idx_l0_default_active_minus1
    bw.write_ue(0)            # num_ref_idx_l1_default_active_minus1
    bw.write_se(params.init_qp - 26)    # init_qp_minus26
    bw.write(0, 1)            # constrained_intra_pred_flag
    bw.write(0, 1)            # transform_skip_enabled_flag
    bw.write_flag(params.cu_qp_delta_enabled)
    if params.cu_qp_delta_enabled:
        bw.write_ue(params.cu_qp_delta_depth)
    bw.write_se(params.cb_qp_offset)
    bw.write_se(params.cr_qp_offset)
    bw.write(0, 1)            # pps_slice_chroma_qp_offsets_present_flag
    bw.write(0, 1)            # weighted_pred_flag
    bw.write(0, 1)            # weighted_bipred_flag
    bw.write(0, 1)            # transquant_bypass_enabled_flag
    bw.write(0, 1)            # tiles_enabled_flag
    bw.write_flag(params.wpp_enabled)   # entropy_coding_sync_enabled_flag
    bw.write(1, 1)            # pps_loop_filter_across_slices_enabled_flag
    if params.deblocking_disabled:
        bw.write(1, 1)        # deblocking_filter_control_present_flag
        bw.write(0, 1)        # deblocking_filter_override_enabled_flag
        bw.write(1, 1)        # pps_deblocking_filter_disabled_flag
    else:
        bw.write(0, 1)        # deblocking_filter_control_present_flag
    bw.write(0, 1)            # pps_scaling_list_data_present_flag
    bw.write(0, 1)            # lists_modification_present_flag
    bw.write_ue(0)            # log2_parallel_merge_level_minus2
    bw.write(0, 1)            # slice_segment_header_extension_present_flag
    bw.write(0, 1)            # pps_extension_flag
    bw.rbsp_trailing_bits()
    return bw.get_bytes()


def write_slice_header(params: StreamParams, *, slice_type: int, is_idr: bool,
                       is_irap: bool, poc: int, slice_qp: int,
                       rps_idx: int = 0,
                       sao_luma: bool = False, sao_chroma: bool = False,
                       num_entry_points: int = 0,
                       entry_point_offsets: list | None = None,
                       max_merge_cand: int = 5) -> BitWriter:
    """Slice segment header (spec 7.3.6.1). Returns the (aligned) BitWriter so
    the caller can append CABAC slice data."""
    bw = BitWriter()
    bw.write(1, 1)            # first_slice_segment_in_pic_flag
    if is_irap:
        bw.write(0, 1)        # no_output_of_prior_pics_flag
    bw.write_ue(0)            # slice_pic_parameter_set_id
    bw.write_ue(slice_type)
    if not is_idr:
        bw.write(poc % (1 << LOG2_MAX_POC_LSB), LOG2_MAX_POC_LSB)
        bw.write(1, 1)        # short_term_ref_pic_set_sps_flag
        n = len(params.rps_list)
        if n > 1:
            bw.write(rps_idx, max(1, math.ceil(math.log2(n))))
        if params.temporal_mvp:
            bw.write(1, 1)    # slice_temporal_mvp_enabled_flag
    if params.sao_enabled:
        bw.write_flag(sao_luma)
        bw.write_flag(sao_chroma)
    if slice_type in (SLICE_P, SLICE_B):
        bw.write(0, 1)        # num_ref_idx_active_override_flag
        if slice_type == SLICE_B:
            bw.write(0, 1)    # mvd_l1_zero_flag
        if params.temporal_mvp:
            if slice_type == SLICE_B:
                bw.write(1, 1)  # collocated_from_l0_flag
        bw.write_ue(5 - max_merge_cand)  # five_minus_max_num_merge_cand
    bw.write_se(slice_qp - params.init_qp)  # slice_qp_delta
    if sao_luma or sao_chroma or not params.deblocking_disabled:
        bw.write(1, 1)        # slice_loop_filter_across_slices_enabled_flag
    if params.wpp_enabled:
        bw.write_ue(num_entry_points)
        if num_entry_points:
            offsets = entry_point_offsets or []
            assert len(offsets) == num_entry_points
            length = max(1, max((o - 1).bit_length() for o in offsets))
            bw.write_ue(length - 1)
            for o in offsets:
                bw.write(o - 1, length)
    # byte_alignment() (spec 7.3.2.12): one '1' bit, then '0' bits to align.
    bw.write(1, 1)
    bw.align_zero()
    return bw
