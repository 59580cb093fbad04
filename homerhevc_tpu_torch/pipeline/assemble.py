"""Stream assembly: headers + CABAC slice data -> Annex-B bytes.

Port of homerhevc_tpu/pipeline/assemble.py (host code, numpy only).

Role of the reference's engine output stage (hmr_encoder_lib.c:3285-3330:
VPS/SPS/PPS on IDR, slice header, substream concat, EBSP, NAL framing).
"""

from __future__ import annotations

import numpy as np

from ..entropy import bitstream as bs
from ..entropy import headers, native_backend
from ..entropy.cabac import CabacEncoder, ContextSet
from ..entropy.syntax import SliceSyntaxEncoder


def encode_slice_data(params: headers.StreamParams, plans, *, slice_qp: int,
                      slice_type: int = headers.SLICE_I,
                      pic_width: int | None = None,
                      pic_height: int | None = None,
                      max_merge_cand: int = 5,
                      native: bool | None = None,
                      sao_info: dict | None = None) -> bytes:
    """CABAC-encode all CTUs of one slice into slice-data bytes.

    native=None (default) or True: the C++ backend (byte-identical to the
    Python path, ~60x faster; a failed build of libhenc raises); False
    forces the Python oracle.
    """
    if native is None or native:
        maps = native_backend.frame_maps_from_plans(
            plans, params.width + params.pad_right,
            params.height + params.pad_bottom, 1 << params.ctu_log2)
        return native_backend.encode_slice_from_maps(
            params, maps, slice_qp=slice_qp, slice_type=slice_type,
            max_merge_cand=max_merge_cand, wpp=params.wpp_enabled,
            sao_info=sao_info)
    if params.wpp_enabled:
        return encode_slice_data_wpp(params, plans, slice_qp=slice_qp,
                                     slice_type=slice_type,
                                     max_merge_cand=max_merge_cand,
                                     sao_info=sao_info)
    bw = bs.BitWriter()
    init_type = {headers.SLICE_I: 0, headers.SLICE_P: 1, headers.SLICE_B: 2}[slice_type]
    ctxs = ContextSet(init_type, slice_qp)
    enc = CabacEncoder(bw)
    syn = SliceSyntaxEncoder(
        enc, ctxs,
        pic_width=pic_width or (params.width + params.pad_right),
        pic_height=pic_height or (params.height + params.pad_bottom),
        ctu_log2=params.ctu_log2,
        min_cu_log2=params.min_cu_log2,
        max_tr_depth_intra=params.max_tr_depth_intra,
        max_tr_depth_inter=params.max_tr_depth_inter,
        sign_hiding=params.sign_hiding,
        slice_type=slice_type,
        max_merge_cand=max_merge_cand, sao_info=sao_info,
        cu_qp_delta_enabled=params.cu_qp_delta_enabled, slice_qp=slice_qp,
        wpp=False)
    for i, plan in enumerate(plans):
        syn.encode_ctu(plan, is_last=(i == len(plans) - 1))
    bw.align_zero()   # after terminate(1) flush the stream is aligned... pad
    return bw.get_bytes()


def encode_slice_data_wpp(params: headers.StreamParams, plans, *,
                          slice_qp: int,
                          slice_type: int = headers.SLICE_I,
                          max_merge_cand: int = 5,
                          sao_info: dict | None = None):
    """Python-oracle WPP slice data: per-CTU-row byte-aligned substreams
    with context sync from the above-right CTU (spec 9.3.2.2; role of
    wfpp_encode_select_bitstream / ee_copy_entropy_model,
    hmr_encoder_lib.c:2299-2383). Returns (bytes, substream_sizes)."""
    pic_w = params.width + params.pad_right
    pic_h = params.height + params.pad_bottom
    ctu = 1 << params.ctu_log2
    nx, ny = pic_w // ctu, -(-pic_h // ctu)
    init_type = {headers.SLICE_I: 0, headers.SLICE_P: 1,
                 headers.SLICE_B: 2}[slice_type]
    ctxs = ContextSet(init_type, slice_qp)
    init_copy = ctxs.copy()
    bw = bs.BitWriter()
    enc = CabacEncoder(bw)
    syn = SliceSyntaxEncoder(
        enc, ctxs, pic_width=pic_w, pic_height=pic_h,
        ctu_log2=params.ctu_log2, min_cu_log2=params.min_cu_log2,
        max_tr_depth_intra=params.max_tr_depth_intra,
        max_tr_depth_inter=params.max_tr_depth_inter,
        sign_hiding=params.sign_hiding, slice_type=slice_type,
        max_merge_cand=max_merge_cand, sao_info=sao_info,
        cu_qp_delta_enabled=params.cu_qp_delta_enabled, slice_qp=slice_qp,
        wpp=True)
    snapshot = None
    sizes = []
    prev = 0
    for r in range(ny):
        if r > 0:
            ctxs.load(snapshot if (nx > 1 and snapshot) else init_copy)
            enc = CabacEncoder(bw)
            syn.enc = enc
        for c in range(nx):
            last = r == ny - 1 and c == nx - 1
            syn.encode_ctu(plans[r * nx + c], is_last=last)
            if c == 1:
                snapshot = ctxs.copy()
            if c == nx - 1 and not last:
                enc.encode_terminate(1)      # end_of_subset_one_bit
        bw.align_zero()
        total = bw.bit_count // 8
        sizes.append(total - prev)
        prev = total
    return bw.get_bytes(), sizes


def _wpp_slice_header(params, data, sizes, *, slice_type, is_idr, is_irap,
                      poc, slice_qp, max_merge_cand=5, sao_info=None,
                      rps_idx=0):
    bounds = [0]
    for s in sizes:
        bounds.append(bounds[-1] + s)
    esc = bs.ebsp_segment_sizes(data, bounds)
    offsets = esc[:-1]
    return headers.write_slice_header(
        params, slice_type=slice_type, is_idr=is_idr, is_irap=is_irap,
        poc=poc, slice_qp=slice_qp, max_merge_cand=max_merge_cand,
        num_entry_points=len(offsets), entry_point_offsets=offsets,
        rps_idx=rps_idx, **_sao_flags(sao_info))


def _sao_flags(sao_info):
    if sao_info is None:
        return {}
    return dict(sao_luma=bool(sao_info.get("sao_luma", True)),
                sao_chroma=bool(sao_info.get("sao_chroma", True)))


def assemble_idr_au(params: headers.StreamParams, plans, *, slice_qp: int,
                    include_parameter_sets: bool = True,
                    sao_info: dict | None = None) -> bytes:
    """Build one IDR access unit (optionally VPS+SPS+PPS first)."""
    out = bytearray()
    if include_parameter_sets:
        out += bs.annexb_wrap(bs.nal_unit(bs.NAL_VPS, headers.write_vps(params)), True)
        out += bs.annexb_wrap(bs.nal_unit(bs.NAL_SPS, headers.write_sps(params)), True)
        out += bs.annexb_wrap(bs.nal_unit(bs.NAL_PPS, headers.write_pps(params)), True)
    if params.wpp_enabled:
        data, sizes = encode_slice_data(params, plans, slice_qp=slice_qp,
                                        sao_info=sao_info)
        sh = _wpp_slice_header(params, data, sizes,
                               slice_type=headers.SLICE_I, is_idr=True,
                               is_irap=True, poc=0, slice_qp=slice_qp,
                               sao_info=sao_info)
        slice_payload = sh.get_bytes() + data
    else:
        sh = headers.write_slice_header(
            params, slice_type=headers.SLICE_I, is_idr=True, is_irap=True,
            poc=0, slice_qp=slice_qp, **_sao_flags(sao_info))
        slice_payload = sh.get_bytes() + encode_slice_data(
            params, plans, slice_qp=slice_qp, sao_info=sao_info)
    out += bs.annexb_wrap(bs.nal_unit(bs.NAL_IDR_W_RADL, slice_payload), True)
    return bytes(out)


def assemble_p_au(params: headers.StreamParams, plans, *, poc: int,
                  slice_qp: int, max_merge_cand: int = 5,
                  sao_info: dict | None = None, slice_type=headers.SLICE_P,
                  rps_idx: int = 0) -> bytes:
    """Build one P or B (TRAIL_R) access unit."""
    if params.wpp_enabled:
        data, sizes = encode_slice_data(
            params, plans, slice_qp=slice_qp, slice_type=slice_type,
            max_merge_cand=max_merge_cand, sao_info=sao_info)
        sh = _wpp_slice_header(params, data, sizes,
                               slice_type=slice_type, is_idr=False,
                               is_irap=False, poc=poc, slice_qp=slice_qp,
                               max_merge_cand=max_merge_cand,
                               sao_info=sao_info, rps_idx=rps_idx)
        payload = sh.get_bytes() + data
    else:
        sh = headers.write_slice_header(
            params, slice_type=slice_type, is_idr=False, is_irap=False,
            poc=poc, slice_qp=slice_qp, max_merge_cand=max_merge_cand,
            rps_idx=rps_idx, **_sao_flags(sao_info))
        payload = sh.get_bytes() + encode_slice_data(
            params, plans, slice_qp=slice_qp, slice_type=slice_type,
            max_merge_cand=max_merge_cand, sao_info=sao_info)
    return bs.annexb_wrap(bs.nal_unit(bs.NAL_TRAIL_R, payload), True)


def assemble_idr_au_from_maps(params: headers.StreamParams, maps: dict, *,
                              slice_qp: int,
                              include_parameter_sets: bool = True,
                              sao_info: dict | None = None) -> bytes:
    """IDR AU via the native maps fast path (no per-CTU plan objects)."""
    out = bytearray()
    if include_parameter_sets:
        out += bs.annexb_wrap(bs.nal_unit(bs.NAL_VPS, headers.write_vps(params)), True)
        out += bs.annexb_wrap(bs.nal_unit(bs.NAL_SPS, headers.write_sps(params)), True)
        out += bs.annexb_wrap(bs.nal_unit(bs.NAL_PPS, headers.write_pps(params)), True)
    if params.wpp_enabled:
        data, sizes = native_backend.encode_slice_from_maps(
            params, maps, slice_qp=slice_qp, slice_type=headers.SLICE_I,
            wpp=True, sao_info=sao_info)
        sh = _wpp_slice_header(params, data, sizes,
                               slice_type=headers.SLICE_I, is_idr=True,
                               is_irap=True, poc=0, slice_qp=slice_qp,
                               sao_info=sao_info)
    else:
        data = native_backend.encode_slice_from_maps(
            params, maps, slice_qp=slice_qp, slice_type=headers.SLICE_I,
            sao_info=sao_info)
        sh = headers.write_slice_header(
            params, slice_type=headers.SLICE_I, is_idr=True, is_irap=True,
            poc=0, slice_qp=slice_qp, **_sao_flags(sao_info))
    out += bs.annexb_wrap(bs.nal_unit(bs.NAL_IDR_W_RADL,
                                      sh.get_bytes() + data), True)
    return bytes(out)


def assemble_p_au_from_maps(params: headers.StreamParams, maps: dict, *,
                            poc: int, slice_qp: int, max_merge_cand: int = 5,
                            sao_info: dict | None = None,
                            rps_idx: int = 0) -> bytes:
    """P AU via the native maps fast path."""
    if params.wpp_enabled:
        data, sizes = native_backend.encode_slice_from_maps(
            params, maps, slice_qp=slice_qp, slice_type=headers.SLICE_P,
            max_merge_cand=max_merge_cand, wpp=True, sao_info=sao_info)
        sh = _wpp_slice_header(params, data, sizes,
                               slice_type=headers.SLICE_P, is_idr=False,
                               is_irap=False, poc=poc, slice_qp=slice_qp,
                               max_merge_cand=max_merge_cand,
                               sao_info=sao_info, rps_idx=rps_idx)
    else:
        data = native_backend.encode_slice_from_maps(
            params, maps, slice_qp=slice_qp, slice_type=headers.SLICE_P,
            max_merge_cand=max_merge_cand, sao_info=sao_info)
        sh = headers.write_slice_header(
            params, slice_type=headers.SLICE_P, is_idr=False, is_irap=False,
            poc=poc, slice_qp=slice_qp, max_merge_cand=max_merge_cand,
            rps_idx=rps_idx, **_sao_flags(sao_info))
    return bs.annexb_wrap(bs.nal_unit(bs.NAL_TRAIL_R,
                                      sh.get_bytes() + data), True)
