"""Parameter sets and the slice segment header (H.265 7.3.2, 7.3.6)."""

from __future__ import annotations

import dataclasses
import math

from .bitstream import BitReader


@dataclasses.dataclass
class Params:
    """What the decoder needs of the SPS and PPS."""
    width: int                      # coded size, luma samples
    height: int
    ctb_log2: int
    min_cb_log2: int
    min_tb_log2: int = 2
    max_tb_log2: int = 5
    max_tr_depth_inter: int = 0
    max_tr_depth_intra: int = 0
    amp: bool = False
    sao: bool = False
    strong_intra_smoothing: bool = True
    temporal_mvp: bool = False
    log2_max_poc_lsb: int = 8
    rps: tuple = ((1,),)            # negative deltas of each SPS RPS
    sign_hiding: bool = False
    init_qp: int = 26
    cu_qp_delta: bool = False
    diff_cu_qp_delta_depth: int = 0
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    wpp: bool = False
    deblocking: bool = True
    deblocking_override: bool = False
    beta_offset_div2: int = 0
    tc_offset_div2: int = 0
    loop_filter_across_slices: bool = True
    num_ref_idx_l0: int = 1
    log2_parallel_merge_level: int = 2
    num_extra_slice_header_bits: int = 0
    output_flag_present: bool = False
    cabac_init_present: bool = False
    slice_chroma_qp_offsets_present: bool = False
    conformance: tuple = (0, 0, 0, 0)

    @property
    def ctb(self) -> int:
        return 1 << self.ctb_log2

    @property
    def ctbs(self) -> tuple:
        """(columns, rows) of CTBs."""
        return (-(-self.width // self.ctb), -(-self.height // self.ctb))


def _unsupported(what: str):
    raise NotImplementedError(f"the reference decoder has no {what}")


def _profile_tier_level(br: BitReader, max_sub_layers_minus1: int) -> None:
    br.u(2 + 1 + 5 + 32 + 4 + 43 + 1)      # general profile and flags
    br.u(8)                                # general_level_idc
    if max_sub_layers_minus1:
        _unsupported("sub-layers")


def _st_ref_pic_set(br: BitReader, idx: int) -> tuple:
    if idx != 0 and br.u(1):
        _unsupported("inter RPS prediction")
    n_neg, n_pos = br.ue(), br.ue()
    neg, prev = [], 0
    for _ in range(n_neg):
        prev += br.ue() + 1
        if not br.u(1):
            _unsupported("unused reference pictures")
        neg.append(prev)
    for _ in range(n_pos):
        br.ue()
        br.u(1)
    if n_pos:
        _unsupported("forward references")
    return tuple(neg)


def parse_sps(rbsp: bytes) -> dict:
    br = BitReader(rbsp)
    br.u(4)
    msl = br.u(3)
    br.u(1)
    _profile_tier_level(br, msl)
    br.ue()
    if br.ue() != 1:
        _unsupported("chroma format other than 4:2:0")
    w, h = br.ue(), br.ue()
    conf = (0, 0, 0, 0)
    if br.u(1):
        conf = (br.ue(), br.ue(), br.ue(), br.ue())
    if br.ue() or br.ue():
        _unsupported("bit depth above 8")
    lpoc = br.ue() + 4
    sub = br.u(1)
    for _ in range(0 if sub else msl, msl + 1):
        br.ue()
        br.ue()
        br.ue()
    min_cb = br.ue() + 3
    ctb = min_cb + br.ue()
    min_tb = br.ue() + 2
    max_tb = min_tb + br.ue()
    d_inter, d_intra = br.ue(), br.ue()
    if br.u(1):
        _unsupported("scaling lists")
    amp, sao = bool(br.u(1)), bool(br.u(1))
    if br.u(1):
        _unsupported("PCM")
    rps = tuple(_st_ref_pic_set(br, i) for i in range(br.ue()))
    if br.u(1):
        _unsupported("long-term references")
    tmvp, strong = bool(br.u(1)), bool(br.u(1))
    if br.u(1):
        _unsupported("VUI")
    return dict(width=w, height=h, conformance=conf, log2_max_poc_lsb=lpoc,
                min_cb_log2=min_cb, ctb_log2=ctb, min_tb_log2=min_tb,
                max_tb_log2=max_tb, max_tr_depth_inter=d_inter,
                max_tr_depth_intra=d_intra, amp=amp, sao=sao, rps=rps,
                temporal_mvp=tmvp, strong_intra_smoothing=strong)


def parse_pps(rbsp: bytes) -> dict:
    br = BitReader(rbsp)
    br.ue()
    br.ue()
    if br.u(1):
        _unsupported("dependent slices")
    out = dict(output_flag_present=bool(br.u(1)),
               num_extra_slice_header_bits=br.u(3),
               sign_hiding=bool(br.u(1)), cabac_init_present=bool(br.u(1)))
    out["num_ref_idx_l0"] = br.ue() + 1
    br.ue()
    out["init_qp"] = 26 + br.se()
    if br.u(1):
        _unsupported("constrained intra prediction")
    if br.u(1):
        _unsupported("transform skip")
    out["cu_qp_delta"] = bool(br.u(1))
    if out["cu_qp_delta"]:
        out["diff_cu_qp_delta_depth"] = br.ue()
    out["cb_qp_offset"], out["cr_qp_offset"] = br.se(), br.se()
    out["slice_chroma_qp_offsets_present"] = bool(br.u(1))
    if br.u(1) or br.u(1):
        _unsupported("weighted prediction")
    if br.u(1):
        _unsupported("transquant bypass")
    if br.u(1):
        _unsupported("tiles")
    out["wpp"] = bool(br.u(1))
    out["loop_filter_across_slices"] = bool(br.u(1))
    if br.u(1):                                   # deblocking control
        out["deblocking_override"] = bool(br.u(1))
        out["deblocking"] = not br.u(1)
        if out["deblocking"]:
            out["beta_offset_div2"], out["tc_offset_div2"] = br.se(), br.se()
    if br.u(1):
        _unsupported("PPS scaling lists")
    if br.u(1):
        _unsupported("reference list modification")
    out["log2_parallel_merge_level"] = br.ue() + 2
    if br.u(1):
        _unsupported("slice header extensions")
    return out


@dataclasses.dataclass
class SliceHeader:
    slice_type: int                 # 0 B, 1 P, 2 I
    qp: int
    poc_lsb: int = 0
    rps: tuple = ()
    sao_luma: bool = False
    sao_chroma: bool = False
    max_merge_cand: int = 5
    num_ref_idx_l0: int = 1
    deblocking: bool = True
    beta_offset_div2: int = 0
    tc_offset_div2: int = 0
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    entry_points: tuple = ()
    data_byte: int = 0              # RBSP byte where slice data starts


def parse_slice_header(rbsp: bytes, nal_type: int, p: Params) -> SliceHeader:
    br = BitReader(rbsp)
    if not br.u(1):
        _unsupported("more than one slice per picture")
    if 16 <= nal_type <= 23:
        br.u(1)
    br.ue()
    br.u(p.num_extra_slice_header_bits)
    st = br.ue()
    if p.output_flag_present:
        br.u(1)
    sh = SliceHeader(slice_type=st, qp=0)
    idr = nal_type in (19, 20)
    if not idr:
        sh.poc_lsb = br.u(p.log2_max_poc_lsb)
        if br.u(1):
            n = len(p.rps)
            idx = br.u(math.ceil(math.log2(n))) if n > 1 else 0
            sh.rps = p.rps[idx]
        else:
            sh.rps = _st_ref_pic_set(br, len(p.rps))
        if p.temporal_mvp and br.u(1):
            _unsupported("temporal motion vector prediction")
    if p.sao:
        sh.sao_luma, sh.sao_chroma = bool(br.u(1)), bool(br.u(1))
    if st in (0, 1):
        sh.num_ref_idx_l0 = p.num_ref_idx_l0
        if br.u(1):
            sh.num_ref_idx_l0 = br.ue() + 1
            if st == 0:
                br.ue()
        if st == 0:
            _unsupported("B slices")
        if p.cabac_init_present and br.u(1):
            _unsupported("cabac_init_flag")
        sh.max_merge_cand = 5 - br.ue()
    sh.qp = p.init_qp + br.se()
    if p.slice_chroma_qp_offsets_present:
        sh.cb_qp_offset, sh.cr_qp_offset = br.se(), br.se()
    sh.deblocking = p.deblocking
    sh.beta_offset_div2, sh.tc_offset_div2 = (p.beta_offset_div2,
                                              p.tc_offset_div2)
    if p.deblocking_override and br.u(1):
        sh.deblocking = not br.u(1)
        if sh.deblocking:
            sh.beta_offset_div2, sh.tc_offset_div2 = br.se(), br.se()
    if p.loop_filter_across_slices and (sh.sao_luma or sh.sao_chroma
                                        or sh.deblocking):
        br.u(1)
    if p.wpp:
        n = br.ue()
        if n:
            bits = br.ue() + 1
            sh.entry_points = tuple(br.u(bits) + 1 for _ in range(n))
    if br.u(1) != 1:
        raise ValueError("slice header: byte_alignment() lacks its 1 bit")
    while not br.byte_aligned():
        if br.u(1):
            raise ValueError("slice header: byte_alignment() bit not 0")
    sh.data_byte = br.pos // 8
    return sh
