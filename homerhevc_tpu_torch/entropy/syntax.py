"""HEVC slice-data syntax writer: coding quadtree, intra modes, transform
tree, residual coding (ITU-T H.265 7.3.8, ctx derivations 9.3.4.2).

Role of the reference's hmr_arithmetic_encoding.c
(homer_lib/hmr_arithmetic_encoding.c:391-2126), written
from the spec. Operates on dense per-CTU "plans" (numpy arrays produced by
the device pipeline): a depth map, mode maps, and spatially-laid-out
quantised coefficients — the device-side analog of the reference's ctu_info_t
4x4-granular attribute arrays (hmr_private.h:792-843).

This Python implementation is the correctness oracle; the native C++ backend
(entropy/native) implements the same walk for production speed.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import tables
from .cabac import OFF, CabacEncoder, ContextSet
from .headers import SLICE_B, SLICE_I

# ctxIdxMap for 4x4 sig_coeff_flag (spec 9.3.4.2.5).
_SIG_CTX_MAP_4X4 = np.array([0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8],
                            dtype=np.int32)

INTRA_PLANAR, INTRA_DC, INTRA_HOR, INTRA_VER = 0, 1, 10, 26


@dataclass
class CtuPlan:
    """Dense description of one coded CTU.

    All unit-granular maps are (units, units) where units = ctu_size // 4,
    matching the reference's 4x4-granularity bookkeeping. Inter fields are
    None for all-intra CTUs.
    """
    x0: int                      # luma position of CTU in the picture
    y0: int
    depth_map: np.ndarray        # CU depth per 4x4 unit
    luma_mode: np.ndarray        # intra luma mode per 4x4 unit
    chroma_mode: np.ndarray      # intra chroma mode per 4x4 unit
    part_nxn: np.ndarray         # bool per unit: CU at max depth uses NxN
    tr_depth_map: np.ndarray     # transform depth (relative to CU) per unit
    coeff_y: np.ndarray          # (ctu, ctu) int32, spatial layout
    coeff_cb: np.ndarray         # (ctu/2, ctu/2)
    coeff_cr: np.ndarray
    # ---- inter (P/B slices); unit-granular, CU-constant ----
    pred_intra: np.ndarray = None  # bool: CU coded as intra
    skip: np.ndarray = None        # bool: cu_skip_flag
    merge_flag: np.ndarray = None  # bool (valid where inter, non-skip)
    merge_idx: np.ndarray = None   # int8
    mvd: np.ndarray = None         # (units, units, 2) int32, list 0
    mvp_idx: np.ndarray = None     # int8, list 0
    inter_dir: np.ndarray = None   # int8: 0=PRED_L0, 1=PRED_L1, 2=PRED_BI
    mvd_l1: np.ndarray = None      # (units, units, 2) int32
    mvp_idx_l1: np.ndarray = None  # int8
    qp_ctu: int = None             # this CTU's coded QP (cu_qp_delta)


class SliceSyntaxEncoder:
    """Encodes slice_data() for one slice (single substream; WPP variant
    managed by the caller via context save/restore hooks)."""

    def __init__(self, enc: CabacEncoder, ctxs: ContextSet, *,
                 pic_width: int, pic_height: int, ctu_log2: int,
                 min_cu_log2: int, max_tr_depth_intra: int,
                 sign_hiding: bool, slice_type: int = SLICE_I,
                 max_tr_depth_inter: int = 0, max_merge_cand: int = 5,
                 sao_info: dict | None = None,
                 cu_qp_delta_enabled: bool = False, slice_qp: int = 26,
                 wpp: bool = False):
        """sao_info (optional): dict with per-CTU-grid arrays
        'luma'/'cb'/'cr' (each a params dict of type/eo_class/band_pos/
        offsets), bool arrays 'merge_left'/'merge_up', and flags
        'sao_luma'/'sao_chroma'."""
        self.enc = enc
        self.ctxs = ctxs
        self.pic_width = pic_width
        self.pic_height = pic_height
        self.ctu_log2 = ctu_log2
        self.min_cu_log2 = min_cu_log2
        self.max_tr_depth_intra = max_tr_depth_intra
        self.max_tr_depth_inter = max_tr_depth_inter
        self.sign_hiding = sign_hiding
        self.slice_type = slice_type
        # Frame-level 4x4-unit grids for cross-CU context derivation.
        uw = -(-pic_width // 4)
        uh = -(-pic_height // 4)
        self.frame_depth = np.zeros((uh, uw), dtype=np.int8)
        self.frame_intra_mode = np.full((uh, uw), INTRA_DC, dtype=np.int8)
        self.frame_is_intra = np.zeros((uh, uw), dtype=bool)
        self.frame_avail = np.zeros((uh, uw), dtype=bool)
        self.frame_skip = np.zeros((uh, uw), dtype=bool)
        self.max_merge_cand = max_merge_cand
        self.sao_info = sao_info
        # cu_qp_delta (spec 7.3.8.10 / 8.6.1). Quantisation groups == CTBs
        # (diff_cu_qp_delta_depth 0), so both spatial predictors fall back
        # to qPY_PREV: pred == the previous QG's final QP in decode order,
        # reset to SliceQpY at slice start (and at each CTB row start under
        # entropy_coding_sync).
        self.cu_qp_delta_enabled = cu_qp_delta_enabled
        self.slice_qp = slice_qp
        self.wpp = wpp
        self._qp_prev = slice_qp
        self._qg_coded = True          # nothing pending before first CTU
        self._qg_pred = slice_qp
        self._qg_target = slice_qp

    # ------------------------------------------------------------------ CTU
    def encode_ctu(self, plan: CtuPlan, *, is_last: bool) -> None:
        self._plan = plan
        size = 1 << self.ctu_log2
        if self.cu_qp_delta_enabled:
            if self.wpp and plan.x0 == 0:
                self._qp_prev = self.slice_qp
            self._qg_pred = self._qp_prev
            self._qg_coded = False
            self._qg_target = (int(plan.qp_ctu) if getattr(
                plan, "qp_ctu", None) is not None else self.slice_qp)
        if self.sao_info is not None:
            self._sao_syntax(plan.x0 >> self.ctu_log2,
                             plan.y0 >> self.ctu_log2)
        self._coding_quadtree(plan.x0, plan.y0, self.ctu_log2, 0)
        # Mark this CTU's units as available for subsequent context lookups.
        ux0, uy0 = plan.x0 // 4, plan.y0 // 4
        un = size // 4
        self.frame_avail[uy0:uy0 + un, ux0:ux0 + un] = True
        if self.cu_qp_delta_enabled:
            self._qp_prev = (self._qg_target if self._qg_coded
                             else self._qg_pred)
        self.enc.encode_terminate(1 if is_last else 0)

    # ----------------------------------------------------------- sao 7.3.8.3
    def _sao_syntax(self, rx: int, ry: int) -> None:
        si = self.sao_info
        enc, ctxs = self.enc, self.ctxs
        ml = bool(si["merge_left"][ry, rx])
        mu = bool(si["merge_up"][ry, rx])
        if rx > 0:
            enc.encode_bin(ctxs, OFF["SAO_MERGE"], int(ml))
        if not ml and ry > 0:
            enc.encode_bin(ctxs, OFF["SAO_MERGE"], int(mu))
        if ml or mu:
            return
        for c_idx, comp in enumerate(("luma", "cb", "cr")):
            if c_idx == 0 and not si["sao_luma"]:
                continue
            if c_idx > 0 and not si["sao_chroma"]:
                continue
            par = si[comp]
            typ = int(par["type"][ry, rx])
            if c_idx in (0, 1):
                # sao_type_idx: TR cMax 2, bin0 ctx + bin1 bypass.
                enc.encode_bin(ctxs, OFF["SAO_TYPE"], int(typ != 0))
                if typ:
                    enc.encode_bypass(typ - 1)
            if typ == 0:
                continue
            offs = [int(v) for v in par["offsets"][ry, rx]]
            for v in offs:
                a = abs(v)
                for _ in range(a):
                    enc.encode_bypass(1)
                if a < 7:
                    enc.encode_bypass(0)
            if typ == 1:                         # band offset
                for v in offs:
                    if v:
                        enc.encode_bypass(int(v < 0))
                enc.encode_bypass_bins(int(par["band_pos"][ry, rx]), 5)
            elif c_idx in (0, 1):                # edge class, shared cb/cr
                enc.encode_bypass_bins(int(par["eo_class"][ry, rx]), 2)

    # ---------------------------------------------------------- quadtree
    def _unit(self, x: int, y: int) -> tuple[int, int]:
        """Plan-local unit coords for a luma position."""
        return (x - self._plan.x0) // 4, (y - self._plan.y0) // 4

    def _coding_quadtree(self, x0, y0, log2_size, depth) -> None:
        size = 1 << log2_size
        ux, uy = self._unit(x0, y0)
        cu_depth = int(self._plan.depth_map[uy, ux])
        inside = (x0 + size <= self.pic_width) and (y0 + size <= self.pic_height)
        split = cu_depth > depth
        if inside and log2_size > self.min_cu_log2:
            # split_cu_flag, ctx from left/above depths (spec 9.3.4.2.2).
            gx, gy = x0 // 4, y0 // 4
            ctx = 0
            if gx > 0 and self.frame_avail[gy, gx - 1]:
                ctx += int(self.frame_depth[gy, gx - 1] > depth)
            if gy > 0 and self.frame_avail[gy - 1, gx]:
                ctx += int(self.frame_depth[gy - 1, gx] > depth)
            self.enc.encode_bin(self.ctxs, OFF["SPLIT_CU"] + ctx, int(split))
        elif not inside:
            split = log2_size > self.min_cu_log2  # forced split at pic boundary
        if split:
            half = size >> 1
            for (dx, dy) in ((0, 0), (half, 0), (0, half), (half, half)):
                x1, y1 = x0 + dx, y0 + dy
                if x1 < self.pic_width and y1 < self.pic_height:
                    self._coding_quadtree(x1, y1, log2_size - 1, depth + 1)
            return
        self._coding_unit(x0, y0, log2_size, depth)

    # ------------------------------------------------------------------- CU
    def _coding_unit(self, x0, y0, log2_size, depth) -> None:
        plan = self._plan
        ux, uy = self._unit(x0, y0)
        un = (1 << log2_size) // 4

        if self.slice_type != SLICE_I:
            self._inter_coding_unit(x0, y0, log2_size, depth)
            return
        self._intra_coding_unit(x0, y0, log2_size, depth)

    # -------------------------------------------------- inter CU (P slice)
    def _mark_cu(self, x0, y0, log2_size, depth, *, is_intra, skip):
        un = (1 << log2_size) // 4
        gx0, gy0 = x0 // 4, y0 // 4
        self.frame_depth[gy0:gy0 + un, gx0:gx0 + un] = depth
        self.frame_is_intra[gy0:gy0 + un, gx0:gx0 + un] = is_intra
        self.frame_skip[gy0:gy0 + un, gx0:gx0 + un] = skip
        self.frame_avail[gy0:gy0 + un, gx0:gx0 + un] = True

    def _inter_coding_unit(self, x0, y0, log2_size, depth) -> None:
        plan = self._plan
        ux, uy = self._unit(x0, y0)
        gx, gy = x0 // 4, y0 // 4

        # cu_skip_flag, ctx from left/above skip flags (spec 9.3.4.2.2).
        skip = bool(plan.skip[uy, ux])
        ctx = 0
        if gx > 0 and self.frame_avail[gy, gx - 1]:
            ctx += int(self.frame_skip[gy, gx - 1])
        if gy > 0 and self.frame_avail[gy - 1, gx]:
            ctx += int(self.frame_skip[gy - 1, gx])
        self.enc.encode_bin(self.ctxs, OFF["SKIP"] + ctx, int(skip))
        if skip:
            self._merge_idx(int(plan.merge_idx[uy, ux]))
            self._mark_cu(x0, y0, log2_size, depth, is_intra=False, skip=True)
            return

        is_intra = bool(plan.pred_intra[uy, ux]) if plan.pred_intra is not None else False
        self.enc.encode_bin(self.ctxs, OFF["PRED_MODE"], int(is_intra))
        if is_intra:
            self._intra_coding_unit(x0, y0, log2_size, depth)
            return

        # part_mode: inter 2Nx2N only for now -> first bin = 1 (spec 9.3.3.7).
        self.enc.encode_bin(self.ctxs, OFF["PART_SIZE"], 1)

        # prediction_unit (7.3.8.6), single 2Nx2N PU; one reference per
        # list, so ref_idx is never coded.
        merge = bool(plan.merge_flag[uy, ux])
        self.enc.encode_bin(self.ctxs, OFF["MERGE_FLAG"], int(merge))
        if merge:
            self._merge_idx(int(plan.merge_idx[uy, ux]))
        else:
            idc = 0
            if self.slice_type == SLICE_B:
                idc = int(plan.inter_dir[uy, ux])
                # inter_pred_idc (9.3.3.8): 2Nx2N -> BI: "1"; L0: "00";
                # L1: "01"; bin0 ctx = CtDepth, bin1 ctx = 4.
                self.enc.encode_bin(self.ctxs, OFF["INTER_DIR"] + depth,
                                    int(idc == 2))
                if idc != 2:
                    self.enc.encode_bin(self.ctxs, OFF["INTER_DIR"] + 4,
                                        int(idc == 1))
            if idc != 1:        # uses list 0
                self._mvd_coding(int(plan.mvd[uy, ux, 0]),
                                 int(plan.mvd[uy, ux, 1]))
                self.enc.encode_bin(self.ctxs, OFF["MVP_IDX"],
                                    int(plan.mvp_idx[uy, ux]))
            if idc != 0:        # uses list 1 (mvd_l1_zero_flag is 0)
                self._mvd_coding(int(plan.mvd_l1[uy, ux, 0]),
                                 int(plan.mvd_l1[uy, ux, 1]))
                self.enc.encode_bin(self.ctxs, OFF["MVP_IDX"],
                                    int(plan.mvp_idx_l1[uy, ux]))

        self._mark_cu(x0, y0, log2_size, depth, is_intra=False, skip=False)

        # rqt_root_cbf (7.3.8.5): coded unless merge 2Nx2N (then inferred 1).
        size = 1 << log2_size
        lx, ly = x0 - plan.x0, y0 - plan.y0
        has_resid = (bool(np.any(plan.coeff_y[ly:ly + size, lx:lx + size]))
                     or bool(np.any(plan.coeff_cb[ly // 2:(ly + size) // 2,
                                                  lx // 2:(lx + size) // 2]))
                     or bool(np.any(plan.coeff_cr[ly // 2:(ly + size) // 2,
                                                  lx // 2:(lx + size) // 2])))
        if not merge:
            self.enc.encode_bin(self.ctxs, OFF["ROOT_CBF"], int(has_resid))
        else:
            assert has_resid, "merge 2Nx2N without residual must be skip"
        if has_resid:
            self._transform_tree(x0, y0, x0, y0, log2_size, 0, 0,
                                 intra_split=False,
                                 max_depth=self.max_tr_depth_inter,
                                 cbf_cb_parent=True, cbf_cr_parent=True,
                                 is_intra=False)

    def _merge_idx(self, idx: int) -> None:
        """merge_idx: TR cMax = MaxNumMergeCand-1; bin 0 ctx, rest bypass."""
        cmax = self.max_merge_cand - 1
        if cmax == 0:
            return
        self.enc.encode_bin(self.ctxs, OFF["MERGE_IDX"], int(idx > 0))
        if idx > 0:
            for k in range(1, idx):
                self.enc.encode_bypass(1)
            if idx < cmax:
                self.enc.encode_bypass(0)

    def _mvd_coding(self, mvd_x: int, mvd_y: int) -> None:
        """mvd_coding() (7.3.8.9): greater0/greater1 ctx bins, EG1 remainder."""
        ax, ay = abs(mvd_x), abs(mvd_y)
        self.enc.encode_bin(self.ctxs, OFF["MVD"], int(ax > 0))
        self.enc.encode_bin(self.ctxs, OFF["MVD"], int(ay > 0))
        if ax > 0:
            self.enc.encode_bin(self.ctxs, OFF["MVD"] + 1, int(ax > 1))
        if ay > 0:
            self.enc.encode_bin(self.ctxs, OFF["MVD"] + 1, int(ay > 1))
        for a, v in ((ax, mvd_x), (ay, mvd_y)):
            if a > 0:
                if a > 1:
                    self._encode_egk(a - 2, 1)
                self.enc.encode_bypass(int(v < 0))

    def _encode_egk(self, value: int, k: int) -> None:
        while value >= (1 << k):
            self.enc.encode_bypass(1)
            value -= 1 << k
            k += 1
        self.enc.encode_bypass(0)
        if k:
            self.enc.encode_bypass_bins(value, k)

    # -------------------------------------------------------------- intra CU
    def _intra_coding_unit(self, x0, y0, log2_size, depth) -> None:
        plan = self._plan
        ux, uy = self._unit(x0, y0)
        un = (1 << log2_size) // 4
        part_nxn = bool(plan.part_nxn[uy, ux])

        if log2_size == self.min_cu_log2:
            # part_mode: 1 = PART_2Nx2N, 0 = PART_NxN (intra, spec 9.3.3.7).
            self.enc.encode_bin(self.ctxs, OFF["PART_SIZE"], 0 if part_nxn else 1)

        # --- intra luma mode(s) -------------------------------------------
        nparts = 4 if part_nxn else 1
        half = (1 << log2_size) >> 1
        pu_offsets = [(0, 0)] if not part_nxn else [(0, 0), (half, 0), (0, half), (half, half)]
        # MPM derivation is sequential across PUs (PU1's left neighbor is
        # PU0, spec 8.4.2), so derive lists and update the mode grid in PU
        # order BEFORE emitting any bins; the bin order itself is: all
        # prev_intra_luma_pred_flag first, then all indices (7.3.8.5).
        modes = []
        mpms = []
        pu_un = un if not part_nxn else un // 2
        for (dx, dy) in pu_offsets:
            pu_ux, pu_uy = self._unit(x0 + dx, y0 + dy)
            mode = int(plan.luma_mode[pu_uy, pu_ux])
            modes.append(mode)
            mpms.append(self._mpm_list(x0 + dx, y0 + dy))
            gx0, gy0 = (x0 + dx) // 4, (y0 + dy) // 4
            self.frame_intra_mode[gy0:gy0 + pu_un, gx0:gx0 + pu_un] = mode
            self.frame_is_intra[gy0:gy0 + pu_un, gx0:gx0 + pu_un] = True
            self.frame_avail[gy0:gy0 + pu_un, gx0:gx0 + pu_un] = True
        for mode, mpm in zip(modes, mpms):
            self.enc.encode_bin(self.ctxs, OFF["INTRA_LUMA"], int(mode in mpm))
        for mode, mpm in zip(modes, mpms):
            if mode in mpm:
                idx = mpm.index(mode)
                self.enc.encode_bypass(min(idx, 1))
                if idx:
                    self.enc.encode_bypass(idx - 1)
            else:
                rem = mode - sum(1 for c in mpm if c < mode)
                self.enc.encode_bypass_bins(rem, 5)

        # --- intra chroma mode (one for the CU in 4:2:0, spec 7.3.8.5) ----
        chroma_mode = int(plan.chroma_mode[uy, ux])
        luma_for_chroma = modes[0]
        cand = [INTRA_PLANAR, INTRA_VER, INTRA_HOR, INTRA_DC]
        if luma_for_chroma in cand:
            cand[cand.index(luma_for_chroma)] = 34
        if chroma_mode == luma_for_chroma:
            self.enc.encode_bin(self.ctxs, OFF["INTRA_CHROMA"], 0)
        else:
            self.enc.encode_bin(self.ctxs, OFF["INTRA_CHROMA"], 1)
            self.enc.encode_bypass_bins(cand.index(chroma_mode), 2)

        # Record depth for split ctx of subsequent CUs.
        gx0, gy0 = x0 // 4, y0 // 4
        self.frame_depth[gy0:gy0 + un, gx0:gx0 + un] = depth

        # --- transform tree ------------------------------------------------
        intra_split = part_nxn
        max_depth = self.max_tr_depth_intra + (1 if intra_split else 0)
        self._transform_tree(x0, y0, x0, y0, log2_size, 0, 0,
                             intra_split=intra_split, max_depth=max_depth,
                             cbf_cb_parent=True, cbf_cr_parent=True)

    # ---------------------------------------------------------- MPM (8.4.2)
    def _neighbor_mode(self, gx: int, gy: int, *, is_above: bool, yctb: int) -> int:
        if gx < 0 or gy < 0:
            return INTRA_DC
        if not self.frame_avail[gy, gx] or not self.frame_is_intra[gy, gx]:
            return INTRA_DC
        if is_above and (gy * 4) < yctb:
            return INTRA_DC          # above PU outside current CTU row
        return int(self.frame_intra_mode[gy, gx])

    def _mpm_list(self, x: int, y: int) -> list[int]:
        gx, gy = x // 4, y // 4
        yctb = (y >> self.ctu_log2) << self.ctu_log2
        a = self._neighbor_mode(gx - 1, gy, is_above=False, yctb=yctb)
        b = self._neighbor_mode(gx, gy - 1, is_above=True, yctb=yctb)
        if a == b:
            if a < 2:
                return [INTRA_PLANAR, INTRA_DC, INTRA_VER]
            return [a, 2 + ((a + 29) % 32), 2 + ((a - 2 + 1) % 32)]
        mpm = [a, b]
        if INTRA_PLANAR not in mpm:
            mpm.append(INTRA_PLANAR)
        elif INTRA_DC not in mpm:
            mpm.append(INTRA_DC)
        else:
            mpm.append(INTRA_VER)
        return mpm

    # ------------------------------------------------- transform tree 7.3.8.8
    def _tr_split(self, x0, y0, trafo_depth) -> bool:
        ux, uy = self._unit(x0, y0)
        return int(self._plan.tr_depth_map[uy, ux]) > trafo_depth

    def _cbf(self, x0, y0, log2_size, c_idx) -> bool:
        plan = self._plan
        if c_idx == 0:
            lx, ly = x0 - plan.x0, y0 - plan.y0
            blk = plan.coeff_y[ly:ly + (1 << log2_size), lx:lx + (1 << log2_size)]
        else:
            cx, cy = (x0 - plan.x0) // 2, (y0 - plan.y0) // 2
            arr = plan.coeff_cb if c_idx == 1 else plan.coeff_cr
            blk = arr[cy:cy + (1 << log2_size), cx:cx + (1 << log2_size)]
        return bool(np.any(blk))

    def _transform_tree(self, x0, y0, xbase, ybase, log2_size, trafo_depth,
                        blk_idx, *, intra_split, max_depth,
                        cbf_cb_parent, cbf_cr_parent, is_intra=True) -> None:
        max_tb_log2, min_tb_log2 = 5, 2
        split = self._tr_split(x0, y0, trafo_depth)
        explicit = (log2_size <= max_tb_log2 and log2_size > min_tb_log2
                    and trafo_depth < max_depth
                    and not (intra_split and trafo_depth == 0))
        if log2_size > max_tb_log2 or (intra_split and trafo_depth == 0):
            split = True                      # implicit split
        elif log2_size == min_tb_log2 or trafo_depth == max_depth:
            split = False
        if explicit:
            self.enc.encode_bin(self.ctxs, OFF["TRANS_SUBDIV"] + (5 - log2_size),
                                int(split))

        # Chroma cbfs at this node (coded before split recursion, 7.3.8.8).
        cbf_cb = cbf_cr = False
        if log2_size > 2:
            cbf_cb = self._cbf(x0, y0, log2_size - 1, 1)
            cbf_cr = self._cbf(x0, y0, log2_size - 1, 2)
            if trafo_depth == 0 or cbf_cb_parent:
                self.enc.encode_bin(self.ctxs, OFF["CBF_CHROMA"] + trafo_depth,
                                    int(cbf_cb))
            if trafo_depth == 0 or cbf_cr_parent:
                self.enc.encode_bin(self.ctxs, OFF["CBF_CHROMA"] + trafo_depth,
                                    int(cbf_cr))
        else:
            cbf_cb, cbf_cr = cbf_cb_parent, cbf_cr_parent

        if split:
            half = 1 << (log2_size - 1)
            for i, (dx, dy) in enumerate(((0, 0), (half, 0), (0, half), (half, half))):
                self._transform_tree(x0 + dx, y0 + dy, x0, y0, log2_size - 1,
                                     trafo_depth + 1, i,
                                     intra_split=intra_split, max_depth=max_depth,
                                     cbf_cb_parent=cbf_cb, cbf_cr_parent=cbf_cr,
                                     is_intra=is_intra)
            return

        # Leaf: cbf_luma — coded for intra always; for inter inferred 1 when
        # trafo_depth == 0 and both chroma cbfs are 0 (spec 7.3.8.8).
        cbf_luma = self._cbf(x0, y0, log2_size, 0)
        if is_intra or trafo_depth != 0 or cbf_cb or cbf_cr:
            self.enc.encode_bin(self.ctxs,
                                OFF["CBF_LUMA"] + (1 if trafo_depth == 0 else 0),
                                int(cbf_luma))
        else:
            assert cbf_luma, "rqt_root_cbf=1 with all-zero residual"
        # transform_unit (7.3.8.10).
        if (self.cu_qp_delta_enabled and not self._qg_coded
                and (cbf_luma or cbf_cb or cbf_cr)):
            self._cu_qp_delta(self._qg_target - self._qg_pred)
            self._qg_coded = True
        if cbf_luma:
            self._residual_coding(x0, y0, log2_size, 0)
        if log2_size > 2:
            if cbf_cb:
                self._residual_coding(x0, y0, log2_size - 1, 1)
            if cbf_cr:
                self._residual_coding(x0, y0, log2_size - 1, 2)
        elif blk_idx == 3:
            # Shared 4x4 chroma TB of four 4x4 luma TBs, at the base position.
            if cbf_cb:
                self._residual_coding(xbase, ybase, 2, 1)
            if cbf_cr:
                self._residual_coding(xbase, ybase, 2, 2)

    def _cu_qp_delta(self, delta: int) -> None:
        """cu_qp_delta_abs (9.3.3.10: TR prefix cMax 5, ctx bins, EG0
        bypass suffix) + cu_qp_delta_sign_flag."""
        a = abs(int(delta))
        pre = min(a, 5)
        self.enc.encode_bin(self.ctxs, OFF["DQP"], int(pre > 0))
        for i in range(1, pre):
            self.enc.encode_bin(self.ctxs, OFF["DQP"] + 1, 1)
        if pre < 5:
            if pre > 0:
                self.enc.encode_bin(self.ctxs, OFF["DQP"] + 1, 0)
        else:
            v = a - 5
            k = 0
            while v >= (1 << (k + 1)) - 1:  # EG0 prefix... unary of length
                k += 1
            # exp-golomb order 0: unary(k) + k bits of (v - (2^k - 1))
            for _ in range(k):
                self.enc.encode_bypass(1)
            self.enc.encode_bypass(0)
            if k:
                self.enc.encode_bypass_bins(v - ((1 << k) - 1), k)
        if a:
            self.enc.encode_bypass(int(delta < 0))

    # ---------------------------------------------- residual coding 7.3.8.11
    def _residual_coding(self, x0, y0, log2_size, c_idx) -> None:
        plan = self._plan
        size = 1 << log2_size
        ux, uy = self._unit(x0, y0)
        cu_intra = (self.slice_type == SLICE_I
                    or (plan.pred_intra is not None and bool(plan.pred_intra[uy, ux])
                        and not (plan.skip is not None and plan.skip[uy, ux])))
        if c_idx == 0:
            lx, ly = x0 - plan.x0, y0 - plan.y0
            coeffs = plan.coeff_y[ly:ly + size, lx:lx + size]
            pred_mode = int(plan.luma_mode[uy, ux])
        else:
            cx, cy = (x0 - plan.x0) // 2, (y0 - plan.y0) // 2
            arr = plan.coeff_cb if c_idx == 1 else plan.coeff_cr
            coeffs = arr[cy:cy + size, cx:cx + size]
            pred_mode = int(plan.chroma_mode[uy, ux])
            if pred_mode == 34 or pred_mode == -1:
                pred_mode = int(plan.luma_mode[uy, ux])

        # Scan selection applies to intra TBs only; inter is always diagonal.
        scan_idx = (tables.scan_mode_for_intra(log2_size, pred_mode, c_idx)
                    if cu_intra else tables.SCAN_DIAG)
        encode_residual_block(self.enc, self.ctxs, coeffs, log2_size, c_idx,
                              scan_idx, self.sign_hiding)


def encode_residual_block(enc, ctxs, coeffs: np.ndarray, log2_size: int,
                          c_idx: int, scan_idx: int, sign_hiding: bool) -> None:
    """residual_coding() of spec 7.3.8.11 for one TB.

    `coeffs` is the (size, size) quantised coefficient block in raster
    layout; the caller guarantees at least one nonzero.
    """
    size = 1 << log2_size
    scan = tables.coeff_scan(log2_size, scan_idx)       # flat raster indices
    flat = coeffs.reshape(-1).astype(np.int64)
    in_scan = flat[scan]
    nz = np.nonzero(in_scan)[0]
    assert len(nz), "cbf=1 block must have a nonzero coefficient"
    last_scan_pos = int(nz[-1])

    # --- last significant coefficient position (9.3.3.x binarization) ----
    last_r = int(scan[last_scan_pos])
    last_x, last_y = last_r % size, last_r // size
    if scan_idx == tables.SCAN_VER:
        last_x, last_y = last_y, last_x
    _encode_last_xy(enc, ctxs, last_x, last_y, log2_size, c_idx)

    num_sb = (size * size) // 16
    last_sb = last_scan_pos // 16
    sb_scan = tables.scan_order(max(size // 4, 1), scan_idx)  # (x,y) subblocks
    csbf = np.zeros((size // 4 + 1, size // 4 + 1), dtype=np.int32)

    # Precompute coded_sub_block_flag values.
    sb_has = np.zeros(num_sb, dtype=bool)
    for i in range(last_sb + 1):
        sb_has[i] = bool(np.any(in_scan[i * 16:(i + 1) * 16]))

    c1 = 1
    for i in range(last_sb, -1, -1):
        sx, sy = (int(sb_scan[i][0]), int(sb_scan[i][1])) if size > 4 else (0, 0)
        infer_sb_dc_sig = False
        if i < last_sb and i > 0:
            right = csbf[sy, sx + 1] if sx + 1 < size // 4 else 0
            below = csbf[sy + 1, sx] if sy + 1 < size // 4 else 0
            ctx = min(right + below, 1) + (2 if c_idx else 0)
            enc.encode_bin(ctxs, OFF["SIG_CG"] + ctx, int(sb_has[i]))
            infer_sb_dc_sig = True
        else:
            sb_has[i] = True  # inferred 1 for last and DC subblocks
        csbf[sy, sx] = int(sb_has[i])
        if not sb_has[i]:
            continue

        start = last_scan_pos - 1 - i * 16 if i == last_sb else 15
        sig_pos = []
        if i == last_sb:
            sig_pos.append(last_scan_pos)   # last coeff: sig inferred 1
        for n in range(start, -1, -1):
            pos = i * 16 + n
            sig = int(in_scan[pos] != 0)
            if n > 0 or not infer_sb_dc_sig:
                ctx = _sig_ctx(pos, scan, size, log2_size, c_idx, scan_idx,
                               csbf, sx, sy)
                enc.encode_bin(ctxs, OFF["SIG"] + ctx, sig)
                if sig:
                    infer_sb_dc_sig = False
            if sig:
                sig_pos.append(pos)

        if not sig_pos:
            # DC subblock with inferred csbf=1 but no significant coeffs
            # (all sig flags coded 0) — nothing further to code.
            continue

        # sig_pos is in reverse scan order (high freq -> DC).
        levels = [int(abs(in_scan[p])) for p in sig_pos]
        signs = [int(in_scan[p] < 0) for p in sig_pos]

        # greater1 / greater2 (9.3.4.2.6).
        ctx_set = (2 if (i > 0 and c_idx == 0) else 0) + (1 if c1 == 0 else 0)
        c1 = 1
        gt1_flags = []
        first_gt1 = -1
        for k, lev in enumerate(levels[:8]):
            gt1 = int(lev > 1)
            base = OFF["ONE"] + (16 if c_idx else 0) + 4 * ctx_set + c1
            enc.encode_bin(ctxs, base, gt1)
            gt1_flags.append(gt1)
            if gt1:
                c1 = 0
                if first_gt1 < 0:
                    first_gt1 = k
            elif 0 < c1 < 3:
                c1 += 1
        if first_gt1 >= 0:
            gt2 = int(levels[first_gt1] > 2)
            enc.encode_bin(ctxs, OFF["ABS"] + (4 if c_idx else 0) + ctx_set, gt2)
        else:
            gt2 = 0

        # Sign hiding decision (spec 7.3.8.11: first/last sig scan pos gap).
        first_sig = sig_pos[-1] - i * 16   # DC-most (smallest n)
        last_sig = sig_pos[0] - i * 16
        sign_hidden = sign_hiding and (last_sig - first_sig > 3)
        for k, s in enumerate(signs):
            if sign_hidden and k == len(signs) - 1:
                continue                    # hidden: inferred from parity
            enc.encode_bypass(s)

        # coeff_abs_level_remaining (9.3.3.9 Golomb-Rice).
        rice = 0
        for k, lev in enumerate(levels):
            # coeff_abs_level_remaining present iff the level reached the cap
            # of the flag-coded prefix (1 + gt1 [+ gt2 for the single gt2 slot]).
            if k < 8:
                if k == first_gt1:
                    base_level = 2 + gt2
                    code_rem = gt2 == 1
                elif gt1_flags[k]:
                    base_level = 2
                    code_rem = True
                else:
                    base_level = 1
                    code_rem = False
            else:
                base_level = 1
                code_rem = True
            if code_rem:
                _encode_remaining(enc, lev - base_level, rice)
                if lev > (3 << rice):
                    rice = min(rice + 1, 4)


def _encode_last_xy(enc, ctxs, last_x, last_y, log2_size, c_idx) -> None:
    """last_sig_coeff_{x,y}_{prefix,suffix} (9.3.3.x + ctx 9.3.4.2.3)."""
    if c_idx == 0:
        ctx_offset = 3 * (log2_size - 2) + ((log2_size - 1) >> 2)
        ctx_shift = (log2_size + 1) >> 2
    else:
        ctx_offset = 15
        ctx_shift = log2_size - 2
    cmax = (log2_size << 1) - 1
    gx = int(tables.GROUP_IDX[last_x])
    gy = int(tables.GROUP_IDX[last_y])
    for bin_idx in range(gx):
        enc.encode_bin(ctxs, OFF["LAST_X"] + ctx_offset + (bin_idx >> ctx_shift), 1)
    if gx < cmax:
        enc.encode_bin(ctxs, OFF["LAST_X"] + ctx_offset + (gx >> ctx_shift), 0)
    for bin_idx in range(gy):
        enc.encode_bin(ctxs, OFF["LAST_Y"] + ctx_offset + (bin_idx >> ctx_shift), 1)
    if gy < cmax:
        enc.encode_bin(ctxs, OFF["LAST_Y"] + ctx_offset + (gy >> ctx_shift), 0)
    if gx > 3:
        nbits = (gx >> 1) - 1
        enc.encode_bypass_bins(last_x - int(tables.MIN_IN_GROUP[gx]), nbits)
    if gy > 3:
        nbits = (gy >> 1) - 1
        enc.encode_bypass_bins(last_y - int(tables.MIN_IN_GROUP[gy]), nbits)


def _sig_ctx(pos, scan, size, log2_size, c_idx, scan_idx, csbf, sx, sy) -> int:
    """sig_coeff_flag ctxInc (spec 9.3.4.2.5)."""
    r = int(scan[pos])
    xc, yc = r % size, r // size
    if log2_size == 2:
        sig_ctx = int(_SIG_CTX_MAP_4X4[(yc << 2) + xc])
    elif xc + yc == 0:
        sig_ctx = 0
    else:
        nsb = size // 4
        right = int(csbf[sy, sx + 1]) if sx + 1 < nsb else 0
        below = int(csbf[sy + 1, sx]) if sy + 1 < nsb else 0
        prev_csbf = right + 2 * below
        xp, yp = xc & 3, yc & 3
        if prev_csbf == 0:
            sig_ctx = 2 if xp + yp == 0 else (1 if xp + yp < 3 else 0)
        elif prev_csbf == 1:
            sig_ctx = 2 if yp == 0 else (1 if yp == 1 else 0)
        elif prev_csbf == 2:
            sig_ctx = 2 if xp == 0 else (1 if xp == 1 else 0)
        else:
            sig_ctx = 2
        if c_idx == 0:
            if sx + sy > 0:
                sig_ctx += 3
            if log2_size == 3:
                sig_ctx += 9 if scan_idx == tables.SCAN_DIAG else 15
            else:
                sig_ctx += 21
        else:
            if log2_size == 3:
                sig_ctx += 9
            else:
                sig_ctx += 12
    return sig_ctx + (27 if c_idx else 0)


def _encode_remaining(enc, value: int, rice: int) -> None:
    """coeff_abs_level_remaining Golomb-Rice binarization (9.3.3.9)."""
    assert value >= 0
    if (value >> rice) < 3:
        q = value >> rice
        enc.encode_bypass_bins((1 << (q + 1)) - 2, q + 1)
        if rice:
            enc.encode_bypass_bins(value & ((1 << rice) - 1), rice)
    else:
        value -= 3 << rice
        length = rice
        while value >= (1 << length):
            value -= 1 << length
            length += 1
        prefix_len = 3 + length + 1 - rice
        enc.encode_bypass_bins((1 << prefix_len) - 2, prefix_len)
        if length:
            enc.encode_bypass_bins(value, length)
