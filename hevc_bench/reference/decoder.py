"""Picture decoding: CABAC parsing of the slice data (H.265 7.3.8, 9.3),
then reconstruction (8.4 to 8.6) and the in-loop filters (8.7)."""

from __future__ import annotations

import functools

import numpy as np

from . import filters, predict
from .bitstream import (NAL_IDR_N_LP, NAL_IDR_W_RADL, NAL_PPS, NAL_SPS,
                        NAL_TRAIL_R, OFF, Cabac, init_contexts, split_nals)
from .headers import Params, parse_pps, parse_slice_header, parse_sps

SLICE_P, SLICE_I = 1, 2
CTX_IDX_MAP = (0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8)
Z4 = ((0, 0), (1, 0), (0, 1), (1, 1))


class DecodeError(ValueError):
    """The slice data does not parse as the syntax requires."""


class Decoder:
    """Decodes one AU after another; `ref` holds the last decoded picture
    (padded Y, U, V uint8), the reference of the next P picture."""

    def __init__(self, params: Params | None = None, ref=None):
        self.params = params
        self.ref = ref
        self.sps = self.pps = None
        self.header = None          # slice header of the last picture
        self.picture = None         # state of the last picture decoded
        self.nal_types = []

    def decode_au(self, au: bytes):
        """Decode an access unit; returns the picture (Y, U, V) uint8."""
        pic = None
        self.nal_types = []
        for nal in split_nals(au):
            self.nal_types.append(nal.type)
            if nal.type == NAL_SPS:
                self.sps = parse_sps(nal.rbsp)
            elif nal.type == NAL_PPS:
                self.pps = parse_pps(nal.rbsp)
                self.params = Params(**self.sps, **self.pps)
            elif nal.type in (NAL_TRAIL_R, NAL_IDR_W_RADL, NAL_IDR_N_LP):
                if pic is not None:
                    raise DecodeError("more than one slice in the AU")
                if self.params is None:
                    raise DecodeError("slice before any parameter set")
                pic = self._decode_slice(nal)
        if pic is None:
            raise DecodeError("the AU holds no slice")
        self.ref = pic
        return pic

    def _decode_slice(self, nal):
        p = self.params
        sh = parse_slice_header(nal.rbsp, nal.type, p)
        self.header = sh
        if sh.slice_type == SLICE_P:
            if self.ref is None:
                raise DecodeError("P slice without a reference picture")
            if tuple(sh.rps) != (1,) or sh.num_ref_idx_l0 != 1:
                raise DecodeError("P slice refers to other than the "
                                  "previous picture")
        elif sh.slice_type != SLICE_I:
            raise DecodeError(f"slice type {sh.slice_type}")
        self.picture = _Picture(p, sh, nal, self.ref)
        return self.picture.decode()


class _Picture:
    """State of one picture while its slice is parsed and reconstructed."""

    def __init__(self, p: Params, sh, nal, ref):
        self.p, self.sh, self.nal, self.ref = p, sh, nal, ref
        self.W, self.H = p.width, p.height
        H4, W4 = -(-self.H // 4), -(-self.W // 4)
        self.order = np.full((H4, W4), -1, dtype=np.int64)
        self.depth = np.zeros((H4, W4), dtype=np.int64)
        self.skip = np.zeros((H4, W4), dtype=bool)
        self.intra = np.zeros((H4, W4), dtype=bool)
        self.ipm = np.ones((H4, W4), dtype=np.int64)
        self.mv = np.zeros((H4, W4, 2), dtype=np.int64)
        self.qp = np.zeros((H4, W4), dtype=np.int64)
        self.tu = np.zeros((H4, W4), dtype=np.int64)
        self.nz = np.zeros((H4, W4), dtype=bool)
        self.n_order = 0
        self.n_tu = 0
        self.inter_cus = []     # (x, y, size, mvx, mvy)
        self.inter_pred = None  # luma motion-compensated prediction
        # [c, x, y, n, levels or None, qp, order, intra, mode]
        self.tbs = []
        self.cu_tbs = []
        R, C = p.ctbs[1], p.ctbs[0]
        self.sao = [dict(typ=np.zeros((R, C), dtype=np.int64),
                         off=np.zeros((R, C, 4), dtype=np.int64),
                         band=np.zeros((R, C), dtype=np.int64),
                         eo=np.zeros((R, C), dtype=np.int64))
                    for _ in range(3)]
        self.qg = None
        self.qg_size = p.ctb >> p.diff_cu_qp_delta_depth
        self.last_qp = sh.qp
        self.dqp_coded = False
        self.dqp = 0
        self.qp_pred = sh.qp

    # ---------------------------------------------------------------- slice
    def decode(self):
        p, sh = self.p, self.sh
        C, R = p.ctbs
        init_type = 0 if sh.slice_type == SLICE_I else 1
        data = self.nal.rbsp
        starts = [sh.data_byte]
        if p.wpp:
            raw0 = self.nal.raw_pos(sh.data_byte)
            acc = 0
            for e in sh.entry_points:
                acc += e
                starts.append(self.nal.rbsp_pos(raw0 + acc))
            if len(starts) != R:
                raise DecodeError(f"{len(starts) - 1} entry points for {R} "
                                  "CTB rows")
        st, mp = init_contexts(init_type, sh.qp)
        cab = Cabac(data, starts[0], st, mp)
        saved = None
        n = C * R
        for addr in range(n):
            cx, cy = addr % C, addr // C
            if p.wpp and cx == 0 and cy > 0:
                if C >= 2 and saved is not None:
                    st, mp = list(saved[0]), list(saved[1])
                else:
                    st, mp = init_contexts(init_type, sh.qp)
                cab = Cabac(data, starts[cy], st, mp)
            self.cab = cab
            if p.wpp and cx == 0:
                self.last_qp = sh.qp
            x0, y0 = cx << p.ctb_log2, cy << p.ctb_log2
            if sh.sao_luma or sh.sao_chroma:
                self._sao(cx, cy)
            self._quadtree(x0, y0, p.ctb_log2, 0)
            if p.wpp and cx == 1:
                saved = (list(cab.st), list(cab.mps))
            end = cab.terminate()
            if end != (addr == n - 1):
                raise DecodeError(f"end_of_slice_segment_flag {end} at CTB "
                                  f"{addr} of {n}")
            if p.wpp and cx == C - 1 and not end:
                if cab.terminate() != 1:
                    raise DecodeError("end_of_subset_one_bit is 0")
        return self._reconstruct()

    def _sao(self, rx, ry):
        cab = self.cab
        dec, byp = cab.decode, cab.bypass
        sao, sh = self.sao, self.sh
        ml = dec(OFF["SAO_MERGE"]) if rx > 0 else 0
        mu = dec(OFF["SAO_MERGE"]) if (ry > 0 and not ml) else 0
        if ml or mu:
            sy, sx = (ry, rx - 1) if ml else (ry - 1, rx)
            for comp in sao:
                for k in comp:
                    comp[k][ry, rx] = comp[k][sy, sx]
            return
        for c in range(3):
            comp = sao[c]
            if not (sh.sao_luma if c == 0 else sh.sao_chroma):
                continue
            if c < 2:
                t = 0
                if dec(OFF["SAO_TYPE"]):
                    t = 2 if byp() else 1
            else:
                t = int(sao[1]["typ"][ry, rx])
            comp["typ"][ry, rx] = t
            if not t:
                continue
            absv = []
            for _ in range(4):
                a = 0
                while a < 7 and byp():
                    a += 1
                absv.append(a)
            if t == 1:
                offs = [-a if (a and byp()) else a for a in absv]
                comp["band"][ry, rx] = cab.bypass_bins(5)
            else:
                offs = [absv[0], absv[1], -absv[2], -absv[3]]
                comp["eo"][ry, rx] = (cab.bypass_bins(2) if c < 2
                                      else sao[1]["eo"][ry, rx])
            comp["off"][ry, rx] = offs

    # ------------------------------------------------------------ quadtree
    def _avail(self, x, y) -> bool:
        return (0 <= x < self.W and 0 <= y < self.H
                and self.order[y >> 2, x >> 2] >= 0)

    def _quadtree(self, x0, y0, log2, depth):
        p = self.p
        size = 1 << log2
        if x0 + size <= self.W and y0 + size <= self.H \
                and log2 > p.min_cb_log2:
            ctx = 0
            if self._avail(x0 - 1, y0) and \
                    self.depth[y0 >> 2, (x0 - 1) >> 2] > depth:
                ctx += 1
            if self._avail(x0, y0 - 1) and \
                    self.depth[(y0 - 1) >> 2, x0 >> 2] > depth:
                ctx += 1
            split = self.cab.decode(OFF["SPLIT_CU"] + ctx)
        else:
            split = log2 > p.min_cb_log2
        if p.cu_qp_delta and size >= self.qg_size:
            self.dqp_coded = False
            self.dqp = 0
        if split:
            h = size >> 1
            for dx, dy in Z4:
                x1, y1 = x0 + dx * h, y0 + dy * h
                if x1 < self.W and y1 < self.H:
                    self._quadtree(x1, y1, log2 - 1, depth + 1)
        else:
            self._coding_unit(x0, y0, log2, depth)

    def _region(self, x0, y0, size):
        return (slice(y0 >> 2, (y0 + size) >> 2),
                slice(x0 >> 2, (x0 + size) >> 2))

    def _coding_unit(self, x0, y0, log2, depth):
        p, sh, cab = self.p, self.sh, self.cab
        dec = cab.decode
        size = 1 << log2
        reg = self._region(x0, y0, size)
        self._start_qg(x0, y0)
        self.n_order += 1
        self.order[reg] = self.n_order
        self.depth[reg] = depth
        self.cu_tbs = []
        skip = False
        if sh.slice_type != SLICE_I:
            ctx = 0
            if self._avail(x0 - 1, y0) and self.skip[y0 >> 2, (x0 - 1) >> 2]:
                ctx += 1
            if self._avail(x0, y0 - 1) and self.skip[(y0 - 1) >> 2, x0 >> 2]:
                ctx += 1
            skip = bool(dec(OFF["SKIP"] + ctx))
        self.skip[reg] = skip
        if skip:
            mv = self._merge(x0, y0, size, self._merge_idx())
            self._inter(x0, y0, size, mv, residual=False)
        else:
            intra = sh.slice_type == SLICE_I or bool(dec(OFF["PRED_MODE"]))
            if intra:
                self._intra_cu(x0, y0, log2)
            else:
                if not dec(OFF["PART_MODE"]):
                    raise DecodeError("inter partition other than 2Nx2N")
                if dec(OFF["MERGE_FLAG"]):
                    mv = self._merge(x0, y0, size, self._merge_idx())
                    root = 1
                else:
                    mvd = self._mvd()
                    cand = self._amvp(x0, y0, size)[dec(OFF["MVP_FLAG"])]
                    mv = tuple(((c + d + 32768) & 0xFFFF) - 32768
                               for c, d in zip(cand, mvd))
                    root = dec(OFF["ROOT_CBF"])
                self._inter(x0, y0, size, mv, residual=bool(root), log2=log2)
        # the CU's QpY (8.6.1), with the delta coded so far in its group
        qpy = (self.qp_pred + self.dqp + 52) % 52
        self.qp[reg] = qpy
        self.last_qp = qpy
        for tb in self.cu_tbs:
            c = tb[0]
            if c == 0:
                tb[5] = qpy
            else:
                off = (p.cb_qp_offset + sh.cb_qp_offset if c == 1
                       else p.cr_qp_offset + sh.cr_qp_offset)
                tb[5] = predict.chroma_qp(min(max(qpy + off, 0), 57))

    def _start_qg(self, x0, y0):
        """qPY_PRED at the first CU of each quantization group (8.6.1)."""
        m = self.qg_size - 1
        xq, yq = x0 & ~m, y0 & ~m
        if (xq, yq) == self.qg:
            return
        first = self.qg is None
        self.qg = (xq, yq)
        prev = self.sh.qp if first else self.last_qp
        ctb = self.p.ctb_log2
        qa = qb = prev
        if self._avail(xq - 1, yq) and (xq - 1) >> ctb == xq >> ctb:
            qa = int(self.qp[yq >> 2, (xq - 1) >> 2])
        if self._avail(xq, yq - 1) and (yq - 1) >> ctb == yq >> ctb:
            qb = int(self.qp[(yq - 1) >> 2, xq >> 2])
        self.qp_pred = (qa + qb + 1) >> 1

    # ---------------------------------------------------------------- inter
    def _merge_idx(self) -> int:
        cmax = self.sh.max_merge_cand - 1
        if cmax <= 0:
            return 0
        if not self.cab.decode(OFF["MERGE_IDX"]):
            return 0
        idx = 1
        while idx < cmax and self.cab.bypass():
            idx += 1
        return idx

    def _egk(self, k: int) -> int:
        v = 0
        while self.cab.bypass():
            v += 1 << k
            k += 1
        return v + self.cab.bypass_bins(k)

    def _mvd(self):
        dec = self.cab.decode
        g0 = [dec(OFF["MVD"]), dec(OFF["MVD"])]
        g1 = [dec(OFF["MVD"] + 1) if g0[i] else 0 for i in range(2)]
        out = []
        for i in range(2):
            a = 0
            if g0[i]:
                a = 1
                if g1[i]:
                    a = 2 + self._egk(1)
                if self.cab.bypass():
                    a = -a
            out.append(a)
        return tuple(out)

    def _pu_motion(self, x, y):
        """Motion of the inter PU covering (x, y), or None when that is
        outside the picture, not decoded yet, or intra (6.4.2)."""
        if not self._avail(x, y):
            return None
        ux, uy = x >> 2, y >> 2
        if self.intra[uy, ux]:
            return None
        return (int(self.mv[uy, ux, 0]), int(self.mv[uy, ux, 1]))

    def _merge(self, x, y, s, idx):
        """Merge candidate `idx` of a 2Nx2N PU in a P slice (8.5.3.2.2 to
        8.5.3.2.5; no temporal candidate)."""
        m = self._pu_motion
        a1, b1 = m(x - 1, y + s - 1), m(x + s - 1, y - 1)
        b0, a0, b2 = m(x + s, y - 1), m(x - 1, y + s), m(x - 1, y - 1)
        cand = []
        if a1 is not None:
            cand.append(a1)
        if b1 is not None and b1 != a1:
            cand.append(b1)
        if b0 is not None and b0 != b1:
            cand.append(b0)
        if a0 is not None and a0 != a1:
            cand.append(a0)
        if b2 is not None and b2 != a1 and b2 != b1 and len(cand) < 4:
            cand.append(b2)
        while len(cand) < self.sh.max_merge_cand:
            cand.append((0, 0))
        return cand[idx]

    def _amvp(self, x, y, s):
        """The two motion vector predictors of a 2Nx2N PU whose one
        reference is every neighbour's (8.5.3.2.6, 8.5.3.2.7)."""
        m = self._pu_motion
        a0, a1 = m(x - 1, y + s), m(x - 1, y + s - 1)
        b = next((v for v in (m(x + s, y - 1), m(x + s - 1, y - 1),
                              m(x - 1, y - 1)) if v is not None), None)
        scaled = a0 is not None or a1 is not None
        a = a0 if a0 is not None else a1
        if not scaled:
            a = b
        cand = []
        if a is not None:
            cand.append(a)
        if b is not None and b != a:
            cand.append(b)
        while len(cand) < 2:
            cand.append((0, 0))
        return cand

    def _inter(self, x0, y0, size, mv, residual, log2=None):
        reg = self._region(x0, y0, size)
        self.intra[reg] = False
        self.mv[reg] = mv
        self.inter_cus.append((x0, y0, size, mv[0], mv[1]))
        if residual:
            self._transform_tree(x0, y0, x0, y0, log2, 0, 0, intra=False,
                                 max_depth=self.p.max_tr_depth_inter,
                                 isplit=False, cb=1, cr=1, modes=None)
        else:
            self.n_tu += 1
            self.tu[reg] = self.n_tu
            self.nz[reg] = False

    # ---------------------------------------------------------------- intra
    def _mpm(self, x, y):
        def cand(xn, yn, above):
            if not self._avail(xn, yn):
                return 1
            ux, uy = xn >> 2, yn >> 2
            if not self.intra[uy, ux]:
                return 1
            if above and yn < ((y >> self.p.ctb_log2) << self.p.ctb_log2):
                return 1
            return int(self.ipm[uy, ux])
        a, b = cand(x - 1, y, False), cand(x, y - 1, True)
        if a == b:
            if a < 2:
                return [0, 1, 26]
            return [a, 2 + ((a + 29) % 32), 2 + ((a - 2 + 1) % 32)]
        third = 0 if 0 not in (a, b) else (1 if 1 not in (a, b) else 26)
        return [a, b, third]

    def _intra_cu(self, x0, y0, log2):
        p, cab = self.p, self.cab
        dec, byp = cab.decode, cab.bypass
        size = 1 << log2
        reg = self._region(x0, y0, size)
        self.intra[reg] = True
        self.mv[reg] = 0
        nxn = False
        if log2 == p.min_cb_log2:
            nxn = not dec(OFF["PART_MODE"])
        parts = 4 if nxn else 1
        h = size >> 1 if nxn else size
        flags = [dec(OFF["INTRA_LUMA"]) for _ in range(parts)]
        modes = []
        for i in range(parts):
            px = x0 + (Z4[i][0] * h if nxn else 0)
            py = y0 + (Z4[i][1] * h if nxn else 0)
            mpm = self._mpm(px, py)
            if flags[i]:
                k = byp()
                if k:
                    k += byp()
                mode = mpm[k]
            else:
                mode = cab.bypass_bins(5)
                for c in sorted(mpm):
                    if mode >= c:
                        mode += 1
            self.ipm[self._region(px, py, h)] = mode
            modes.append(mode)
        cm = 4
        if dec(OFF["INTRA_CHROMA"]):
            cm = cab.bypass_bins(2)
        if cm == 4:
            chroma = modes[0]
        else:
            chroma = (0, 26, 10, 1)[cm]
            if chroma == modes[0]:
                chroma = 34
        self._transform_tree(x0, y0, x0, y0, log2, 0, 0, intra=True,
                             max_depth=p.max_tr_depth_intra + int(nxn),
                             isplit=nxn, cb=1, cr=1,
                             modes=(modes, chroma, x0, y0, h))

    # ------------------------------------------------------- transform tree
    def _transform_tree(self, x0, y0, xb, yb, log2, depth, blk, *, intra,
                        max_depth, isplit, cb, cr, modes):
        p, dec = self.p, self.cab.decode
        if (log2 <= p.max_tb_log2 and log2 > p.min_tb_log2
                and depth < max_depth and not (isplit and depth == 0)):
            split = dec(OFF["SPLIT_TU"] + 5 - log2)
        else:
            split = log2 > p.max_tb_log2 or (isplit and depth == 0)
        if log2 > 2:
            cb = dec(OFF["CBF_CHROMA"] + depth) if (depth == 0 or cb) else 0
            cr = dec(OFF["CBF_CHROMA"] + depth) if (depth == 0 or cr) else 0
        if split:
            h = 1 << (log2 - 1)
            for i, (dx, dy) in enumerate(Z4):
                self._transform_tree(x0 + dx * h, y0 + dy * h, x0, y0,
                                     log2 - 1, depth + 1, i, intra=intra,
                                     max_depth=max_depth, isplit=isplit,
                                     cb=cb, cr=cr, modes=modes)
            return
        luma = 1
        if intra or depth != 0 or cb or cr:
            luma = dec(OFF["CBF_LUMA"] + (1 if depth == 0 else 0))
        self._transform_unit(x0, y0, xb, yb, log2, blk, luma, cb, cr, intra,
                             modes)

    def _transform_unit(self, x0, y0, xb, yb, log2, blk, cbf_l, cbf_cb,
                        cbf_cr, intra, modes):
        size = 1 << log2
        reg = self._region(x0, y0, size)
        self.n_tu += 1
        self.tu[reg] = self.n_tu
        self.nz[reg] = bool(cbf_l)
        if intra:
            self.n_order += 1
            self.order[reg] = self.n_order
            pus, cmode = modes[0], modes[1]
            lmode = pus[self._pu_index(x0, y0, modes) if len(pus) == 4
                        else 0]
        else:
            lmode = cmode = None
        if (cbf_l or cbf_cb or cbf_cr) and self.p.cu_qp_delta \
                and not self.dqp_coded:
            self._cu_qp_delta()
        o = self.n_order
        lv = self._residual(log2, 0, lmode) if cbf_l else None
        self._tb(0, x0, y0, size, lv, o, intra, lmode)
        chroma = None
        if log2 > 2:
            chroma = (x0 >> 1, y0 >> 1, log2 - 1)
        elif blk == 3:
            chroma = (xb >> 1, yb >> 1, 2)
        if chroma is not None:
            cx, cy, cl = chroma
            for c, f in ((1, cbf_cb), (2, cbf_cr)):
                lv = self._residual(cl, c, cmode) if f else None
                self._tb(c, cx, cy, 1 << cl, lv, o, intra, cmode)

    @staticmethod
    def _pu_index(x0, y0, modes):
        _, _, cx, cy, h = modes
        return ((y0 - cy) // h) * 2 + (x0 - cx) // h

    def _tb(self, c, x, y, n, levels, order, intra, mode):
        if levels is None and not intra:
            return
        tb = [c, x, y, n, levels, 0, order, intra, mode]
        self.cu_tbs.append(tb)
        self.tbs.append(tb)

    def _cu_qp_delta(self):
        dec = self.cab.decode
        v = 0
        if dec(OFF["DQP"]):
            v = 1
            while v < 5 and dec(OFF["DQP"] + 1):
                v += 1
            if v == 5:
                v += self._egk(0)
        if v and self.cab.bypass():
            v = -v
        self.dqp = v
        self.dqp_coded = True

    # --------------------------------------------------------- residual
    def _residual(self, log2, c, mode):
        """residual_coding (7.3.8.11): levels (n, n) [y][x]."""
        cab = self.cab
        dec, byp = cab.decode, cab.bypass
        n = 1 << log2
        scan = predict.scan_index(log2, c, mode is not None,
                                  mode if mode is not None else 0)
        if c == 0:
            off, shift = 3 * (log2 - 2) + ((log2 - 1) >> 2), (log2 + 1) >> 2
        else:
            off, shift = 15, log2 - 2
        cmax = (log2 << 1) - 1
        lx_ctx, ly_ctx = OFF["LAST_X"] + off, OFF["LAST_Y"] + off
        px = 0
        while px < cmax and dec(lx_ctx + (px >> shift)):
            px += 1
        py = 0
        while py < cmax and dec(ly_ctx + (py >> shift)):
            py += 1
        lx, ly = px, py
        if px > 3:
            k = (px >> 1) - 1
            lx = (1 << k) * (2 + (px & 1)) + cab.bypass_bins(k)
        if py > 3:
            k = (py >> 1) - 1
            ly = (1 << k) * (2 + (py & 1)) + cab.bypass_bins(k)
        if scan == 2:
            lx, ly = ly, lx
        if lx >= n or ly >= n:
            raise DecodeError("last significant position outside the block")
        nsb = n >> 2
        sbs = predict.SCANS[(nsb, scan)]
        pos = predict.SCANS[(4, scan)]
        last_sb = sbs.index((lx >> 2, ly >> 2))
        last_pos = pos.index((lx & 3, ly & 3))
        csbf = [[0] * (nsb + 1) for _ in range(nsb + 1)]
        levels = np.zeros((n, n), dtype=np.int64)
        gt1_base = OFF["GT1"] + (16 if c else 0)
        gt2_base = OFF["GT2"] + (4 if c else 0)
        csbf_base = OFF["CSBF"] + (2 if c else 0)
        c1 = 1
        hide = self.p.sign_hiding
        for i in range(last_sb, -1, -1):
            xs, ys = sbs[i]
            infer_dc = False
            if 0 < i < last_sb:
                ctx = min(1, csbf[xs + 1][ys] + csbf[xs][ys + 1])
                csbf[xs][ys] = dec(csbf_base + ctx)
                infer_dc = True
            else:
                csbf[xs][ys] = 1
            sig = []
            if i == last_sb:
                sig.append(last_pos)
                start = last_pos - 1
            else:
                start = 15
            if csbf[xs][ys]:
                prev = csbf[xs + 1][ys] + 2 * csbf[xs][ys + 1]
                tab = _sig_contexts(log2, c, scan, prev, xs == 0 and ys == 0)
                for k in range(start, -1, -1):
                    if k == 0 and infer_dc:
                        sig.append(0)
                        break
                    if dec(tab[k]):
                        sig.append(k)
                        infer_dc = False
            if not sig:
                continue
            ctx_set = 0 if (i == 0 or c > 0) else 2
            if c1 == 0:
                ctx_set += 1
            c1 = 1
            g1 = [0] * 16
            first_g1 = -1
            for k in sig[:8]:
                f = dec(gt1_base + 4 * ctx_set + c1)
                g1[k] = f
                if f:
                    c1 = 0
                    if first_g1 < 0:
                        first_g1 = k
                elif 0 < c1 < 3:
                    c1 += 1
            g2 = dec(gt2_base + ctx_set) if first_g1 >= 0 else 0
            hidden = hide and (sig[0] - sig[-1] > 3)
            signs = [0] * 16
            for k in sig:
                if not (hidden and k == sig[-1]):
                    signs[k] = byp()
            rice = 0
            total = 0
            for num, k in enumerate(sig):
                base = 1 + g1[k] + (g2 if k == first_g1 else 0)
                want = (3 if k == first_g1 else 2) if num < 8 else 1
                level = base
                if base == want:
                    prefix = 0
                    while byp():
                        prefix += 1
                        if prefix > 32:
                            raise DecodeError("coefficient prefix too long")
                    if prefix <= 3:
                        rem = (prefix << rice) + cab.bypass_bins(rice)
                    else:
                        rem = (((1 << (prefix - 3)) + 2) << rice) \
                            + cab.bypass_bins(prefix - 3 + rice)
                    level = base + rem
                    if level > 3 * (1 << rice):
                        rice = min(rice + 1, 4)
                total += level
                if signs[k]:
                    level = -level
                if hidden and k == sig[-1] and total & 1:
                    level = -level
                xp, yp = pos[k]
                levels[(ys << 2) + yp, (xs << 2) + xp] = level
        return levels

    # ------------------------------------------------------- reconstruction
    def _reconstruct(self):
        p = self.p
        H, W = self.H, self.W
        rec = [np.zeros((H, W), dtype=np.int64),
               np.zeros((H // 2, W // 2), dtype=np.int64),
               np.zeros((H // 2, W // 2), dtype=np.int64)]
        resid = self._residuals()
        if self.inter_cus:
            cus = np.array(self.inter_cus, dtype=np.int64)
            for s in np.unique(cus[:, 2]):
                g = cus[cus[:, 2] == s]
                for c in range(3):
                    sub = 1 if c else 0
                    n = int(s) >> sub
                    blocks = predict.motion_compensate(
                        self.ref[c], g[:, 0] >> sub, g[:, 1] >> sub, n,
                        g[:, 3], g[:, 4], chroma=bool(c))
                    _put(rec[c], g[:, 0] >> sub, g[:, 1] >> sub, blocks)
            self.inter_pred = rec[0].copy()
            for tb, r in resid:
                if not tb[7]:
                    c, x, y, n = tb[:4]
                    rec[c][y:y + n, x:x + n] += r
            for c in range(3):
                np.clip(rec[c], 0, 255, out=rec[c])
        order = self.order
        rmap = {id(tb): r for tb, r in resid}
        for tb in sorted((t for t in self.tbs if t[7]),
                         key=lambda t: (t[6], t[0])):
            c, x, y, n, _, _, o, _, mode = tb
            sub = 1 if c else 0

            def avail(xs, ys, sub=sub, o=o):
                u = order[(ys << sub) >> 2, (xs << sub) >> 2]
                return (u >= 0) & (u < o)
            left, top = predict.reference_samples(rec[c], avail, x, y, n)
            left, top = predict.filter_references(
                left, top, n, mode, c == 0, p.strong_intra_smoothing)
            pred = predict.intra_predict(left, top, n, mode, c == 0)
            r = rmap.get(id(tb))
            if r is not None:
                pred = pred + r
            rec[c][y:y + n, x:x + n] = np.clip(pred, 0, 255)
        if self.sh.deblocking:
            maps = dict(tu=self.tu, intra=self.intra, nz=self.nz, mv=self.mv,
                        qp=self.qp)
            rec = list(filters.deblock(
                rec, maps, beta_off=self.sh.beta_offset_div2,
                tc_off=self.sh.tc_offset_div2,
                cb_offset=p.cb_qp_offset, cr_offset=p.cr_qp_offset))
        out = []
        for c in range(3):
            s = self.sao[c]
            on = self.sh.sao_luma if c == 0 else self.sh.sao_chroma
            plane = rec[c]
            if on:
                plane = filters.sao_plane(plane, p.ctb >> (1 if c else 0),
                                          s["typ"], s["off"], s["band"],
                                          s["eo"])
            out.append(plane.astype(np.uint8))
        return tuple(out)

    def _residuals(self):
        """(tb, residual) of every block with coefficients, the inverse
        transforms batched by size."""
        groups = {}
        for tb in self.tbs:
            if tb[4] is None:
                continue
            c, n, intra = tb[0], tb[3], tb[7]
            dst = c == 0 and n == 4 and intra
            groups.setdefault((n, dst), []).append(tb)
        out = []
        for (n, dst), tbs in groups.items():
            lv = np.stack([t[4] for t in tbs])
            qps = np.array([t[5] for t in tbs], dtype=np.int64)
            r = predict.residuals(lv, qps, dst)
            out += list(zip(tbs, r))
        return out


@functools.lru_cache(maxsize=None)
def _sig_contexts(log2, c, scan, prev, dc_block):
    """Context index of sig_coeff_flag at each scan position 0..15 of a
    sub-block (9.3.4.2.5): block size, component, scan, the coded flags of
    the sub-blocks right (1) and below (2), and whether the sub-block holds
    the DC."""
    pos = predict.SCANS[(4, scan)]
    out = []
    for k in range(16):
        xp, yp = pos[k]
        if log2 == 2:
            sc = CTX_IDX_MAP[(yp << 2) + xp] if k < 15 else 0
        elif dc_block and xp + yp == 0:
            sc = 0
        else:
            if prev == 0:
                t = xp + yp
                sc = 2 if t == 0 else (1 if t < 3 else 0)
            elif prev == 1:
                sc = 2 if yp == 0 else (1 if yp == 1 else 0)
            elif prev == 2:
                sc = 2 if xp == 0 else (1 if xp == 1 else 0)
            else:
                sc = 2
            if c == 0 and not dc_block:
                sc += 3
            if log2 == 3:
                sc += 9 if scan == 0 else 15
            else:
                sc += 21 if c == 0 else 12
        out.append(OFF["SIG"] + (27 if c else 0) + sc)
    return tuple(out)


def _put(plane, xs, ys, blocks):
    n = blocks.shape[1]
    ar = np.arange(n)
    plane[ys[:, None, None] + ar[None, :, None],
          xs[:, None, None] + ar[None, None, :]] = blocks
