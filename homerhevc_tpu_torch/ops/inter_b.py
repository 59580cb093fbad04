"""Decoder-exact B-slice motion derivation: two-list merge candidates with
combined bi-predictive candidates (spec 8.5.3.2.3/.4), per-list AMVP with
the normative MV scaling (8.5.3.2.6/.8), and the sequential decision walk.

Role of the reference's B-frame paths in hmr_motion_inter.c (bi ME :1279,
weighted average :2903, list loop :2556). Our operating point: one
reference per list (L0 = past, L1 = future picture), CU = PU = 2Nx2N.

Motion is (pf0, pf1, mv0, mv1) per block; ref indices are always 0.

The port's own copy of homerhevc_tpu/ops/inter_b.py (numpy only).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# combined bi-predictive candidate index pairs (spec Table 8-8 order)
_COMB = ((0, 1), (1, 0), (0, 2), (2, 0), (1, 2), (2, 1),
         (0, 3), (3, 0), (1, 3), (3, 1), (2, 3), (3, 2))


@dataclass
class BMotion:
    """Full motion of one block: prediction flags + MVs per list."""
    pf0: bool
    pf1: bool
    mv0: tuple
    mv1: tuple

    def key(self):
        return (self.pf0, self.pf1,
                self.mv0 if self.pf0 else (0, 0),
                self.mv1 if self.pf1 else (0, 0))


class BMotionField:
    """Unit-granular (4x4) motion state of a B picture in decode order."""

    def __init__(self, uh, uw):
        self.uh, self.uw = uh, uw
        self.pf = np.zeros((uh, uw, 2), bool)
        self.mv = np.zeros((uh, uw, 2, 2), np.int32)   # [..., list, xy]
        self.coded = np.zeros((uh, uw), bool)

    def at(self, x, y):
        if x < 0 or y < 0 or x >= self.uw * 4 or y >= self.uh * 4:
            return None
        ux, uy = x // 4, y // 4
        if not self.coded[uy, ux]:
            return None
        return BMotion(bool(self.pf[uy, ux, 0]), bool(self.pf[uy, ux, 1]),
                       tuple(int(v) for v in self.mv[uy, ux, 0]),
                       tuple(int(v) for v in self.mv[uy, ux, 1]))

    def set_cu(self, x0, y0, size, m: BMotion):
        ux, uy, un = x0 // 4, y0 // 4, size // 4
        self.pf[uy:uy + un, ux:ux + un] = (m.pf0, m.pf1)
        self.mv[uy:uy + un, ux:ux + un, 0] = m.mv0
        self.mv[uy:uy + un, ux:ux + un, 1] = m.mv1
        self.coded[uy:uy + un, ux:ux + un] = True


def scale_mv(mv, tb, td):
    """Normative temporal MV scaling (spec 8.5.3.2.8 / 8.5.3.2.6)."""
    if td == tb:
        return tuple(mv)
    tx = int((16384 + (abs(td) >> 1)) / td)      # division toward zero
    dsf = max(-4096, min(4095, (tb * tx + 32) >> 6))
    out = []
    for c in mv:
        p = dsf * int(c)
        s = -1 if p < 0 else 1
        out.append(max(-32768, min(32767, s * ((abs(p) + 127) >> 8))))
    return tuple(out)


def merge_candidates_b(fld: BMotionField, x0, y0, size, max_cand=5):
    """B merge list: spatial (full-motion pruning), combined bi, zeros."""
    a1 = fld.at(x0 - 1, y0 + size - 1)
    b1 = fld.at(x0 + size - 1, y0 - 1)
    b0 = fld.at(x0 + size, y0 - 1)
    a0 = fld.at(x0 - 1, y0 + size)
    b2 = fld.at(x0 - 1, y0 - 1)

    cands = []
    n_spatial = 0
    if a1 is not None:
        cands.append(a1)
        n_spatial += 1
    if b1 is not None:
        n_spatial += 1
        if a1 is None or b1.key() != a1.key():
            cands.append(b1)
    if b0 is not None:
        n_spatial += 1
        if b1 is None or b0.key() != b1.key():
            cands.append(b0)
    if a0 is not None:
        n_spatial += 1
        if a1 is None or a0.key() != a1.key():
            cands.append(a0)
    if n_spatial != 4 and b2 is not None:
        if ((a1 is None or b2.key() != a1.key())
                and (b1 is None or b2.key() != b1.key())):
            cands.append(b2)
    cands = cands[:max_cand]

    # combined bi-predictive candidates (8.5.3.2.4); L0/L1 refs are distinct
    # pictures here so the POC-difference condition always holds.
    n_orig = len(cands)
    if n_orig > 1 and len(cands) < max_cand:
        for (i0, i1) in _COMB:
            if i0 >= n_orig or i1 >= n_orig:
                continue
            c0, c1 = cands[i0], cands[i1]
            if c0.pf0 and c1.pf1:
                cands.append(BMotion(True, True, c0.mv0, c1.mv1))
                if len(cands) == max_cand:
                    break

    while len(cands) < max_cand:
        cands.append(BMotion(True, True, (0, 0), (0, 0)))
    return cands


def inter_bs_maps_b(fld: BMotionField, tu_size: int, cbf_y_unit: np.ndarray):
    """Deblocking bs maps for an all-inter B picture on a uniform CU=TU
    grid (spec 8.7.2.4: bS 1 on block edges with cbf, different prediction
    (flags) or >= 4 quarter-pel MV difference in any used list; L0/L1 refs
    are distinct pictures so no swapped-assignment check applies)."""
    uh, uw = cbf_y_unit.shape
    step = tu_size // 4

    def diff(sl_p, sl_q):
        pf_ne = (fld.pf[sl_p] != fld.pf[sl_q]).any(-1)
        mv_d = np.abs(fld.mv[sl_q].astype(np.int64)
                      - fld.mv[sl_p].astype(np.int64))
        used = fld.pf[sl_p] & fld.pf[sl_q]              # (.., 2)
        mv_big = (mv_d.max(-1) >= 4) & used
        return pf_ne | mv_big.any(-1)

    sl_l = (slice(None), slice(None, -1))
    sl_r = (slice(None), slice(1, None))
    bs_left = np.zeros((uh, uw - 1), np.int32)
    edge = np.zeros((uh, uw - 1), bool)
    edge[:, step - 1::step] = True                       # unit col multiple of step
    cond = edge & ((cbf_y_unit[sl_l] | cbf_y_unit[sl_r]) | diff(sl_l, sl_r))
    bs_left[cond] = 1
    sl_t = (slice(None, -1), slice(None))
    sl_b = (slice(1, None), slice(None))
    bs_top = np.zeros((uh - 1, uw), np.int32)
    edge_h = np.zeros((uh - 1, uw), bool)
    edge_h[step - 1::step, :] = True
    cond = edge_h & ((cbf_y_unit[sl_t] | cbf_y_unit[sl_b]) | diff(sl_t, sl_b))
    bs_top[cond] = 1

    bs_v = np.zeros((uh, uw // 2), np.int32)
    bs_v[:, 1:] = bs_left[:, 1::2]
    bs_h = np.zeros((uh // 2, uw), np.int32)
    bs_h[1:, :] = bs_top[1::2, :]
    return bs_v, bs_h


def amvp_candidates_b(fld: BMotionField, x0, y0, size, lst: int,
                      poc_cur: int, poc_ref: tuple):
    """AMVP list for list `lst` (refIdx 0). poc_ref = (poc_l0, poc_l1).

    Two-pass same-POC check, then the scaling pass (8.5.3.2.6) — with one
    ref per list the same-list pass hits whenever the neighbor uses this
    list; the scaled cross-list pass covers uni-directional neighbors of the
    other list.
    """
    other = 1 - lst
    tgt = poc_ref[lst]

    def passes(n: BMotion):
        if n is None:
            return None
        # pass 1: same list, same ref POC (always same here)
        if (n.pf0, n.pf1)[lst]:
            return (n.mv0, n.mv1)[lst]
        return None

    def scaled(n: BMotion):
        """The scaled pass (spec step 7): per neighbor, same list FIRST
        (identity scaling when its ref POC equals the target — still a
        produced candidate!), then the other list with real scaling."""
        if n is None:
            return None
        tb = poc_cur - tgt
        if (n.pf0, n.pf1)[lst]:
            td = poc_cur - poc_ref[lst]
            return scale_mv((n.mv0, n.mv1)[lst], tb, td)
        if (n.pf0, n.pf1)[other]:
            td = poc_cur - poc_ref[other]
            return scale_mv((n.mv0, n.mv1)[other], tb, td)
        return None

    a0 = fld.at(x0 - 1, y0 + size)
    a1 = fld.at(x0 - 1, y0 + size - 1)
    b0 = fld.at(x0 + size, y0 - 1)
    b1 = fld.at(x0 + size - 1, y0 - 1)
    b2 = fld.at(x0 - 1, y0 - 1)

    def first(fns, ns):
        for fn in fns:
            for n in ns:
                v = fn(n)
                if v is not None:
                    return tuple(v)
        return None

    # A side: same-list/cross-list without scaling are passes 1-2; the
    # scaled pass runs over both lists in neighbor order (spec ordering:
    # per neighbor, list X then list Y — cross() here is the only scaled
    # variant needed since same-list never requires scaling with 1 ref).
    mv_a = first([passes], [a0, a1])
    if mv_a is None:
        mv_a = first([scaled], [a0, a1])
    is_scaled = a0 is not None or a1 is not None

    mv_b = first([passes], [b0, b1, b2])
    if not is_scaled:
        # spec 8.5.3.2.6: with no left neighbors, the A slot takes the
        # unscaled B candidate and B is re-derived with scaling.
        if mv_b is not None and mv_a is None:
            mv_a = mv_b
        mv_b = first([scaled], [b0, b1, b2])

    cands = []
    if mv_a is not None:
        cands.append(mv_a)
    if mv_b is not None and (mv_a is None or mv_b != mv_a):
        cands.append(mv_b)
    while len(cands) < 2:
        cands.append((0, 0))
    return cands
