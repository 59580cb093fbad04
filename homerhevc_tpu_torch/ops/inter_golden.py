"""Decoder-exact inter candidate derivation: merge list (spec 8.5.3.2.3) and
AMVP list (spec 8.5.3.2.6), and the merge/skip/AMVP decision walks built on
them.

The port's own copy of the host side of homerhevc_tpu/ops/inter_golden.py
(numpy only): `derive_block_decisions_fast` for the fixed-CU P path, and
`derive_tree_decisions`, the sequential Python walk that libhenc's
henc_derive_tree_decisions is held against. These must match the
conformance decoder's derivation bit-exactly — the encoder signals
*indices* into these lists.

The motion field is unit-granular (4x4 luma units):
  mv      (uh, uw, 2) int32, quarter-pel
  ref_idx (uh, uw) int32: >=0 inter, -1 intra, -2 not yet coded / outside
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class MotionField:
    """Per-4x4-unit coding state for one picture (decode order)."""
    uh: int
    uw: int
    mv: np.ndarray = field(default=None)
    ref_idx: np.ndarray = field(default=None)

    def __post_init__(self):
        if self.mv is None:
            self.mv = np.zeros((self.uh, self.uw, 2), np.int32)
        if self.ref_idx is None:
            self.ref_idx = np.full((self.uh, self.uw), -2, np.int32)

    def unit(self, x: int, y: int):
        """(mv, ref_idx) at luma sample position (x, y); None if unavailable."""
        if x < 0 or y < 0 or x >= self.uw * 4 or y >= self.uh * 4:
            return None
        ux, uy = x // 4, y // 4
        r = int(self.ref_idx[uy, ux])
        if r < 0:
            return None if r == -2 else ("intra",)
        return (int(self.mv[uy, ux, 0]), int(self.mv[uy, ux, 1]), r)

    def set_cu(self, x0: int, y0: int, size: int, mv_xy, ref: int):
        ux, uy, un = x0 // 4, y0 // 4, size // 4
        self.mv[uy:uy + un, ux:ux + un] = mv_xy
        self.ref_idx[uy:uy + un, ux:ux + un] = ref


def _inter_at(fld: MotionField, x: int, y: int):
    u = fld.unit(x, y)
    if u is None or u == ("intra",):
        return None
    return u                                   # (mvx, mvy, ref)


def merge_candidates(fld: MotionField, x0: int, y0: int, size: int,
                     max_cand: int = 5):
    """Spatial + zero merge candidates for a 2Nx2N PU (P slice, no TMVP).

    Returns list of (mvx, mvy, ref) of length max_cand.
    """
    a1 = _inter_at(fld, x0 - 1, y0 + size - 1)
    b1 = _inter_at(fld, x0 + size - 1, y0 - 1)
    b0 = _inter_at(fld, x0 + size, y0 - 1)
    a0 = _inter_at(fld, x0 - 1, y0 + size)
    b2 = _inter_at(fld, x0 - 1, y0 - 1)

    cands = []
    n_spatial = 0
    if a1 is not None:
        cands.append(a1)
        n_spatial += 1
    if b1 is not None:
        n_spatial += 1
        if a1 is None or b1 != a1:
            cands.append(b1)
    if b0 is not None:
        n_spatial += 1
        if b1 is None or b0 != b1:
            cands.append(b0)
    if a0 is not None:
        n_spatial += 1
        if a1 is None or a0 != a1:
            cands.append(a0)
    if n_spatial != 4 and b2 is not None:
        if (a1 is None or b2 != a1) and (b1 is None or b2 != b1):
            cands.append(b2)
    cands = cands[:max_cand]
    while len(cands) < max_cand:
        cands.append((0, 0, 0))               # zero candidates (one ref pic)
    return cands


def amvp_candidates(fld: MotionField, x0: int, y0: int, size: int):
    """AMVP list [mvp0, mvp1] for refIdxL0 = 0 (one reference picture, no
    temporal MVP, so no scaling branches apply)."""
    def first_same_ref(points):
        for (x, y) in points:
            u = _inter_at(fld, x, y)
            if u is not None and u[2] == 0:
                return (u[0], u[1])
        return None

    mv_a = first_same_ref([(x0 - 1, y0 + size), (x0 - 1, y0 + size - 1)])
    mv_b = first_same_ref([(x0 + size, y0 - 1), (x0 + size - 1, y0 - 1),
                           (x0 - 1, y0 - 1)])
    cands = []
    if mv_a is not None:
        cands.append(mv_a)
    if mv_b is not None and (mv_a is None or mv_b != mv_a):
        cands.append(mv_b)
    while len(cands) < 2:
        cands.append((0, 0))
    return cands


def mv_bits_fx(mvx: int, mvy: int) -> int:
    """Deterministic MV bit proxy: 2*bitlen(|c|) + 1 per component. Shared by
    every pipeline (must tie-break identically)."""
    def comp(c):
        return 1 + 2 * abs(int(c)).bit_length()
    return comp(mvx) + comp(mvy)


def derive_tree_decisions(depth_u: np.ndarray, mv_u: np.ndarray,
                          has_resid_u: np.ndarray, ctu_log2: int,
                          max_merge_cand: int = 5, pred_intra_u=None):
    """Sequential host walk over a variable-depth inter CU quadtree.

    depth_u (uh, uw) absolute CU depth per 4x4 unit, mv_u (uh, uw, 2)
    chosen quarter-pel MV per unit (constant over each CU), has_resid_u
    (uh, uw) bool (any nonzero level in the CU). Walks CTUs in raster
    order and CUs in z-order — the decoder's decode order — deriving
    merge/skip/AMVP per CU.

    Returns (dict of per-unit arrays, MotionField).
    """
    uh, uw = depth_u.shape
    H, W = uh * 4, uw * 4
    ctu = 1 << ctu_log2
    fld = MotionField(uh, uw)
    skip_u = np.zeros((uh, uw), bool)
    merge_u = np.zeros((uh, uw), bool)
    midx_u = np.zeros((uh, uw), np.int8)
    mvp_u = np.zeros((uh, uw), np.int8)
    mvd_u = np.zeros((uh, uw, 2), np.int32)

    def leaf(x0, y0, size):
        ux, uy = x0 // 4, y0 // 4
        un = size // 4
        if pred_intra_u is not None and pred_intra_u[uy, ux]:
            # intra CU in a P slice: units unavailable for later inter
            # candidate lists (spec 8.5.3.2.3); no inter syntax derived
            fld.ref_idx[uy:uy + un, ux:ux + un] = -1
            return
        mvx = int(mv_u[uy, ux, 0])
        mvy = int(mv_u[uy, ux, 1])
        hr = bool(has_resid_u[uy:uy + un, ux:ux + un].any())
        mcands = merge_candidates(fld, x0, y0, size, max_merge_cand)
        mi = next((i for i, cd in enumerate(mcands)
                   if cd == (mvx, mvy, 0)), -1)
        if mi >= 0:
            merge_u[uy:uy + un, ux:ux + un] = True
            midx_u[uy:uy + un, ux:ux + un] = mi
            skip_u[uy:uy + un, ux:ux + un] = not hr
        else:
            amvp = amvp_candidates(fld, x0, y0, size)
            b0 = mv_bits_fx(mvx - amvp[0][0], mvy - amvp[0][1])
            b1 = mv_bits_fx(mvx - amvp[1][0], mvy - amvp[1][1])
            k = 0 if b0 <= b1 else 1
            mvp_u[uy:uy + un, ux:ux + un] = k
            mvd_u[uy:uy + un, ux:ux + un] = (mvx - amvp[k][0],
                                             mvy - amvp[k][1])
        fld.set_cu(x0, y0, size, (mvx, mvy), 0)

    def walk(x0, y0, size, depth):
        if x0 >= W or y0 >= H:
            return
        if int(depth_u[y0 // 4, x0 // 4]) > depth:
            h = size // 2
            for (dx, dy) in ((0, 0), (h, 0), (0, h), (h, h)):  # z-order
                walk(x0 + dx, y0 + dy, h, depth + 1)
            return
        leaf(x0, y0, size)

    for y0 in range(0, H, ctu):
        for x0 in range(0, W, ctu):
            walk(x0, y0, ctu, 0)
    return dict(skip=skip_u, merge=merge_u, merge_idx=midx_u,
                mvp_idx=mvp_u, mvd=mvd_u), fld


def derive_block_decisions_fast(mvs: np.ndarray, has_resid: np.ndarray,
                                size: int, max_merge_cand: int = 5):
    """Vectorized merge/skip/AMVP decisions for the all-inter CU-grid
    case (every block inter, CU == grid cell, raster coding order).

    The candidate positions then reduce to neighbor blocks: A1 = left,
    B1 = above, B0 = above-right, B2 = above-left; A0 (below-left) is never
    yet coded in raster order. Equal to the sequential walk
    `derive_tree_decisions` (tests/test_torch_host.py).
    """
    nby, nbx = has_resid.shape
    mv = mvs.astype(np.int64)
    key = mv[..., 0] * (1 << 20) + mv[..., 1]     # pack mv into one int
    NONE = np.int64(1) << 60

    def shift(dr, dc):
        out = np.full((nby, nbx), NONE, np.int64)
        rs = slice(max(dr, 0), nby + min(dr, 0))
        cs = slice(max(dc, 0), nbx + min(dc, 0))
        rd = slice(max(-dr, 0), nby + min(-dr, 0))
        cd = slice(max(-dc, 0), nbx + min(-dc, 0))
        out[rd, cd] = key[rs, cs]
        return out

    a1 = shift(0, -1)
    b1 = shift(-1, 0)
    b0 = shift(-1, 1)
    b2 = shift(-1, -1)
    av_a1 = a1 != NONE
    av_b1 = b1 != NONE
    av_b0 = b0 != NONE
    av_b2 = b2 != NONE

    # Merge list construction, vectorized: candidate k slot values.
    cands = np.full((4, nby, nbx), NONE, np.int64)   # max 4 spatial here
    counts = np.zeros((nby, nbx), np.int32)

    def push(val, cond):
        nonlocal counts
        for k in range(4):
            here = cond & (counts == k)
            cands[k][here] = val[here]
        counts = counts + cond.astype(np.int32)

    push(a1, av_a1)
    push(b1, av_b1 & ~(av_a1 & (b1 == a1)))
    push(b0, av_b0 & ~(av_b1 & (b0 == b1)))
    # A0 never available; B2 considered when fewer than 4 spatial cands
    # available overall (n_spatial = av_a1+av_b1+av_b0 < 4 always true here).
    push(b2, av_b2 & ~(av_a1 & (b2 == a1)) & ~(av_b1 & (b2 == b1)))

    # zero-MV padding occupies remaining slots
    zero_key = np.int64(0)
    merge_idx = np.full((nby, nbx), -1, np.int32)
    for k in range(min(4, max_merge_cand) - 1, -1, -1):
        merge_idx[(cands[k] == key) & (k < counts)] = k
    # zero-mv padded candidate matches when mv == 0 and no earlier match
    if max_merge_cand > 0:
        zmatch = (key == zero_key) & (merge_idx < 0) & (counts < max_merge_cand)
        merge_idx[zmatch] = counts[zmatch]

    merge = merge_idx >= 0
    skip = merge & ~has_resid

    # AMVP: A = A1 (A0 unavailable); B = first of B0, B1, B2.
    def unpack(k):
        x = np.floor_divide(k, 1 << 20)
        y = k - x * (1 << 20)
        # y in [0, 2^20); recenter to signed
        wrap = y >= (1 << 19)
        y = y - wrap * (1 << 20)
        x = x + wrap
        return np.stack([x, y], -1).astype(np.int32)

    mv_a = np.where(av_a1[..., None], unpack(np.where(av_a1, a1, 0)), 0)
    b_key = np.where(av_b0, b0, np.where(av_b1, b1, b2))
    av_b = av_b0 | av_b1 | av_b2
    mv_b = np.where(av_b[..., None], unpack(np.where(av_b, b_key, 0)), 0)
    # candidate list: [A if availA else B, second distinct or zero]
    c0 = np.where(av_a1[..., None], mv_a, np.where(av_b[..., None], mv_b, 0))
    b_dup = av_a1 & av_b & (mv_a == mv_b).all(-1)
    use_b_as_c1 = av_b & av_a1 & ~b_dup
    c1 = np.where(use_b_as_c1[..., None], mv_b, 0)

    def bits(v):
        a = np.abs(v).astype(np.int64)
        bl = np.zeros_like(a)
        x = a.copy()
        while (x > 0).any():
            bl += (x > 0)
            x >>= 1
        return (1 + 2 * bl).sum(-1)

    mvd0 = mvs - c0
    mvd1 = mvs - c1
    b0c = bits(mvd0)
    b1c = bits(mvd1)
    mvp_idx = ((b1c < b0c) & ~merge).astype(np.int8)
    mvd = np.where(merge[..., None], 0,
                   np.where(mvp_idx[..., None].astype(bool), mvd1, mvd0))

    dec = dict(skip=skip, merge=merge,
               merge_idx=np.maximum(merge_idx, 0).astype(np.int8),
               mvp_idx=mvp_idx, mvd=mvd.astype(np.int32))
    uh, uw = nby * size // 4, nbx * size // 4
    fld = MotionField(uh, uw)
    un = size // 4
    fld.mv[:] = np.repeat(np.repeat(mvs, un, 0), un, 1)
    fld.ref_idx[:] = 0
    return dec, fld
