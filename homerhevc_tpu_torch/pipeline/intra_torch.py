"""All-intra (IDR) frame pipeline: CU = TU = B with a closed-loop 35-mode
search, or the two-pass CU quadtree (split RDO) down to 8x8 luma with NxN
leaves and one level of intra TU split.

Port of homerhevc_tpu/pipeline/intra_jax.py (`encode_frame_intra` at CTU 16
and 32 and `encode_frame_intra_ctu64`, one function here, in every
rd_mode, with and without `split_rdo`). The reference's `lax.fori_loop`
over block anti-diagonals (skew 2, the WPP dependency pattern) becomes a
Python loop; every block on a diagonal is processed in one batch.

  * Without split RDO each luma block evaluates all 35 modes closed-loop as
    one batched tensor op; chroma follows with the luma mode.
  * With split RDO, pass A (`_open_loop_maps`) decides modes, CU depths, NxN
    and TU splits for the whole frame open-loop (references from the
    original plane, one dense batch per block size), and pass B walks the
    decided quadtree of every block on the diagonal closed-loop
    (`_follow_unit`).

Predictions of the coded pass come from reconstructed neighbours, so levels
and recon are what a conformant decoder reproduces. Exact int32, equal to
the reference output for output.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import tables
from ..device import I32, const, first_argmin
from ..ops import intra as intra_ops
from ..ops import quant as quant_ops
from ..ops import transforms as tx_ops
from .p_chunk import compact, to4
from .p_torch import _qp_tensor, _upu, to_plane


def _code_blocks(orig, preds, modes, *, size, c_idx, qp, sign_hiding):
    """Transform / quant / SBH / reconstruct predictions `preds` (N, M, n,
    n) of blocks `orig` (N, n, n); `modes` (N, M) picks the mode-dependent
    scan of 4x4 and 8x8-luma TBs. Returns (levels, recon) (N, M, n, n)."""
    log2 = size.bit_length() - 1
    resid = orig[:, None] - preds
    is_dst = c_idx == 0 and size == 4
    coeff = tx_ops.forward_transform(resid, is_dst=is_dst)
    levels = quant_ops.quantize(coeff, qp, log2, is_intra=True)
    if sign_hiding:
        if log2 == 2 or (log2 == 3 and c_idx == 0):
            # mode-dependent scan (7.4.9.11): SBH groups in the TB's scan
            lv_d, lv_h, lv_v = quant_ops.sign_bit_hiding(
                levels, coeff, qp, log2, scan_idx=(0, 1, 2))
            ver = ((modes >= 6) & (modes <= 14))[..., None, None]
            hor = ((modes >= 22) & (modes <= 30))[..., None, None]
            levels = torch.where(ver, lv_v, torch.where(hor, lv_h, lv_d))
        else:
            levels = quant_ops.sign_bit_hiding(levels, coeff, qp, log2)
    r = tx_ops.inverse_transform(quant_ops.dequantize(levels, qp, log2),
                                 is_dst=is_dst)
    any_nz = (levels != 0).any(dim=-1).any(dim=-1)
    r = torch.where(any_nz[..., None, None], r, 0)
    return levels, (preds + r).clamp(0, 255).to(I32)


# rd_mode FAST candidate list (planar, DC, angular every 4th), the
# reference's coarse search round; a +-1/+-2 refinement around the angular
# winner follows in pass A
_FAST_MODES = (0, 1, 2, 6, 10, 14, 18, 22, 26, 30, 34)


@functools.lru_cache(maxsize=None)
def _mode_list(rd_mode: int) -> np.ndarray:
    """The modes a battery evaluates: the FAST subset or all 35 (one array
    per rd_mode, uploaded once per device by `const`)."""
    return np.asarray(_FAST_MODES if rd_mode == 2 else np.arange(35),
                      np.int64)


def encode_block_all_modes(orig, top, left, corner, has_left, has_top, *,
                           size, c_idx, qp, lam_fx, strong_smoothing,
                           sign_hiding=False, mode_set=None):
    """All-35-mode closed-loop encode of N blocks: (levels, recon) (N, M,
    n, n) and cost (N, M) = SSD + lambda * bit estimate, M 35, or
    len(mode_set) when a static subset of modes is given (rd_mode FAST:
    only the subset is transformed and coded)."""
    refs = intra_ops.prepare_refs(top, left, corner, has_left, has_top,
                                  size=size, c_idx=c_idx,
                                  strong_smoothing=strong_smoothing)
    preds = intra_ops.predict_all_modes(*refs, size=size, c_idx=c_idx)
    md = np.arange(35) if mode_set is None else np.asarray(mode_set)
    modes = torch.as_tensor(md, device=orig.device)[None]
    if mode_set is not None:
        preds = preds[:, modes[0]]
    levels, recon = _code_blocks(orig, preds, modes, size=size, c_idx=c_idx,
                                 qp=qp, sign_hiding=sign_hiding)
    diff = orig[:, None] - recon
    ssd = (diff * diff).sum(dim=(-1, -2))
    bits = torch.clamp(tables.level_bits_est_t(levels), max=16383)
    return levels, recon, ssd + (((lam_fx >> 4) * bits) >> 4)


def encode_block_one_mode(orig, top, left, corner, has_left, has_top, m, *,
                          size, c_idx, qp, strong_smoothing, sign_hiding):
    """Closed-loop encode of N blocks with decided modes m (N,): (levels,
    recon) (N, n, n)."""
    refs = intra_ops.prepare_refs(top, left, corner, has_left, has_top,
                                  size=size, c_idx=c_idx,
                                  strong_smoothing=strong_smoothing)
    pred = intra_ops.predict_one_mode(*refs, m, size=size, c_idx=c_idx)
    levels, recon = _code_blocks(orig, pred[:, None], m[:, None], size=size,
                                 c_idx=c_idx, qp=qp, sign_hiding=sign_hiding)
    return levels[:, 0], recon[:, 0]


def _cost_one_mode(orig, top, left, corner, has_left, has_top, m, *, size,
                   qp, lam_fx, strong_smoothing):
    """Open-loop RD cost (N,) of luma blocks at modes m (N,): the rd_mode
    FAST refinement."""
    lev, rec = encode_block_one_mode(orig, top, left, corner, has_left,
                                     has_top, m, size=size, c_idx=0, qp=qp,
                                     strong_smoothing=strong_smoothing,
                                     sign_hiding=False)
    diff = orig - rec
    ssd = (diff * diff).sum(dim=(-1, -2))
    bits = torch.clamp(tables.level_bits_est_t(lev), max=16383)
    return ssd + (((lam_fx >> 4) * bits) >> 4)


# ---------------------------------------------------------------------------
# pass A: open-loop decisions for the whole frame
# ---------------------------------------------------------------------------

def _sum4(a: torch.Tensor) -> torch.Tensor:
    """2x2 sum-pool of a (py, px[, M]) grid over its first two axes."""
    py, px = a.shape[:2]
    return a.reshape((py // 2, 2, px // 2, 2) + a.shape[2:]).sum(dim=(1, 3))


# elements of one open-loop battery batch (blocks x 35 modes x samples):
# bounds the live set of the float64 transform temporaries
_BATTERY_ELEMS = 1 << 23


def _open_loop_maps(y_pad, *, B: int, qp, lam_fx, strong_smoothing: bool,
                    rd_mode: int = 1, tu_split: bool = True, above: int = 0,
                    below: int = 0):
    """Pass A of the two-pass intra quadtree: batched open-loop mode search
    and split decision over the whole frame, one dense pass per block size
    from 4 up to B (16 or 32).

    rd_mode (the reference's HOMER_RD_MODES): 1 FULL, all 35 modes; 2 FAST,
    the 11 modes of _FAST_MODES, then the angular winner refined by +-2 and
    +-1 one mode at a time (each step from the mode the last one kept,
    clipped to 2..34; a planar or DC winner re-evaluates itself); 0
    DIST_ONLY, every decision by distortion alone (lambda 0).

    References come from the ORIGINAL plane, so every block of a size is
    independent. A CU may keep its one mode and split the transform into
    four half-size TBs (`tu_split`): the cost of that is the sum of its
    four children's batteries at the same mode. An 8x8 leaf may instead be
    coded NxN (four 4x4 PUs with their own modes). Every pick is a first
    minimum and every comparison a strict less-than, as in the reference.
    Returns (mode_u, depth_u, part_u, trd_u) unit maps (H/4, W/4); depth 0
    is a CU of size B.

    A band of the frame passes its rows with `above` rows of the picture
    before them and `below` rows after them (parallel/intra_bands.py): the
    maps cover the band's own rows, its first block row sees the row above
    as available, and the left columns that run below the band read the
    rows after it; only the picture's top and bottom clamp."""
    if B not in (16, 32):
        raise NotImplementedError(f"split-RDO intra at B={B} (a 64-CTU runs "
                                  "pass A at B 32)")
    Hx, W = y_pad.shape
    H = Hx - above - below
    dev = y_pad.device
    plane = y_pad.to(I32)
    orig = plane[above:above + H]
    if rd_mode == 0:
        lam_fx = torch.zeros_like(lam_fx)
    subset = _FAST_MODES if rd_mode == 2 else None
    mlist = const(_mode_list(rd_mode), dev)
    ov = ((lam_fx >> 4) * 14) >> 4
    best = {}
    for S in (4, 8, 16, 32)[:B.bit_length() - 2]:
        nby, nbx = H // S, W // S
        ar = torch.arange(2 * S, device=dev)
        rr = torch.arange(nby, device=dev)
        cc = torch.arange(nbx, device=dev)
        ty = (above + rr * S - 1).clamp(min=0)
        lx = (cc * S - 1).clamp(min=0)
        blocks = orig.reshape(nby, S, nbx, S).permute(0, 2, 1, 3)
        top = plane[ty[:, None, None],
                    (cc[None, :, None] * S + ar).clamp(0, W - 1)]
        left = plane[(above + rr[:, None, None] * S + ar).clamp(0, Hx - 1),
                     lx[None, :, None]]
        corner = plane[ty[:, None], lx[None]]
        hl = (cc[None] > 0).expand(nby, nbx)
        ht = ((rr[:, None] > 0) | bool(above)).expand(nby, nbx)
        flat = (blocks.reshape(-1, S, S), top.reshape(-1, 2 * S),
                left.reshape(-1, 2 * S), corner.reshape(-1), hl.reshape(-1),
                ht.reshape(-1))
        step = max(1, _BATTERY_ELEMS // (35 * S * S))
        costs, picks = [], []
        for i in range(0, nby * nbx, step):
            part = tuple(t[i:i + step] for t in flat)
            _, _, cost = encode_block_all_modes(
                *part, size=S, c_idx=0, qp=qp, lam_fx=lam_fx,
                strong_smoothing=strong_smoothing and S == 32,
                sign_hiding=False, mode_set=subset)
            cost = cost.to(I32)
            costs.append(cost)
            if subset is not None:
                m = mlist[first_argmin(cost, 1)]
                bc = cost.min(dim=1).values
                for dm in (-2, -1, 1, 2):
                    mm = torch.where(m >= 2, (m + dm).clamp(2, 34), m)
                    c1 = _cost_one_mode(
                        *part, mm, size=S, qp=qp, lam_fx=lam_fx,
                        strong_smoothing=strong_smoothing and S == 32
                    ).to(I32)
                    take = c1 < bc
                    m = torch.where(take, mm, m)
                    bc = torch.where(take, c1, bc)
                picks.append((m.to(I32), bc))
        costv = torch.cat(costs).reshape(nby, nbx, -1)
        if subset is None:
            best[S] = (first_argmin(costv, 2).to(I32),
                       costv.min(dim=2).values, costv)
        else:
            best[S] = (torch.cat([p[0] for p in picks]).reshape(nby, nbx),
                       torch.cat([p[1] for p in picks]).reshape(nby, nbx),
                       costv)

    tsov = ((lam_fx >> 4) * 8) >> 4     # split flag + extra cbf bins proxy

    def tu_opt(vchild):
        """Best same-mode TU-split cost per parent: (cost, mode)."""
        s = _sum4(vchild)
        return (s.min(dim=2).values + tsov,
                mlist[first_argmin(s, 2)].to(I32))

    m4, c4, v4 = best[4]
    m8, c8, v8 = best[8]
    m16, c16, v16 = best[16]

    def with_tu_split(c, m, vchild):
        if not tu_split:
            return c, m, torch.zeros_like(c, dtype=torch.bool)
        tsc, tsm = tu_opt(vchild)
        trd = tsc < c
        return torch.where(trd, tsc, c), torch.where(trd, tsm, m), trd

    c8, m8, trd8 = with_tu_split(c8, m8, v4)      # 8x8 -> four DST 4x4 TBs
    c16, m16, trd16 = with_tu_split(c16, m16, v8)
    # NxN at the 8x8 leaf: four 4x4 PUs (part bin + 3 more mode signals)
    c4s = _sum4(c4) + (((lam_fx >> 4) * 20) >> 4)
    part8 = c4s < c8
    c8e = torch.where(part8, c4s, c8)
    c8s = _sum4(c8e) + ov
    split16 = c8s < c16
    mm16 = _upu(split16, 16)
    trd8_u = _upu(trd8 & ~part8, 8)
    if B == 16:                      # depth 0 a 16-CU, 1 an 8-CU
        depth_u = mm16.to(I32)
        mode_u = torch.where(mm16, _upu(m8, 8), _upu(m16, 16))
        part_u = mm16 & _upu(part8, 8)
        trd_u = torch.where(mm16, trd8_u, _upu(trd16, 16))
    else:
        m32, c32, _ = best[32]
        c32, m32, trd32 = with_tu_split(c32, m32, v16)
        c16e = torch.where(split16, c8s, c16)
        c16s = _sum4(c16e) + ov
        split32 = c16s < c32
        mm32 = _upu(split32, 32)
        depth_u = torch.where(~mm32, 0, torch.where(~mm16, 1, 2))
        mode_u = torch.where(~mm32, _upu(m32, 32),
                             torch.where(~mm16, _upu(m16, 16), _upu(m8, 8)))
        part_u = mm32 & mm16 & _upu(part8, 8)
        trd_u = torch.where(~mm32, _upu(trd32, 32),
                            torch.where(~mm16, _upu(trd16, 16), trd8_u))
    mode_u = torch.where(part_u, m4, mode_u)            # per-4x4-PU modes
    return mode_u.to(I32), depth_u.to(I32), part_u, trd_u.to(I32)


# ---------------------------------------------------------------------------
# pass B: the decided quadtree, closed-loop, batched over the lanes of a
# diagonal
# ---------------------------------------------------------------------------

# z-order child offsets within a split CU: (cx_half, cy_half)
_Z_CHILDREN = ((0, 0), (1, 0), (0, 1), (1, 1))


def _take(vec, idx):
    """vec[l, idx[l, k]] with idx clamped to the vector (the reference's
    out-of-range reads clamp); vec (L, n), idx (L, k) or (k,)."""
    idx = idx.clamp(0, vec.shape[1] - 1)
    if idx.dim() == 1:
        return vec[:, idx]
    return torch.gather(vec, 1, idx)


def _col(x0):
    """A per-lane start as a column, a static start as it is."""
    return x0[:, None] if isinstance(x0, torch.Tensor) else x0


def _child_refs(trow, lcol, corner_p, rec, cx, cy, n, has_left, has_top, x0,
                W):
    """Reference samples of a child block of size n at (cx, cy) inside its
    parent, for every lane.

    trow (L, w): the row above the parent (w = the plane's width for a row
    of the CTU row above, the grandparent's size for a row inside it); lcol
    (L, p): the column left of the parent; rec (L, P, P): the parent's
    partly filled reconstruction. Regions that later z-order siblings cover
    are read through clipped gathers, which replicate the last available
    sample: the spec 8.4.4.2.2 substitution result."""
    dev = rec.device
    L = rec.shape[0]
    ar = torch.arange(2 * n, device=dev)
    yes = torch.ones((L,), dtype=torch.bool, device=dev)
    if cy == 0:
        top = _take(trow, (_col(x0) + cx + ar).clamp(0, W - 1))
        h_top = has_top
    else:
        top = rec[:, cy - 1, (cx + ar).clamp(0, rec.shape[2] - 1)]
        h_top = yes
    if cx == 0:
        left = _take(lcol, cy + ar)
        h_left = has_left
    else:
        left = rec[:, (cy + ar).clamp(0, cy + n - 1), cx - 1]
        h_left = yes
    if cx == 0 and cy == 0:
        corner = corner_p
    elif cy == 0 and isinstance(x0, torch.Tensor):
        corner = _take(trow, (x0[:, None] + cx - 1).clamp(0, W - 1))[:, 0]
    elif cy == 0:
        corner = trow[:, min(max(x0 + cx - 1, 0), W - 1, trow.shape[1] - 1)]
    elif cx == 0:
        corner = lcol[:, cy - 1]
    else:
        corner = rec[:, cy - 1, cx - 1]
    return top, left, corner, h_left, h_top


def _child_aux(trow, lcol, rec, cx, cy, h, x0, n_parent):
    """(trow, lcol, x0) reference material for a child's own descendants
    (the band clip replicates rows that belong to later z-order siblings)."""
    if cy == 0:
        trow_c, x0_c = trow, x0 + cx
    else:
        trow_c, x0_c = rec[:, cy - 1], cx
    ar = torch.arange(n_parent, device=rec.device)
    if cx == 0:
        lcol_c = _take(lcol, cy + ar)
    else:
        lcol_c = rec[:, (cy + ar).clamp(0, cy + h - 1), cx - 1]
    return trow_c, lcol_c, x0_c


class _Followed:
    """The decided quadtree of the lanes of one diagonal for one component:
    unit maps (L, n, n) on the device, and the depth and NxN maps on the
    host as well, which say where no lane has anything to code."""

    def __init__(self, mode, depth, nxn, depth_h, nxn_h):
        self.mode, self.depth, self.nxn = mode, depth, nxn
        self.depth_h, self.nxn_h = depth_h, nxn_h


def _follow_unit(o, refs, aux, tree: _Followed, uy: int, ux: int, act, *,
                 size: int, depth: int, min_size: int, c_idx: int, qp,
                 sign_hiding: bool, strong_smoothing: bool, W: int):
    """One node of the decided quadtree, for every lane at once: (levels,
    recon) (L, size, size).

    A lane codes the node whole where its map depth equals `depth` and
    descends where it is deeper; an 8x8 luma leaf marked NxN codes four
    z-order 4x4 PUs (DST) with their own modes. The reference computes both
    branches and selects; each branch is a function of the node's inputs
    alone, so a branch that no lane selects (`act`: the lanes that reach
    this node, known on the host) is not computed at all, and the result is
    the same. Lanes outside `act` hold arbitrary values that no caller
    selects."""
    top, left, corner, hl, ht = refs
    trow, lcol, x0 = aux
    hd = tree.depth_h[:, uy, ux]
    leaf_h = act & (hd <= depth) if size > min_size else act
    split_h = act & ~leaf_h
    lev = rec = None
    if leaf_h.any():
        lev, rec = encode_block_one_mode(
            o, top, left, corner, hl, ht, tree.mode[:, uy, ux], size=size,
            c_idx=c_idx, qp=qp,
            strong_smoothing=strong_smoothing and size == 32,
            sign_hiding=sign_hiding)
        if c_idx == 0 and size == 8 and tree.nxn is not None \
                and (leaf_h & tree.nxn_h[:, uy, ux]).any():
            lev_n = torch.zeros_like(lev)
            rec_n = torch.zeros_like(rec)
            for hx, hy in _Z_CHILDREN:
                cx, cy = hx * 4, hy * 4
                t_c, l_c, co_c, hl_c, ht_c = _child_refs(
                    trow, lcol, corner, rec_n, cx, cy, 4, hl, ht, x0, W)
                lv_c, rc_c = encode_block_one_mode(
                    o[:, cy:cy + 4, cx:cx + 4], t_c, l_c, co_c, hl_c, ht_c,
                    tree.mode[:, uy + hy, ux + hx], size=4, c_idx=0, qp=qp,
                    strong_smoothing=False, sign_hiding=sign_hiding)
                lev_n[:, cy:cy + 4, cx:cx + 4] = lv_c
                rec_n[:, cy:cy + 4, cx:cx + 4] = rc_c
            part = tree.nxn[:, uy, ux][:, None, None]
            lev = torch.where(part, lev_n, lev)
            rec = torch.where(part, rec_n, rec)
    if not split_h.any():
        return lev, rec

    h = size // 2
    lev_s = torch.zeros_like(o)
    rec_s = torch.zeros_like(o)
    for hx, hy in _Z_CHILDREN:
        cx, cy = hx * h, hy * h
        refs_c = _child_refs(trow, lcol, corner, rec_s, cx, cy, h, hl, ht,
                             x0, W)
        aux_c = _child_aux(trow, lcol, rec_s, cx, cy, h, x0, size)
        lv_c, rc_c = _follow_unit(
            o[:, cy:cy + h, cx:cx + h], refs_c, aux_c, tree, uy + cy // 4,
            ux + cx // 4, split_h, size=h, depth=depth + 1,
            min_size=min_size, c_idx=c_idx, qp=qp, sign_hiding=sign_hiding,
            strong_smoothing=strong_smoothing, W=W)
        lev_s[:, cy:cy + h, cx:cx + h] = lv_c
        rec_s[:, cy:cy + h, cx:cx + h] = rc_c
    if lev is None:
        return lev_s, rec_s
    split = (tree.depth[:, uy, ux] > depth)[:, None, None]
    return torch.where(split, lev_s, lev), torch.where(split, rec_s, rec)


def _effective_tree(depth_u, part_u, trd_u, tu_split: bool, d8: int = 2):
    """The quadtree pass B follows, with the TU splits folded in (`d8`: the
    depth of an 8x8 CU, 2 in a 32-block, 1 in a 16-CTU).

    A leaf CU whose transform splits one level while keeping its one mode
    re-predicts each half-size TB from in-CU reconstruction, which is the
    same computation as a CU split whose children inherit the mode (the
    mode map is uniform over such a CU already), so it is one more level of
    depth; an 8x8 leaf with a TU split codes four 4x4 TBs like NxN, with
    its one mode. The reference rewrites its followed maps node by node to
    the same effect."""
    if not tu_split:
        return depth_u, part_u
    trd = trd_u > 0
    return (depth_u + (trd & (depth_u < d8)).to(I32),
            part_u | (trd & (depth_u == d8)))


def intra_wire_cap(H: int, W: int) -> int:
    """Compacted I-frame coefficient capacity: half of all 4x4 sub-blocks
    (copy of the reference's host helper)."""
    return ((H // 4) * (W // 4) * 3 // 2) // 2


def pack_intra_wire(lev_yp, lev_up, lev_vp, mode_u, depth_u, part_u, trd_u):
    """Compact I-frame wire, word-identical to the reference's:
    [cnt, units16 (2 per int32), idx, vals (int16 pairs)]."""
    H, W = lev_yp.shape
    L4 = (H // 4) * (W // 4) * 3 // 2
    cap = intra_wire_cap(H, W)
    lv4 = torch.cat([to4(lev_yp), to4(lev_up), to4(lev_vp)])
    nzm = (lv4 != 0).any(dim=1)
    cnt = nzm.sum().to(I32)
    idx = compact(nzm, cap)
    vals = lv4[idx.clamp(max=L4 - 1)]
    vals = torch.where((idx < L4)[:, None], vals, 0).to(torch.int16)
    units = ((mode_u.to(I32) & 63) | (depth_u.to(I32) << 6)
             | (part_u.to(I32) << 8) | (trd_u.to(I32) << 9))
    u32 = units.reshape(-1).to(torch.int16).view(I32)
    return torch.cat([cnt.reshape(1), u32, idx.to(I32),
                      vals.view(I32).reshape(-1)])


def unpack_intra_wire(wire, H: int, W: int):
    """Host inverse of pack_intra_wire (copy of the reference's helper).
    Returns (cnt, mode_u, depth_u, part_u, trd_u, idx, vals (cap, 16))."""
    cap = intra_wire_cap(H, W)
    nu = (H // 4) * (W // 4)
    cnt = int(wire[0])
    o = 1
    u16 = np.ascontiguousarray(wire[o:o + nu // 2]).view(np.int16)
    o += nu // 2
    units = u16.astype(np.int32).reshape(H // 4, W // 4)
    idx = wire[o:o + cap]
    o += cap
    vals = np.ascontiguousarray(wire[o:o + cap * 8]).view(
        np.int16).reshape(cap, 16)
    return (cnt, (units & 63), (units >> 6) & 3,
            ((units >> 8) & 1), ((units >> 9) & 1), idx, vals)


class Wave:
    """The closed-loop wavefront's state over the CTU rows r0 .. r0 + n - 1
    of a frame on one device: the whole frame, or one band of it
    (parallel/intra_bands.py).

    `bot_rows` holds the bottom sample row of every coded CTU of the rows,
    after one row for the CTU row above the first (luma, Cb and Cr side by
    side in one int32 row of 2W samples, so that a band takes it from the
    band above in one copy; zeros at the picture's top, where no lane reads
    it: has_top is false there); `bot` views its three components. `right`
    holds the right column of the last CTU coded in each row, `lev` and
    `rec` the coded blocks (n, nbx, ...). With split RDO, `tree` is these
    rows of `decided_tree`; without it, `mode_cb` receives the mode of
    every top-level block."""

    def __init__(self, y, u, v, *, r0: int, B: int, qp, rd_mode: int = 1,
                 tree=None):
        dev = self.device = y.device
        self.r0, self.B = r0, B
        n, W = self.n, self.W = y.shape[0] // B, y.shape[1]
        nbx = self.nbx = W // B
        B2 = B // 2
        cb = min(B, 32)
        self.qp = _qp_tensor(qp, dev)
        self.qp_c = tables.chroma_qp_t(self.qp)
        lam = const(tables.LAMBDA_FX, dev)[self.qp]
        self.lam = torch.zeros_like(lam) if rd_mode == 0 else lam
        self.mode_set = _FAST_MODES if rd_mode == 2 else None
        self.mlist = const(_mode_list(rd_mode), dev)

        def blocks(p, s):
            return p.to(I32).reshape(n, s, nbx, s).permute(0, 2, 1, 3)

        def z(*shape):
            return torch.zeros(shape, dtype=I32, device=dev)

        self.orig = {"y": blocks(y, B), "u": blocks(u, B2),
                     "v": blocks(v, B2)}
        self.bot_rows = z(n + 1, 2 * W)
        self.bot = {"y": self.bot_rows[:, :W],
                    "u": self.bot_rows[:, W:W + W // 2],
                    "v": self.bot_rows[:, W + W // 2:]}
        self.right = {"y": z(n, B), "u": z(n, B2), "v": z(n, B2)}
        self.lev = {"y": z(n, nbx, B, B), "u": z(n, nbx, B2, B2),
                    "v": z(n, nbx, B2, B2)}
        self.rec = {k: torch.zeros_like(t) for k, t in self.lev.items()}
        self.tree = tree
        self.mode_cb = (None if tree is not None
                        else z(n, nbx, B // cb, B // cb))

    def lanes(self, d: int):
        """(first, last) CTU row of these rows with a lane on diagonal d
        (the rows r with 0 <= d - 2r < nbx), or None."""
        lo = max(self.r0, (d - self.nbx + 2) // 2)
        hi = min(self.r0 + self.n - 1, d // 2)
        return (lo, hi) if lo <= hi else None


def n_diagonals(nby: int, nbx: int) -> int:
    """Anti-diagonals of the wavefront (skew 2) over nby x nbx CTUs."""
    return nbx + 2 * (nby - 1)


def _per_ctu(m, B: int):
    """(H/4, W/4) unit map -> (nby, nbx, B/4, B/4)."""
    k = B // 4
    h, w = m.shape
    return m.reshape(h // k, k, w // k, k).permute(0, 2, 1, 3)


def decided_tree(maps, B: int, tu_on: bool):
    """Pass A's unit maps (mode, depth, NxN, TU split) as the quadtree pass
    B follows, per CTU of size B: (mode, depth, NxN) on the maps' device
    and (depth, NxN) on the host, the one host copy of the decided tree
    (which nodes any lane codes)."""
    mode_u, depth_u, part_u, trd_u = maps
    d8 = (min(B, 32) // 8).bit_length() - 1
    eff_depth, eff_nxn = _effective_tree(depth_u, part_u, trd_u, tu_on, d8)
    mode_blk, depth_blk, nxn_blk = (_per_ctu(m, B) for m in
                                    (mode_u, eff_depth, eff_nxn))
    return (mode_blk, depth_blk, nxn_blk, depth_blk.cpu().numpy(),
            nxn_blk.cpu().numpy())


def run_diagonal(wv: Wave, d: int, *, sign_hiding: bool,
                 strong_smoothing: bool) -> None:
    """Code the lanes of `wv`'s rows on diagonal d, in place; nothing when
    they have none. A lane (r, c) reads the bottom row of the CTU row above
    from column x0 - 1 to x0 + 2B - 1 (CTUs (r-1, c-1) .. (r-1, c+1), coded
    at diagonals d-3 .. d-1) and its own row's left neighbour."""
    lanes = wv.lanes(d)
    if lanes is None:
        return
    dev, B, W = wv.device, wv.B, wv.W
    B2 = B // 2
    cb = min(B, 32)                          # top-level coding block
    cb2 = cb // 2
    kids = ((0, 0),) if cb == B else _Z_CHILDREN
    split_rdo = wv.tree is not None
    rows_h = np.arange(lanes[0], lanes[1] + 1)
    rs = torch.arange(lanes[0], lanes[1] + 1, device=dev)
    ls, ls_h = rs - wv.r0, rows_h - wv.r0    # rows of the state
    cs, cs_h = d - 2 * rs, d - 2 * rows_h
    nl = len(rows_h)
    has_top = rs > 0
    has_left = cs > 0
    x0 = cs * B
    cx0 = cs * B2
    act = np.ones((nl,), bool)
    bot, right, orig = wv.bot, wv.right, wv.orig

    # ---- luma: the top-level blocks of the CTU in z-order ----
    trow, lcol = bot["y"][ls], right["y"][ls]
    corner = torch.gather(trow, 1, (x0 - 1).clamp(0, W - 1)[:, None])[:, 0]
    o = orig["y"][ls, cs]
    lev_l = torch.zeros_like(o)
    rec_l = torch.zeros_like(o)
    if split_rdo:
        mode_blk, depth_blk, nxn_blk, depth_h, nxn_h = wv.tree
        tree = _Followed(mode_blk[ls, cs], depth_blk[ls, cs],
                         nxn_blk[ls, cs], depth_h[ls_h, cs_h],
                         nxn_h[ls_h, cs_h])
    for hx, hy in kids:
        cx, cy = hx * cb, hy * cb
        refs = _child_refs(trow, lcol, corner, rec_l, cx, cy, cb,
                           has_left, has_top, x0, W)
        oc = o[:, cy:cy + cb, cx:cx + cb]
        if split_rdo:
            lv, rc = _follow_unit(
                oc, refs, _child_aux(trow, lcol, rec_l, cx, cy, cb, x0, B),
                tree, cy // 4, cx // 4, act, size=cb, depth=0,
                min_size=8, c_idx=0, qp=wv.qp, sign_hiding=sign_hiding,
                strong_smoothing=strong_smoothing, W=W)
        else:
            lv35, rc35, cost = encode_block_all_modes(
                oc, *refs, size=cb, c_idx=0, qp=wv.qp, lam_fx=wv.lam,
                strong_smoothing=strong_smoothing,
                sign_hiding=sign_hiding, mode_set=wv.mode_set)
            mi = first_argmin(cost, 1)
            lanes_i = torch.arange(nl, device=dev)
            lv, rc = lv35[lanes_i, mi], rc35[lanes_i, mi]
            wv.mode_cb[ls, cs, hy, hx] = wv.mlist[mi].to(I32)
        lev_l[:, cy:cy + cb, cx:cx + cb] = lv
        rec_l[:, cy:cy + cb, cx:cx + cb] = rc
    out = {"y": (lev_l, rec_l)}

    # ---- chroma: the same blocks at half size following the luma
    # modes, U and V as one batch of 2 * nl lanes ----
    two = lambda a: torch.cat([a, a])
    if split_rdo:
        tree_c = _Followed(
            two(tree.mode[:, ::2, ::2]), two(tree.depth[:, ::2, ::2]),
            None, np.concatenate([tree.depth_h[:, ::2, ::2]] * 2), None)
    else:
        k = cb2 // 4                     # chroma units per block side
        m_u = wv.mode_cb[ls, cs].repeat_interleave(k, 1).repeat_interleave(
            k, 2)
        tree_c = _Followed(two(m_u), two(torch.zeros_like(m_u)), None,
                           np.zeros((2 * nl,) + m_u.shape[1:], np.int32),
                           None)
    trow_c = torch.cat([bot["u"][ls], bot["v"][ls]])
    lcol_c = torch.cat([right["u"][ls], right["v"][ls]])
    x0_c = two(cx0)
    corner_c = torch.gather(
        trow_c, 1, (x0_c - 1).clamp(0, W // 2 - 1)[:, None])[:, 0]
    o_c = torch.cat([orig["u"][ls, cs], orig["v"][ls, cs]])
    lev_c = torch.zeros_like(o_c)
    rec_c = torch.zeros_like(o_c)
    for hx, hy in kids:
        cx, cy = hx * cb2, hy * cb2
        refs = _child_refs(trow_c, lcol_c, corner_c, rec_c, cx, cy, cb2,
                           two(has_left), two(has_top), x0_c, W // 2)
        lv, rc = _follow_unit(
            o_c[:, cy:cy + cb2, cx:cx + cb2], refs,
            _child_aux(trow_c, lcol_c, rec_c, cx, cy, cb2, x0_c, B2),
            tree_c, cy // 4, cx // 4, np.ones((2 * nl,), bool), size=cb2,
            depth=0, min_size=4 if split_rdo else cb2, c_idx=1, qp=wv.qp_c,
            sign_hiding=sign_hiding, strong_smoothing=False, W=W // 2)
        lev_c[:, cy:cy + cb2, cx:cx + cb2] = lv
        rec_c[:, cy:cy + cb2, cx:cx + cb2] = rc
    out["u"] = (lev_c[:nl], rec_c[:nl])
    out["v"] = (lev_c[nl:], rec_c[nl:])

    for key, n, xs in (("y", B, x0), ("u", B2, cx0), ("v", B2, cx0)):
        lv, rc = out[key]
        wv.lev[key][ls, cs] = lv
        wv.rec[key][ls, cs] = rc
        cols = xs[:, None] + torch.arange(n, device=dev)
        bot[key][(ls + 1)[:, None], cols] = rc[:, -1, :]
        right[key][ls] = rc[:, :, -1]


def intra_result(lev, rec, *, B: int, maps=None, mode_cb=None) -> dict:
    """The reference's output dict of an intra frame from its coded blocks
    (`lev`, `rec`: per component (nby, nbx, ...)) and pass A's unit maps
    (split RDO) or the modes of the top-level blocks `mode_cb`: modes of
    the top-level blocks, unit maps, block levels, uint8 recon planes, and
    the compact wire, packed from the whole frame's planes."""
    cb = min(B, 32)
    if maps is not None:
        mode_units, depth_units, part_units, trd_units = maps
        modes = mode_units[::cb // 4, ::cb // 4]
        part_units = part_units.to(I32)
    else:
        modes = to_plane(mode_cb)
        mode_units = _upu(modes, cb)
        depth_units = part_units = trd_units = torch.zeros_like(mode_units)
    u8 = torch.uint8
    res = dict(
        modes=modes,
        mode_units=mode_units, depth_units=depth_units,
        part_units=part_units, trd_units=trd_units,
        lev_y=lev["y"], lev_u=lev["u"], lev_v=lev["v"],
        recon_y=to_plane(rec["y"]).to(u8),
        recon_u=to_plane(rec["u"]).to(u8),
        recon_v=to_plane(rec["v"]).to(u8),
    )
    res["wire"] = pack_intra_wire(
        to_plane(lev["y"]), to_plane(lev["u"]), to_plane(lev["v"]),
        mode_units, depth_units, part_units, trd_units)
    return res


def encode_frame_intra(y_pad, u_pad, v_pad, *, B: int, qp,
                       strong_smoothing: bool = True,
                       sign_hiding: bool = False, split_rdo: bool = False,
                       rd_mode: int = 1, tu_depth: int = 0):
    """Encode one padded frame all-intra with B x B CTUs: the reference's
    `encode_frame_intra` at B <= 32 and its `encode_frame_intra_ctu64` at
    B 64. `rd_mode` (1 FULL, 2 FAST, 0 DIST_ONLY) sets the modes and the
    lambda of the mode search: pass A's with split RDO, the closed-loop
    search's without (FAST: the 11-mode subset, no refinement; DIST_ONLY:
    lambda 0).

    The wavefront runs over CTU anti-diagonals (`run_diagonal`). The
    largest intra CU is 32: a 64-CTU codes its four 32-blocks one after
    another in z-order inside the lane, so each reads the reconstruction of
    the ones before it (the top-left block's left references run down the
    left CTU's whole right column, its bottom-right samples included; the
    bottom-right block has no top-right neighbour). Without `split_rdo` a
    block is CU = TU, closed-loop 35-mode search per block (the
    FASTEST_COMPUTATION IDR). With it: the CU quadtree down to 8x8 luma
    (4x4 chroma) decided open-loop by pass A at min(B, 32) and applied
    closed-loop here, with NxN leaves and, for `tu_depth` >= 1, one level
    of TU split; unit depths count from the top-level blocks (a 16-CU is
    depth 0 at CTU 16, where the loop filter's TU size of 32 >> depth is
    the reference's fault 2). Chroma follows the
    luma modes, U and V as one batch. Returns `intra_result`'s dict."""
    H, W = y_pad.shape
    dev = y_pad.device
    qp = _qp_tensor(qp, dev)
    tu_on = bool(tu_depth) and split_rdo
    maps = tree = None
    if split_rdo:
        maps = _open_loop_maps(
            y_pad, B=min(B, 32), qp=qp,
            lam_fx=const(tables.LAMBDA_FX, dev)[qp],
            strong_smoothing=strong_smoothing, rd_mode=rd_mode,
            tu_split=tu_on)
        tree = decided_tree(maps, B, tu_on)
    wv = Wave(y_pad, u_pad, v_pad, r0=0, B=B, qp=qp, rd_mode=rd_mode,
              tree=tree)
    for d in range(n_diagonals(H // B, W // B)):
        run_diagonal(wv, d, sign_hiding=sign_hiding,
                     strong_smoothing=strong_smoothing)
    return intra_result(wv.lev, wv.rec, B=B, maps=maps, mode_cb=wv.mode_cb)
