"""HEVC deblocking filter (spec 8.7.2), whole-frame tensor passes.

Port of homerhevc_tpu/ops/deblock.py (deblock_frame; the intra, the
fixed-grid inter and the CU-quadtree inter boundary-strength maps). Vertical
edges on the 8-pel grid filter as one (segments, rows, edges, 8 columns)
batch; horizontal edges run the same pass on the transposed, vertically
filtered frame. Exact int32. `deblock_band` filters one band of CTU rows
from the rows its neighbours hold (parallel/sharded.py).
"""

from __future__ import annotations

import torch

from .. import tables
from ..device import const

I32 = torch.int32

# What the filter of a band's own rows reads beyond the band (bands cut on
# the 16-row grid): samples on each side, luma 4 rows (an edge reads p3..q3
# and writes p2..q2) and chroma 2 rows (p1..q1; writes p0, q0); and rows of
# the 4x4-unit bS / QP maps, 2 above and 1 below: a chroma segment of 4 rows
# (8 luma rows) filters its vertical edges with the bS and QP of its first
# unit row, so the band's 2 chroma rows above take those of the unit row 8
# luma rows up. tests/test_torch_parallel.py shows each the least that
# gives the whole-frame filter's rows.
HALO_Y, HALO_C = 4, 2
HALO_UNITS = (2, 1)


def _clip1(v):
    return v.clamp(0, 255)


def _clip(v, lo, hi):
    return torch.minimum(torch.maximum(v, lo), hi)


def _luma_vertical_pass(y, bs, qp_p, qp_q, beta_offset, tc_offset):
    """Filter all vertical luma edges of y (H, W); bs/qp_p/qp_q (H//4, nE)
    per 4-row segment and edge (edges at columns 8, 16, ...)."""
    H, W = y.shape
    nE = W // 8 - 1
    if nE <= 0:
        return y
    nS = H // 4
    dev = y.device
    y = y.to(I32)
    t = y[:, 4:W - 4].reshape(nS, 4, nE, 8)
    p3, p2, p1, p0 = t[..., 0], t[..., 1], t[..., 2], t[..., 3]
    q0, q1, q2, q3 = t[..., 4], t[..., 5], t[..., 6], t[..., 7]

    qp_l = (qp_p + qp_q + 1) >> 1
    beta = const(tables.DEBLOCK_BETA, dev)
    tc_t = const(tables.DEBLOCK_TC, dev)
    b = beta[(qp_l + beta_offset).clamp(0, 51)]
    tc = tc_t[(qp_l + 2 * (bs - 1) + tc_offset).clamp(0, 53)]

    dp = (p2 - 2 * p1 + p0).abs()                               # (nS, 4, nE)
    dq = (q2 - 2 * q1 + q0).abs()
    dp0, dp3 = dp[:, 0], dp[:, 3]
    dq0, dq3 = dq[:, 0], dq[:, 3]
    d = dp0 + dp3 + dq0 + dq3
    filt = (bs > 0) & (d < b)

    def strong_row(r):
        dpq2 = 2 * (dp[:, r] + dq[:, r])
        return ((dpq2 < (b >> 2))
                & ((p3[:, r] - p0[:, r]).abs() + (q0[:, r] - q3[:, r]).abs()
                   < (b >> 3))
                & ((p0[:, r] - q0[:, r]).abs() < ((5 * tc + 1) >> 1)))

    strong = filt & strong_row(0) & strong_row(3)
    weak = filt & ~strong
    tc4 = tc[:, None, :]
    st4 = strong[:, None, :]
    wk4 = weak[:, None, :]

    sp0 = _clip((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                p0 - 2 * tc4, p0 + 2 * tc4)
    sp1 = _clip((p2 + p1 + p0 + q0 + 2) >> 2, p1 - 2 * tc4, p1 + 2 * tc4)
    sp2 = _clip((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3,
                p2 - 2 * tc4, p2 + 2 * tc4)
    sq0 = _clip((q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                q0 - 2 * tc4, q0 + 2 * tc4)
    sq1 = _clip((q2 + q1 + q0 + p0 + 2) >> 2, q1 - 2 * tc4, q1 + 2 * tc4)
    sq2 = _clip((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3,
                q2 - 2 * tc4, q2 + 2 * tc4)

    side_thr = (b + (b >> 1)) >> 3
    dEp = ((dp0 + dp3) < side_thr)[:, None, :]
    dEq = ((dq0 + dq3) < side_thr)[:, None, :]
    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    do_w = wk4 & (delta.abs() < 10 * tc4)
    dlt = _clip(delta, -tc4, tc4)
    wp0 = _clip1(p0 + dlt)
    wq0 = _clip1(q0 - dlt)
    tc2 = tc4 >> 1
    dp1c = _clip((((p2 + p0 + 1) >> 1) - p1 + dlt) >> 1, -tc2, tc2)
    dq1c = _clip((((q2 + q0 + 1) >> 1) - q1 - dlt) >> 1, -tc2, tc2)
    wp1 = _clip1(p1 + dp1c)
    wq1 = _clip1(q1 + dq1c)

    f_p0 = torch.where(st4, sp0, torch.where(do_w, wp0, p0))
    f_p1 = torch.where(st4, sp1, torch.where(do_w & dEp, wp1, p1))
    f_p2 = torch.where(st4, sp2, p2)
    f_q0 = torch.where(st4, sq0, torch.where(do_w, wq0, q0))
    f_q1 = torch.where(st4, sq1, torch.where(do_w & dEq, wq1, q1))
    f_q2 = torch.where(st4, sq2, q2)

    out = torch.stack([p3, f_p2, f_p1, f_p0, f_q0, f_q1, f_q2, q3], dim=-1)
    mid = out.reshape(H, W - 8).to(I32)
    return torch.cat([y[:, :4], mid, y[:, W - 4:]], dim=1)


def _chroma_qp(qp_i):
    t = const(tables.CHROMA_QP_TABLE, qp_i.device)
    return torch.where(qp_i < 30, qp_i,
                       torch.where(qp_i > 43, qp_i - 6,
                                   t[qp_i.clamp(30, 43) - 30]))


def _chroma_vertical_pass(c, bs2, qp_p, qp_q, c_qp_offset, tc_offset):
    """Filter all vertical chroma edges of c (H2, W2): edges every 8 chroma
    samples, only bS == 2 filters."""
    H2, W2 = c.shape
    nE = W2 // 8 - 1
    if nE <= 0:
        return c
    nS = H2 // 4
    c = c.to(I32)
    t = c[:, 4:W2 - 4].reshape(nS, 4, nE, 8)
    p1, p0, q0, q1 = t[..., 2], t[..., 3], t[..., 4], t[..., 5]
    qp_i = (((qp_p + qp_q + 1) >> 1) + c_qp_offset).clamp(0, 57)
    qp_c = _chroma_qp(qp_i)
    tc_t = const(tables.DEBLOCK_TC, c.device)
    tc = tc_t[(qp_c + 2 + tc_offset).clamp(0, 53)][:, None, :]
    on = (bs2 == 2)[:, None, :]
    delta = _clip((((q0 - p0) << 2) + p1 - q1 + 4) >> 3, -tc, tc)
    f_p0 = torch.where(on, _clip1(p0 + delta), p0)
    f_q0 = torch.where(on, _clip1(q0 - delta), q0)
    out = torch.stack([t[..., 0], t[..., 1], p1, f_p0, f_q0, q1,
                       t[..., 6], t[..., 7]], dim=-1)
    mid = out.reshape(H2, W2 - 8).to(I32)
    return torch.cat([c[:, :4], mid, c[:, W2 - 4:]], dim=1)


def deblock_frame(y, u, v, *, bs_v, bs_h, qp_map, cb_qp_offset=0,
                  cr_qp_offset=0, beta_offset=0, tc_offset=0):
    """Deblock one reconstructed frame: all vertical edges, then all
    horizontal edges on the vertically filtered output (spec order).
    bs_v (H//4, W//8), bs_h (H//8, W//4), qp_map (H//4, W//4)."""
    H, W = y.shape
    dev = y.device
    je = torch.arange(1, W // 8, device=dev)
    y = _luma_vertical_pass(y, bs_v[:, 1:], qp_map[:, 2 * je - 1],
                            qp_map[:, 2 * je], beta_offset, tc_offset)
    H2, W2 = u.shape
    if W2 >= 16:
        jc = torch.arange(1, W2 // 8, device=dev)
        bs2 = bs_v[::2, 2 * jc]
        qp_pc = qp_map[::2, 4 * jc - 1]
        qp_qc = qp_map[::2, 4 * jc]
        u = _chroma_vertical_pass(u, bs2, qp_pc, qp_qc, cb_qp_offset,
                                  tc_offset)
        v = _chroma_vertical_pass(v, bs2, qp_pc, qp_qc, cr_qp_offset,
                                  tc_offset)

    ie = torch.arange(1, H // 8, device=dev)
    y = _luma_vertical_pass(y.T, bs_h[1:, :].T, qp_map[2 * ie - 1, :].T,
                            qp_map[2 * ie, :].T, beta_offset, tc_offset).T
    if H2 >= 16:
        ic = torch.arange(1, H2 // 8, device=dev)
        bs2 = bs_h[2 * ic, :][:, ::2].T
        qp_pc = qp_map[4 * ic - 1, :][:, ::2].T
        qp_qc = qp_map[4 * ic, :][:, ::2].T
        u = _chroma_vertical_pass(u.T, bs2, qp_pc, qp_qc, cb_qp_offset,
                                  tc_offset).T
        v = _chroma_vertical_pass(v.T, bs2, qp_pc, qp_qc, cr_qp_offset,
                                  tc_offset).T
    return y.contiguous(), u.contiguous(), v.contiguous()


def embed_rows(core, above, below, lead: int, trail: int):
    """`core` with the rows `above` right before it and `below` right after
    it (None: no rows), placed in zeros of lead + len(core) + trail rows,
    `core` starting at row `lead`."""
    parts = [core]
    if above is not None:
        parts.insert(0, above)
    if below is not None:
        parts.append(below)
    na = 0 if above is None else above.shape[0]
    nb = 0 if below is None else below.shape[0]
    return torch.cat([core.new_zeros((lead - na,) + core.shape[1:]), *parts,
                      core.new_zeros((trail - nb,) + core.shape[1:])])


def deblock_band(y, u, v, above, below, *, bs_v, bs_h, qp_map, lead: int,
                 **offsets):
    """The rows of one band of deblock_frame's output. (y, u, v): the band's
    reconstruction; `above` / `below`: (y, u, v) rows of the neighbouring
    bands' reconstruction next to it (HALO_Y luma and HALO_C chroma rows),
    None at the picture's top / bottom. bs_v, bs_h, qp_map: the maps over
    the luma rows from `lead` rows above the band to as far below it
    (multiples of 16, so the chroma edge grid stays aligned), true on the
    rows the filter reads (HALO_UNITS). The planes are filtered in zeros of
    that span; no edge whose filter reaches the band reads the zeros."""
    n = y.shape[0]
    trail = bs_v.shape[0] * 4 - lead - n
    ab = (None,) * 3 if above is None else above
    be = (None,) * 3 if below is None else below
    ext = [embed_rows(p, a, b, lead >> (k > 0), trail >> (k > 0))
           for k, (p, a, b) in enumerate(zip((y, u, v), ab, be))]
    fy, fu, fv = deblock_frame(*ext, bs_v=bs_v, bs_h=bs_h, qp_map=qp_map,
                               **offsets)
    c0 = lead // 2
    return (fy[lead:lead + n], fu[c0:c0 + n // 2], fv[c0:c0 + n // 2])


def _tu_starts(tusz):
    """Which 4x4 units start a TU of size `tusz` (uh, uw), in x and in y."""
    uh, uw = tusz.shape
    dev = tusz.device
    posx = torch.arange(uw, device=dev, dtype=I32) * 4
    posy = torch.arange(uh, device=dev, dtype=I32) * 4
    return ((posx[None, :] & (tusz - 1)) == 0,
            (posy[:, None] & (tusz - 1)) == 0)


def intra_bs_from_depth_units(depth_u, trd_u=None):
    """bs maps for an all-intra frame from the unit-granular CU depth map
    (relative to 32-containers: TU = 32 >> depth; intra TU edges on the
    8-pel grid get bS 2). `trd_u` marks CUs whose transform splits one
    level: their TU edges lie one level finer (a 4x4-TB interior edge falls
    off the 8-pel grid, so the clamp to 4 is harmless)."""
    uh, uw = depth_u.shape
    dev = depth_u.device
    tusz = 32 >> depth_u.to(I32)
    if trd_u is not None:
        tusz = (tusz >> trd_u.to(I32)).clamp(min=4)
    startx, starty = _tu_starts(tusz)
    bs_v = torch.zeros((uh, uw // 2), dtype=I32, device=dev)
    bs_h = torch.zeros((uh // 2, uw), dtype=I32, device=dev)
    bs_v[:, 1:] = 2 * startx[:, 2::2].to(I32)
    bs_h[1:, :] = 2 * starty[2::2, :].to(I32)
    return bs_v, bs_h


def inter_bs_from_units(depth_u, mv_u, cbf_u, ctu_log2: int, trd_u=None,
                        intra_u=None):
    """bs maps for a P frame coded as a variable-depth inter CU quadtree
    (spec 8.7.2.4 reduced to the one-reference case).

    depth_u (uh, uw) absolute CU depth per 4x4 unit; mv_u (uh, uw, 2)
    quarter-pel MV per unit; cbf_u (uh, uw) bool luma TB cbf per unit (TB
    granular where `trd_u` marks a depth-1 residual quadtree). TU = min(CU,
    32), halved where trd_u is set, and PU == CU, so TU starts cover every
    CU/PU edge. bS = 1 on an edge when either TB has coefficients or the
    MVs differ by a luma sample (4 qpel) or more; 2 when either side is
    intra (`intra_u`)."""
    uh, uw = depth_u.shape
    dev = depth_u.device
    tusz = ((1 << ctu_log2) >> depth_u.to(I32)).clamp(max=32)
    if trd_u is not None:
        tusz = torch.where(trd_u.to(torch.bool), tusz >> 1, tusz)
    startx, starty = _tu_starts(tusz)
    cbf_u = cbf_u.to(torch.bool)
    intra = None if intra_u is None else intra_u.to(torch.bool)

    def bs_at(edge, a, b):
        # a / b: the (mv, cbf, intra) of the units on either side of the edge
        mvdiff = ((a[0] - b[0]).abs() >= 4).any(dim=-1)
        bs = (edge & (a[1] | b[1] | mvdiff)).to(I32)
        if intra is not None:
            bs = torch.where(edge & (a[2] | b[2]), 2, bs)
        return bs

    def side(sl):
        return (mv_u[sl], cbf_u[sl], None if intra is None else intra[sl])

    # vertical edges at luma columns 8, 16, ... = unit columns 2, 4, ...
    bs_v = torch.zeros((uh, uw // 2), dtype=I32, device=dev)
    bs_v[:, 1:] = bs_at(startx[:, 2::2], side((slice(None), slice(1, uw - 1, 2))),
                        side((slice(None), slice(2, uw, 2))))
    bs_h = torch.zeros((uh // 2, uw), dtype=I32, device=dev)
    bs_h[1:, :] = bs_at(starty[2::2, :], side((slice(1, uh - 1, 2),)),
                        side((slice(2, uh, 2),)))
    return bs_v, bs_h


def inter_bs_from_blocks(mvs, cbf_blk, B: int, qcbf=None):
    """bs maps for an all-inter CU = PU = B grid from per-block quarter-pel
    MVs (nby, nbx, 2) and luma cbf (nby, nbx). A 64-CU codes four 32-TBs:
    pass their cbf `qcbf` (nby, nbx, 2, 2); CU edges then take the cbf of
    the quadrants on either side, and the CU's inner TU edges get bS 1 from
    cbf alone (the MV is one per CU)."""
    if B > 32 and qcbf is None:
        raise ValueError("inter_bs_from_blocks: B > 32 needs the per-TB cbf "
                         "qcbf")
    nby, nbx = cbf_blk.shape
    dev = cbf_blk.device
    rv, rh = B // 4, B // 8
    dmv_v = (mvs[:, 1:] - mvs[:, :-1]).abs().amax(-1) >= 4
    dmv_h = (mvs[1:, :] - mvs[:-1, :]).abs().amax(-1) >= 4
    bs_v = torch.zeros((nby * rv, nbx * rh), dtype=I32, device=dev)
    bs_h = torch.zeros((nby * rh, nbx * rv), dtype=I32, device=dev)
    col_idx = torch.arange(1, nbx, device=dev) * rh
    row_idx = torch.arange(1, nby, device=dev) * rh
    if qcbf is None:
        bs1_v = ((cbf_blk[:, 1:] | cbf_blk[:, :-1]) | dmv_v).to(I32)
        bs_v[:, col_idx] = bs1_v.repeat_interleave(rv, dim=0)
        bs1_h = ((cbf_blk[1:, :] | cbf_blk[:-1, :]) | dmv_h).to(I32)
        bs_h[row_idx, :] = bs1_h.repeat_interleave(rv, dim=1)
        return bs_v, bs_h
    q = qcbf.to(torch.bool)                              # (nby, nbx, 2, 2)
    # CU edges, per half: the quadrants that touch the edge on either side
    v_half = (q[:, :-1, :, 1] | q[:, 1:, :, 0]) | dmv_v[:, :, None]
    bs_v[:, col_idx] = (v_half.permute(0, 2, 1).reshape(nby * 2, nbx - 1)
                        .to(I32).repeat_interleave(rv // 2, dim=0))
    h_half = (q[:-1, :, 1, :] | q[1:, :, 0, :]) | dmv_h[:, :, None]
    bs_h[row_idx, :] = (h_half.reshape(nby - 1, nbx * 2).to(I32)
                        .repeat_interleave(rv // 2, dim=1))
    # the CU's inner TU edges, cbf only
    v_mid = torch.stack([q[..., 0, 0] | q[..., 0, 1],
                         q[..., 1, 0] | q[..., 1, 1]], 1)
    bs_v[:, torch.arange(nbx, device=dev) * rh + rh // 2] = (
        v_mid.reshape(nby * 2, nbx).to(I32).repeat_interleave(rv // 2, 0))
    h_mid = torch.stack([q[..., 0, 0] | q[..., 1, 0],
                         q[..., 0, 1] | q[..., 1, 1]], 2)
    bs_h[torch.arange(nby, device=dev) * rh + rh // 2, :] = (
        h_mid.reshape(nby, nbx * 2).to(I32).repeat_interleave(rv // 2, 1))
    return bs_v, bs_h
