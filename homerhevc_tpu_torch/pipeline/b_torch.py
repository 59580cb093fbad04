"""B-frame stage: two-list ME + L0/L1/BI select + residual coding, on a
fixed CU = TU = B grid (B 16 or 32; chroma TBs B/2).

Port of homerhevc_tpu/pipeline/b_jax.py (`b_frame_device`, `_subpel_list`,
`_chroma_hp`, `_code_cu`). Per list: the integer search of the P stage
(hierarchical above p_torch.HIER_THRESHOLD, else the dense sweep, whose
first-minimum pick over SAD + MV cost is what kernels/me_sad.cu computes),
then the 49-position quarter-pel refinement from 16 high-precision (14-bit)
filter grids; bi-prediction is the spec 8.5.4.2.3.1 average of the two
14-bit predictions. The per-block support windows go through
kernels/gather_win.cu on the card. The merge/AMVP decision walk stays on the
host (pipeline/b_golden.build_b_plans). All arithmetic is exact int32:
floor `//`, arithmetic `>>`, the reference's clips and first-minimum ties
(L0, then L1, then BI).
"""

from __future__ import annotations

import torch

from .. import tables
from ..device import I32, const, edge_pad, first_argmin
from ..ops import interp
from ..ops import quant as quant_ops
from ..ops import transforms as tx_ops
from ..ops.gather import gather_windows
from ..ops.me import integer_me
from .p_torch import (HIER_THRESHOLD, PAD, _bits_tab, _blocks, _me_hier,
                      _mv_bits_grid, _qp_tensor)


def _integer_me(cur, y_pad, ryp, *, B, search, lam, kernels):
    """Integer MV (ivy, ivx), (nby, nbx), of every B-block against one
    PAD-padded reference plane."""
    if search > HIER_THRESHOLD:
        ivy, ivx, _ = _me_hier(cur, ryp, sizes=(B,), search=search, lam=lam,
                               kernels=kernels)[B]
        return ivy, ivx
    # the reference sums 16-block SAD grids up to B before its first-minimum
    # pick: the same integers as the B-block sweep
    n = 2 * search + 1
    mvcost = (lam * const(_mv_bits_grid(search), cur.device)) >> 8
    _, k = integer_me(y_pad, ryp, mvcost, B=B, search=search, pad=PAD,
                      kernels=kernels)
    return k // n - search, k % n - search


def _subpel_list(cur, ryp, ivy, ivx, *, S, lam, search, me_precision,
                 kernels):
    """Per-list quarter-pel refinement of every S-block: returns (mvx, mvy,
    hp (nb, S, S) 14-bit prediction, pred8, cost, blk)."""
    H, W = cur.shape
    nby, nbx = H // S, W // S
    nb = nby * nbx
    G = S + 2
    dev = cur.device
    bits_q = const(_bits_tab(4 * search + 16), dev)
    bi = torch.arange(nb, device=dev, dtype=I32)
    r = bi // nbx
    c = bi % nbx
    vy = ivy.reshape(-1).to(I32)
    vx = ivx.reshape(-1).to(I32)

    win = gather_windows(ryp, r * S + vy - 4 + PAD, c * S + vx - 4 + PAD,
                         S + 9, kernels=kernels).to(I32)   # (nb, S+9, S+9)

    def filt_h(b, taps, w_out):
        acc = int(taps[0]) * b[:, :, 0:w_out]
        for i in range(1, len(taps)):
            acc = acc + int(taps[i]) * b[:, :, i:i + w_out]
        return acc

    def filt_v(b, taps, h_out):
        acc = int(taps[0]) * b[:, 0:h_out, :]
        for i in range(1, len(taps)):
            acc = acc + int(taps[i]) * b[:, i:i + h_out, :]
        return acc

    lf = interp.LUMA_FILTERS
    hraw = [filt_h(win, lf[fx], G) for fx in range(4)]
    hstack = torch.stack([filt_v(hraw[fx], lf[fy], G) >> 6
                          for fy in range(4) for fx in range(4)],
                         dim=1)                             # (nb, 16, G, G)

    blk = _blocks(cur, S)                                   # (nb, S, S)
    costs = []
    for qy in range(-3, 4):
        for qx in range(-3, 4):
            fy, fx = qy & 3, qx & 3
            iy, ix = qy >> 2, qx >> 2
            hp = hstack[:, fy * 4 + fx, 1 + iy:1 + iy + S, 1 + ix:1 + ix + S]
            pred = ((hp + 32) >> 6).clamp(0, 255)
            sad = (blk - pred).abs().sum(dim=(-1, -2))
            bb = bits_q[(4 * vx + qx).abs()] + bits_q[(4 * vy + qy).abs()]
            costs.append(sad + ((lam * bb) >> 8))
    cost49 = torch.stack(costs)                             # (49, nb)

    def pick49(i):
        return torch.gather(cost49, 0, i.to(torch.int64)[None])[0]

    def strict_min(center_idx, offsets):
        best_i = center_idx
        best_c = pick49(center_idx)
        for off in offsets:
            i = center_idx + off
            ci = pick49(i)
            better = ci < best_c
            best_c = torch.where(better, ci, best_c)
            best_i = torch.where(better, i, best_i)
        return best_i

    center = torch.full((nb,), 24, dtype=I32, device=dev)   # (0, 0)
    if me_precision >= 1:
        center = strict_min(center, [dqy * 7 + dqx for dqy in (-2, 0, 2)
                                     for dqx in (-2, 0, 2)
                                     if not (dqy == 0 and dqx == 0)])
    if me_precision >= 2:
        center = strict_min(center, [dqy * 7 + dqx for dqy in (-1, 0, 1)
                                     for dqx in (-1, 0, 1)
                                     if not (dqy == 0 and dqx == 0)])
    qy = center // 7 - 3
    qx = center % 7 - 3
    mvx = 4 * vx + qx
    mvy = 4 * vy + qy

    # the selected grid at the selected integer shift (sy, sx in {0, 1})
    pidx = ((qy & 3) * 4 + (qx & 3)).to(torch.int64)
    sel = hstack[bi.to(torch.int64), pidx]                  # (nb, G, G)
    sy = 1 + (qy >> 2)
    sx = 1 + (qx >> 2)
    hp_sel = torch.zeros((nb, S, S), dtype=I32, device=dev)
    for a in (0, 1):
        for b in (0, 1):
            m = ((sy == a) & (sx == b))[:, None, None]
            hp_sel = hp_sel + torch.where(m, sel[:, a:a + S, b:b + S], 0)
    pred8 = ((hp_sel + 32) >> 6).clamp(0, 255)
    sad = (blk - pred8).abs().sum(dim=(-1, -2))
    mvb = bits_q[mvx.abs()] + bits_q[mvy.abs()]
    cost = sad + ((lam * mvb) >> 8)
    return mvx, mvy, hp_sel, pred8, cost, blk


def _chroma_hp(refps, mvx, mvy, r, c, *, S2, kernels):
    """Per-block 14-bit chroma predictions (spec 8.5.4.2.2.2, no rounding
    or clip) of a pair of PAD/2-padded planes at one list's MVs:
    (2, nb, S2, S2)."""
    ctab = const(interp.CHROMA_FILTERS, mvx.device)
    coefx = ctab[(mvx & 7).to(torch.int64)]                 # (nb, 4)
    coefy = ctab[(mvy & 7).to(torch.int64)]
    by_c = r * S2 + (mvy >> 3) + PAD // 2 - 1
    bx_c = c * S2 + (mvx >> 3) + PAD // 2 - 1
    wc = gather_windows(refps, by_c, bx_c, S2 + 3,
                        kernels=kernels).to(I32)    # (2, nb, S2+3, S2+3)
    hs = sum(coefx[:, k, None, None] * wc[..., k:k + S2] for k in range(4))
    return sum(coefy[:, k, None, None] * hs[..., k:k + S2, :]
               for k in range(4)) >> 6


def _code_cu(orig, pred, qpq, lg2, sign_hiding, lam_full_t):
    """Batched TU = CU residual coding with the zero-cbf RD (the P stage's
    integers)."""
    coeff = tx_ops.forward_transform(orig - pred)
    lev = quant_ops.quantize(coeff, qpq, lg2, is_intra=False)
    if sign_hiding:
        lev = quant_ops.sign_bit_hiding(lev, coeff, qpq, lg2)
    rr = tx_ops.inverse_transform(quant_ops.dequantize(lev, qpq, lg2))
    any_nz = (lev != 0).any(dim=-1).any(dim=-1)
    rr = torch.where(any_nz[..., None, None], rr, 0)
    rec = (pred + rr).clamp(0, 255)
    lamf = lam_full_t[qpq]
    ssd_c = ((orig - rec) * (orig - rec)).sum(dim=(-1, -2))
    ssd_s = ((orig - pred) * (orig - pred)).sum(dim=(-1, -2))
    bits = torch.clamp(tables.level_bits_est_t(lev), max=16383)
    keep = (ssd_c + (((lamf >> 4) * bits) >> 4) < ssd_s)[..., None, None]
    return torch.where(keep, lev, 0), torch.where(keep, rec, pred)


def b_frame_device(y_pad, u_pad, v_pad, r0y, r0u, r0v, r1y, r1u, r1v, *,
                   B: int, qp, search: int, me_precision: int,
                   sign_hiding: bool = False, vis=None,
                   kernels: bool = True):
    """One B frame, CU = TU = B grid, references (past, future) as decoded
    uint8 planes. Returns the reference's per-block arrays: inter_dir `idc`
    (0 L0 / 1 L1 / 2 BI), `mv0`/`mv1` (nby, nbx, 2) quarter-pel (x, y),
    levels and reconstruction, plus `wire` (`pack_b_wire`)."""
    pads = [(edge_pad(ry.to(torch.int16), PAD),
             edge_pad(ru.to(torch.int16), PAD // 2),
             edge_pad(rv.to(torch.int16), PAD // 2))
            for ry, ru, rv in ((r0y, r0u, r0v), (r1y, r1u, r1v))]
    out = b_stage(y_pad, u_pad, v_pad, pads, B=B, qp=qp, search=search,
                  me_precision=me_precision, sign_hiding=sign_hiding,
                  vis=vis, kernels=kernels)
    out["wire"] = pack_b_wire(out)
    return out


def b_stage(y_pad, u_pad, v_pad, pads, *, B: int, qp, search: int,
            me_precision: int, sign_hiding: bool = False, vis=None,
            row0: int = 0, kernels: bool = True) -> dict:
    """The B stage of `b_frame_device` without the wire, on pre-padded
    references `pads` (per list the (y, u, v) int16 planes edge-padded by
    PAD, PAD/2 for chroma, or a band's rows of them with its halo:
    parallel/sharded.b_frame_bands). `row0` is the
    first luma row of `y_pad` in the picture and `vis` the visible
    picture's (height, width), so that only rows below the picture's own
    take the conformance padding's orig := pred."""
    H, W = y_pad.shape
    nby, nbx = H // B, W // B
    nb = nby * nbx
    B2 = B // 2
    log2 = B.bit_length() - 1
    dev = y_pad.device
    qp = _qp_tensor(qp, dev)
    qp_c = tables.chroma_qp_t(qp)
    lam = const(tables.LAMBDA_ME_FX_P, dev)[qp]
    lam_full_t = const(tables.LAMBDA_FX_P, dev)
    cur = y_pad.to(I32)

    bi = torch.arange(nb, device=dev, dtype=I32)
    r = bi // nbx
    c = bi % nbx

    lists = []
    for ryp, _, _ in pads:
        ivy, ivx = _integer_me(cur, y_pad, ryp, B=B, search=search, lam=lam,
                               kernels=kernels)
        lists.append(_subpel_list(cur, ryp, ivy, ivx, S=B, lam=lam,
                                  search=search, me_precision=me_precision,
                                  kernels=kernels))
    mvx0, mvy0, hp0, p80, cost0, blk = lists[0]
    mvx1, mvy1, hp1, p81, cost1, _ = lists[1]

    pred_bi = ((hp0 + hp1 + 64) >> 7).clamp(0, 255)
    sad_bi = (blk - pred_bi).abs().sum(dim=(-1, -2))
    bits_q = const(_bits_tab(4 * search + 16), dev)
    bb_bi = (bits_q[mvx0.abs()] + bits_q[mvy0.abs()]
             + bits_q[mvx1.abs()] + bits_q[mvy1.abs()])
    cost_bi = sad_bi + ((lam * bb_bi) >> 8)
    idc = first_argmin(torch.stack([cost0, cost1, cost_bi]),
                       0).to(I32)                  # ties: L0, L1, BI

    def by_dir(a0, a1, a2):
        d = idc[:, None, None]
        return torch.where(d == 0, a0, torch.where(d == 1, a1, a2))

    pred_y = by_dir(p80, p81, pred_bi)
    hc0 = _chroma_hp(pads[0][1:], mvx0, mvy0, r, c, S2=B2, kernels=kernels)
    hc1 = _chroma_hp(pads[1][1:], mvx1, mvy1, r, c, S2=B2, kernels=kernels)

    def uni(hp):
        return ((hp + 32) >> 6).clamp(0, 255)

    pred_u, pred_v = (by_dir(uni(hc0[k]), uni(hc1[k]),
                             ((hc0[k] + hc1[k] + 64) >> 7).clamp(0, 255))
                      for k in (0, 1))

    oy = blk
    ou = _blocks(u_pad.to(I32), B2)
    ov = _blocks(v_pad.to(I32), B2)
    if vis is not None and (vis[0] < row0 + H or vis[1] < W):
        # rows and columns beyond the visible picture: orig := pred
        def visible(s, y0, vh, vw):
            ys = torch.arange(s, device=dev, dtype=I32)
            vmy = (y0 + r[:, None] * s + ys[None]) < vh
            vmx = (c[:, None] * s + ys[None]) < vw
            return vmy[:, :, None] & vmx[:, None, :]

        oy = torch.where(visible(B, row0, vis[0], vis[1]), oy, pred_y)
        m_c = visible(B2, row0 // 2, vis[0] // 2, vis[1] // 2)
        ou = torch.where(m_c, ou, pred_u)
        ov = torch.where(m_c, ov, pred_v)
    lev_y, rec_y = _code_cu(oy, pred_y, qp, log2, sign_hiding, lam_full_t)
    lev_u, rec_u = _code_cu(ou, pred_u, qp_c, log2 - 1, sign_hiding,
                            lam_full_t)
    lev_v, rec_v = _code_cu(ov, pred_v, qp_c, log2 - 1, sign_hiding,
                            lam_full_t)

    out = dict(idc=idc.reshape(nby, nbx),
               mv0=torch.stack([mvx0, mvy0], -1).to(I32).reshape(nby, nbx, 2),
               mv1=torch.stack([mvx1, mvy1], -1).to(I32).reshape(nby, nbx, 2))
    out["lev_y"] = lev_y.reshape(nby, nbx, B, B)
    out["rec_y"] = rec_y.reshape(nby, nbx, B, B)
    for k, t in (("lev_u", lev_u), ("lev_v", lev_v),
                 ("rec_u", rec_u), ("rec_v", rec_v)):
        out[k] = t.reshape(nby, nbx, B2, B2)
    return out


def pack_b_wire(out: dict):
    """One int16 buffer per B frame (the host's one copy): all luma levels,
    then all Cb, then all Cr levels, then the int32 idc, mv0 and mv1 bitcast
    to int16 pairs, each of the whole frame in block raster order."""
    meta = torch.cat([out[k].reshape(-1) for k in ("idc", "mv0", "mv1")])
    return torch.cat([out[k].to(torch.int16).reshape(-1)
                      for k in ("lev_y", "lev_u", "lev_v")]
                     + [meta.view(torch.int16)])


def unpack_b_wire(wire, H: int, W: int, B: int) -> dict:
    """Host side of `wire`: idc, mv0, mv1 and the (nby, nbx, ...) levels."""
    nby, nbx = H // B, W // B
    nb = nby * nbx
    B2 = B // 2
    ny, nc = nb * B * B, nb * B2 * B2
    meta = (wire[ny + 2 * nc:]).copy().view("<i4")
    return dict(
        lev_y=wire[:ny].reshape(nby, nbx, B, B),
        lev_u=wire[ny:ny + nc].reshape(nby, nbx, B2, B2),
        lev_v=wire[ny + nc:ny + 2 * nc].reshape(nby, nbx, B2, B2),
        idc=meta[:nb].reshape(nby, nbx),
        mv0=meta[nb:3 * nb].reshape(nby, nbx, 2),
        mv1=meta[3 * nb:].reshape(nby, nbx, 2))
