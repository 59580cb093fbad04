"""P-frame pipeline: frame-batched integer ME, quarter-pel refinement,
merge/skip RD, MC and residual coding, on a fixed CU = B grid or as an inter
CU quadtree (CTU 32 or 64 -> 16, or -> 8) with the inter residual quadtree
and, at CTU 32, the per-CU intra fallback.

Port of homerhevc_tpu/pipeline/p_jax.py for CTU 32 and 64: `_p_stage`
(dense branch), `_me_hier` (sizes 8 to 64), `_level_encode` (S 8 to 64,
`vis`, `tr_split`, per-CTU-row QPs), `_p_stage_tail`, `_p_stage_tree` (with
`cu8`, row QPs and the decoded-QP maps with and without WPP),
`p_frame_device`, `p_frame_tree_device`, `deblock_intra_device`. Inter
prediction reads only the previous decoded
frame, so every block is independent and the whole frame runs as batched
tensor ops with the block axis first: (nb, ...). Two steps go through
hand-written CUDA kernels on the card: the integer SAD sweep of the fixed-CU
path (ops/me.py) and the per-block window gathers of both paths
(ops/gather.py). All arithmetic is exact int32, equal to the reference
output for output.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import tables
from ..device import I32, const, edge_pad, first_argmin, take
from ..ops import deblock as dbk
from ..ops import interp
from ..ops import intra as intra_ops
from ..ops import quant as quant_ops
from ..ops import transforms as tx_ops
from ..ops.blocksum import block_sum
from ..ops.gather import gather_windows
from ..ops.me import integer_me, sad_grids

# Edge padding of the reference planes: the largest search range of the
# reference's hierarchical ME (64) + the 8-tap filter support (as
# homerhevc_tpu/pipeline/p_golden.py).
PAD = 72

# Search ranges above this take the hierarchical coarse + refine ME
# (_me_hier, tree path only); at or below it the dense full-window sweep.
HIER_THRESHOLD = 24

# Merge-signalling bit proxies (merge_flag + unary idx), as the reference.
MB_LEFT, MB_TOP, MB_ZERO = 3, 4, 5
_MB_TAB = np.array([0, MB_LEFT, MB_TOP, MB_ZERO], np.int32)

# Luma modes of the intra-in-P battery (planar, DC, angular every 4th).
INTRA_IN_P_MODES = np.array([0, 1, 2, 6, 10, 14, 18, 22, 26, 30, 34], np.int64)


@functools.lru_cache(maxsize=None)
def _bits_tab(max_abs: int) -> np.ndarray:
    """bits(c) = 1 + 2*bitlen(|c|) lookup for |c| in 0..max_abs."""
    return np.array([1 + 2 * int(a).bit_length() for a in range(max_abs + 1)],
                    dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _mv_bits_grid(search: int) -> np.ndarray:
    """MV bit proxy of every integer offset, (n*n,) dy-major."""
    bits1 = _bits_tab(4 * search)[np.abs(4 * np.arange(-search, search + 1))]
    return (bits1[:, None] + bits1[None, :]).reshape(-1).astype(np.int32)


def _qp_tensor(qp, device) -> torch.Tensor:
    if isinstance(qp, torch.Tensor):
        return qp.to(device=device, dtype=I32)
    return torch.full((), int(qp), dtype=I32, device=device)


def _blocks(plane: torch.Tensor, s: int) -> torch.Tensor:
    """(H, W) -> (nb, s, s) raster blocks."""
    H, W = plane.shape
    return (plane.reshape(H // s, s, W // s, s).permute(0, 2, 1, 3)
            .reshape(-1, s, s))


def to_plane(blocks: torch.Tensor) -> torch.Tensor:
    """(nby, nbx, s, s) -> (nby*s, nbx*s)."""
    nby, nbx, s, _ = blocks.shape
    return blocks.permute(0, 2, 1, 3).reshape(nby * s, nbx * s)


def _p_stage(y_pad, u_pad, v_pad, ry, ru, rv, *, B: int, qp, search: int,
             me_precision: int, sign_hiding: bool = False,
             kernels: bool = True, top_mv=None):
    """Core frame-batched P stage over PAD-pre-padded int16 reference
    planes (dense integer search, the reference's `_p_stage`). `top_mv`:
    see `_level_encode`; the result's `amvp` holds every block's refined
    MV before the merge decision, (nby, nbx, 2)."""
    dev = y_pad.device
    qp = _qp_tensor(qp, dev)
    qp_c = tables.chroma_qp_t(qp)
    lam = take(const(tables.LAMBDA_ME_FX_P, dev), qp)
    cur = y_pad.to(I32)
    if search > HIER_THRESHOLD:
        ivy, ivx, best_cost = _me_hier(cur, ry, sizes=(B,), search=search,
                                       lam=lam, kernels=kernels)[B]
        return _p_stage_tail(cur, u_pad, v_pad, ry, ru, rv, ivy, ivx,
                             best_cost, B=B, qp=qp, qp_c=qp_c, lam=lam,
                             search=search, me_precision=me_precision,
                             sign_hiding=sign_hiding, kernels=kernels,
                             top_mv=top_mv)
    n = 2 * search + 1
    mvcost = (lam * const(_mv_bits_grid(search), dev)) >> 8
    # the kernel takes the uint8 or int16 plane as it is (no conversion
    # launch in front of it)
    best_cost, best_o = integer_me(y_pad, ry, mvcost, B=B, search=search,
                                   pad=PAD, kernels=kernels)
    ivy = best_o // n - search
    ivx = best_o % n - search
    return _p_stage_tail(cur, u_pad, v_pad, ry, ru, rv, ivy, ivx, best_cost,
                         B=B, qp=qp, qp_c=qp_c, lam=lam, search=search,
                         me_precision=me_precision, sign_hiding=sign_hiding,
                         kernels=kernels, top_mv=top_mv)


def _level_encode(cur, u_pad, v_pad, ry, ru, rv, ivy, ivx, *, S, qp, qp_c,
                  lam, search, me_precision, sign_hiding, tr_split=False,
                  qp_rows=None, vis=None, kernels: bool = True, top_mv=None):
    """Subpel refinement + merge/skip RD + MC + residual coding for every
    S-sized block (S in {8, 16, 32, 64}; a 64-block codes its residual as
    four 32-TBs, its chroma as four 16-TBs, each with its own skip-vs-code
    RD). Returns per-block levels / recon and MVs,
    the integer RD cost of each block as a quadtree node (luma SSD + lambda
    * (level-bit estimate + MV bits)) and, with `tr_split` at S 32, the
    per-CU choice `trd` of coding the residual as four half-size TBs.
    `vis` = (height, width) of the visible picture: no residual is spent
    on the padding beyond it. `qp_rows` (one QP per CTU row) gives every
    block its row's QP for quantisation, sign hiding and the RD lambdas;
    the ME lambda `lam` stays the frame's. `top_mv` (nbx, 2) holds the
    refined MVs of the block row above the first (a band's neighbour above,
    parallel/sharded.py): the merge candidate `top` of the first row reads
    them; without it that row has none, as at the picture's top. `amvp` is
    every block's refined MV before the merge decision (nby, nbx, 2)."""
    H, W = cur.shape
    nby, nbx = H // S, W // S
    nb = nby * nbx
    S2 = S // 2
    G = S + 2                                  # qpel grid spatial extent
    log2 = S.bit_length() - 1
    dev = cur.device
    bits_q = const(_bits_tab(4 * search + 16), dev)
    lam_full_t = const(tables.LAMBDA_FX_P, dev)

    bi = torch.arange(nb, device=dev, dtype=I32)
    r = bi // nbx
    c = bi % nbx
    if qp_rows is not None:
        # per-CTU-row rate control: each block codes with its row's QP
        qp = qp_rows.to(I32)[(r * S) // (H // qp_rows.shape[0])]   # (nb,)
        qp_c = tables.chroma_qp_t(qp)
    vy = ivy.reshape(-1).to(I32)
    vx = ivx.reshape(-1).to(I32)

    # ---- per-block (S+9, S+9) luma support windows (kernel on CUDA) ----
    win = gather_windows(ry, r * S + vy - 4 + PAD, c * S + vx - 4 + PAD,
                         S + 9, kernels=kernels).to(I32)    # (nb, S+9, S+9)

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

    # ---- 16 qpel grids, generic two-stage 8-tap (exact for frac == 0) ----
    lf = interp.LUMA_FILTERS
    hraw = [filt_h(win, lf[fx], G) for fx in range(4)]
    grids = []
    for fy in range(4):
        for fx in range(4):
            vv = filt_v(hraw[fx], lf[fy], G) >> 6
            grids.append(((vv + 32) >> 6).clamp(0, 255))
    gstack = torch.stack(grids, dim=1)                       # (nb, 16, G, G)

    blk = _blocks(cur, S)                                    # (nb, S, S)

    # ---- 49 quarter-pel candidate costs (49, nb) ----
    sads, costs = [], []
    for qy in range(-3, 4):
        for qx in range(-3, 4):
            fy, fx = qy & 3, qx & 3
            iy, ix = qy >> 2, qx >> 2
            pred = gstack[:, fy * 4 + fx, 1 + iy:1 + iy + S,
                          1 + ix:1 + ix + S]
            sad = (blk - pred).abs().sum(dim=(-1, -2))
            bb = bits_q[(4 * vx + qx).abs()] + bits_q[(4 * vy + qy).abs()]
            sads.append(sad)
            costs.append(sad + ((lam * bb) >> 8))
    sad49 = torch.stack(sads)
    cost49 = torch.stack(costs)

    def pick49(grid, i):
        return torch.gather(grid, 0, i.to(torch.int64)[None])[0]

    def strict_min(center_idx, offsets):
        best_i = center_idx
        best_c = pick49(cost49, center_idx)
        for off in offsets:
            i = center_idx + off
            ci = pick49(cost49, i)
            better = ci < best_c
            best_c = torch.where(better, ci, best_c)
            best_i = torch.where(better, i, best_i)
        return best_i

    center = torch.full((nb,), 24, dtype=I32, device=dev)    # (0, 0)
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

    # ---- merge/skip RD: [best AMVP, left, top, zero], strict-less ----
    base_cost = pick49(cost49, center)
    BIGC = 1 << 30
    mvxg = mvx.reshape(nby, nbx)
    mvyg = mvy.reshape(nby, nbx)

    def shifted(a, dr, dc):
        return torch.roll(a, shifts=(-dr, -dc), dims=(0, 1)).reshape(-1)

    best_c = base_cost
    sel_k = torch.zeros((nb,), dtype=I32, device=dev)
    mvx_s, mvy_s = mvx, mvy
    zero_pred = _blocks(ry[PAD:PAD + H, PAD:PAD + W].to(I32), S)
    sad_z = (blk - zero_pred).abs().sum(dim=(-1, -2))
    zeros = torch.zeros((nb,), dtype=I32, device=dev)
    if top_mv is None:
        top = (shifted(mvxg, -1, 0), shifted(mvyg, -1, 0), r > 0)
    else:
        top = (torch.cat([top_mv[None, :, 0], mvxg[:-1]]).reshape(-1),
               torch.cat([top_mv[None, :, 1], mvyg[:-1]]).reshape(-1),
               r >= 0)
    cands = [(shifted(mvxg, 0, -1), shifted(mvyg, 0, -1), c > 0, MB_LEFT),
             (*top, MB_TOP),
             (zeros, zeros, None, MB_ZERO)]
    for ki, (cmx, cmy, valid, mb) in enumerate(cands):
        if mb == MB_ZERO:
            sad_c = sad_z
            cost_c = sad_c + ((lam * mb) >> 8)
        else:
            dqx = cmx - 4 * vx
            dqy = cmy - 4 * vy
            ok = valid & (dqx.abs() <= 3) & (dqy.abs() <= 3)
            j = ((dqy + 3) * 7 + (dqx + 3)).clamp(0, 48)
            sad_c = pick49(sad49, j)
            cost_c = torch.where(ok, sad_c + ((lam * mb) >> 8), BIGC)
        better = cost_c < best_c
        best_c = torch.where(better, cost_c, best_c)
        sel_k = torch.where(better, ki + 1, sel_k)
        mvx_s = torch.where(better, cmx, mvx_s)
        mvy_s = torch.where(better, cmy, mvy_s)
    is_zero_sel = (sel_k == 3) | ((mvx_s == 0) & (mvy_s == 0) & (sel_k > 0))
    qy = torch.where(sel_k > 0, (mvy_s - 4 * vy).clamp(-3, 3), qy)
    qx = torch.where(sel_k > 0, (mvx_s - 4 * vx).clamp(-3, 3), qx)
    mvx, mvy = mvx_s, mvy_s

    # ---- final luma pred: the selected qpel plane at the selected shift ----
    pidx = ((qy & 3) * 4 + (qx & 3)).to(torch.int64)
    sel = gstack[torch.arange(nb, device=dev), pidx]         # (nb, G, G)
    sy = 1 + (qy >> 2)                                       # in {0, 1}
    sx = 1 + (qx >> 2)
    pred_y = torch.zeros((nb, S, S), dtype=I32, device=dev)
    for a in (0, 1):
        for b in (0, 1):
            m = ((sy == a) & (sx == b))[:, None, None]
            pred_y = pred_y + torch.where(m, sel[:, a:a + S, b:b + S], 0)
    pred_y = torch.where(is_zero_sel[:, None, None], zero_pred, pred_y)

    # ---- chroma MC with per-block 4-tap filter coefficients ----
    ctab = const(interp.CHROMA_FILTERS, dev)
    coefx = ctab[(mvx & 7).to(torch.int64)]                  # (nb, 4)
    coefy = ctab[(mvy & 7).to(torch.int64)]

    def chroma_pred(refps, base_y, base_x):
        # both planes share the starts: one gather (one kernel launch) and
        # one pass of the filter over the (P, nb, ...) stack
        wc = gather_windows(refps, base_y, base_x, S2 + 3,
                            kernels=kernels).to(I32)    # (P, nb, S2+3, S2+3)
        hs = sum(coefx[:, k, None, None] * wc[..., k:k + S2]
                 for k in range(4))                     # (P, nb, S2+3, S2)
        vv = sum(coefy[:, k, None, None] * hs[..., k:k + S2, :]
                 for k in range(4)) >> 6
        return ((vv + 32) >> 6).clamp(0, 255)

    by_c = r * S2 + (mvy >> 3) + PAD // 2 - 1
    bx_c = c * S2 + (mvx >> 3) + PAD // 2 - 1
    pred_u, pred_v = chroma_pred((ru, rv), by_c, bx_c)
    blk_u = _blocks(u_pad.to(I32), S2)
    blk_v = _blocks(v_pad.to(I32), S2)

    # ---- residual coding on (nb, [4,] n, n) batches ----
    def rd_zero(orig, pred, lev, rec, qpq):
        # skip-vs-code RD per TB: drop the residual when prediction alone
        # costs less in D + lambda*R
        ssd_c = ((orig - rec) * (orig - rec)).sum(dim=(-1, -2))
        ssd_s = ((orig - pred) * (orig - pred)).sum(dim=(-1, -2))
        bits = torch.clamp(tables.level_bits_est_t(lev), max=16383)
        lamf = take(lam_full_t, qpq)        # 0-d, or (nb,) with row QPs
        lamf = lamf.reshape(lamf.shape + (1,) * (bits.dim() - lamf.dim()))
        keep = (ssd_c + (((lamf >> 4) * bits) >> 4) < ssd_s)[..., None, None]
        return torch.where(keep, lev, 0), torch.where(keep, rec, pred)

    def code_tb(orig, pred, qpq, lg2):
        coeff = tx_ops.forward_transform(orig - pred)
        lev = quant_ops.quantize(coeff, qpq, lg2, is_intra=False)
        if sign_hiding:
            lev = quant_ops.sign_bit_hiding(lev, coeff, qpq, lg2)
        rr = tx_ops.inverse_transform(quant_ops.dequantize(lev, qpq, lg2))
        any_nz = (lev != 0).any(dim=-1).any(dim=-1)
        rr = torch.where(any_nz[..., None, None], rr, 0)
        rec = (pred + rr).clamp(0, 255)
        return rd_zero(orig, pred, lev, rec, qpq)

    def code(orig, pred, qpq, lg2, max_tb=5):
        if lg2 <= max_tb:
            return code_tb(orig, pred, qpq, lg2)
        # TU quadtree, one level: four half-size TBs as one (nb, 4, n/2,
        # n/2) batch; the skip-vs-code RD then acts per TB
        n = 1 << lg2
        h2 = n // 2

        def tile(t):
            return (t.reshape(nb, 2, h2, 2, h2).permute(0, 1, 3, 2, 4)
                    .reshape(nb, 4, h2, h2))

        def untile(t):
            return (t.reshape(nb, 2, 2, h2, h2).permute(0, 1, 3, 2, 4)
                    .reshape(nb, n, n))

        lev, rec = code_tb(tile(orig), tile(pred), qpq, lg2 - 1)
        return untile(lev), untile(rec)

    if vis is not None and (vis[0] < H or vis[1] < W):
        # conformance-window padding: rows and columns beyond the visible
        # picture are cropped by the decoder, so orig := pred there (no
        # residual bits, and the costs below ignore invisible distortion)
        def visible(s, vh, vw):
            ys = torch.arange(s, device=dev, dtype=I32)
            vmy = (r[:, None] * s + ys[None]) < vh               # (nb, s)
            vmx = (c[:, None] * s + ys[None]) < vw
            return vmy[:, :, None] & vmx[:, None, :]

        blk = torch.where(visible(S, vis[0], vis[1]), blk, pred_y)
        m_c = visible(S2, vis[0] // 2, vis[1] // 2)
        blk_u = torch.where(m_c, blk_u, pred_u)
        blk_v = torch.where(m_c, blk_v, pred_v)

    # a 64-CU's chroma TBs are 16: the luma TB (32) halved
    cmax_tb = 4 if log2 == 6 else 5
    lev_y, rec_y = code(blk, pred_y, qp, log2)
    lev_u, rec_u = code(blk_u, pred_u, qp_c, log2 - 1, cmax_tb)
    lev_v, rec_v = code(blk_v, pred_v, qp_c, log2 - 1, cmax_tb)
    lamf = take(lam_full_t, qp)
    trd = torch.zeros((nb,), dtype=I32, device=dev)
    if tr_split and S == 32:
        # inter residual quadtree, depth 1: re-code the CU as four
        # half-size TBs (chroma follows the tree), then a per-CU RD select
        def rd_of(lv, rc, orig, extra_bits):
            b = torch.clamp(tables.level_bits_est_t(lv), max=16383)
            d = ((orig - rc) * (orig - rc)).sum(dim=(-1, -2))
            return d + (((lamf >> 4) * (b + extra_bits)) >> 4)

        lev_ys, rec_ys = code(blk, pred_y, qp, log2, max_tb=log2 - 1)
        lev_us, rec_us = code(blk_u, pred_u, qp_c, log2 - 1, max_tb=log2 - 2)
        lev_vs, rec_vs = code(blk_v, pred_v, qp_c, log2 - 1, max_tb=log2 - 2)
        cost_w = (rd_of(lev_y, rec_y, blk, 2) + rd_of(lev_u, rec_u, blk_u, 0)
                  + rd_of(lev_v, rec_v, blk_v, 0))
        cost_s = (rd_of(lev_ys, rec_ys, blk, 2)
                  + rd_of(lev_us, rec_us, blk_u, 0)
                  + rd_of(lev_vs, rec_vs, blk_v, 0))
        sel_s = cost_s < cost_w
        trd = sel_s.to(I32)
        sb = sel_s[:, None, None]
        lev_y = torch.where(sb, lev_ys, lev_y)
        rec_y = torch.where(sb, rec_ys, rec_y)
        lev_u = torch.where(sb, lev_us, lev_u)
        rec_u = torch.where(sb, rec_us, rec_u)
        lev_v = torch.where(sb, lev_vs, lev_v)
        rec_v = torch.where(sb, rec_vs, rec_v)

    # node RD cost for the quadtree split decision
    bits_lv = torch.clamp(tables.level_bits_est_t(lev_y), max=16383)
    mvb = torch.where(sel_k > 0, const(_MB_TAB, dev)[sel_k.to(torch.int64)],
                      bits_q[mvx.abs()] + bits_q[mvy.abs()])
    ssd = ((blk - rec_y) * (blk - rec_y)).sum(dim=(-1, -2))
    cost = ssd + (((lamf >> 4) * (bits_lv + mvb + 6)) >> 4)

    out = {k: t.reshape(nby, nbx, S, S)
           for k, t in (("lev_y", lev_y), ("rec_y", rec_y))}
    out.update({k: t.reshape(nby, nbx, S2, S2)
                for k, t in (("lev_u", lev_u), ("lev_v", lev_v),
                             ("rec_u", rec_u), ("rec_v", rec_v))})
    out.update({k: t.reshape(nby, nbx).to(I32)
                for k, t in (("mvx", mvx), ("mvy", mvy), ("cost", cost),
                             ("trd", trd))})
    out["amvp"] = torch.stack([mvxg, mvyg], -1).to(I32)
    return out


def _p_stage_tail(cur, u_pad, v_pad, ry, ru, rv, ivy, ivx, best_cost, *,
                  B, qp, qp_c, lam, search, me_precision, sign_hiding,
                  kernels=True, top_mv=None):
    """Subpel refinement + MC + residual coding behind the integer search
    (fixed CU = B grid), and the one-buffer host wire of a P frame."""
    e = _level_encode(cur, u_pad, v_pad, ry, ru, rv, ivy, ivx, S=B, qp=qp,
                      qp_c=qp_c, lam=lam, search=search,
                      me_precision=me_precision, sign_hiding=sign_hiding,
                      kernels=kernels, top_mv=top_mv)
    u8 = torch.uint8
    return dict(fixed_result(torch.stack([e["mvx"], e["mvy"]], -1),
                             best_cost, e["lev_y"], e["lev_u"], e["lev_v"],
                             to_plane(e["rec_y"]).to(u8),
                             to_plane(e["rec_u"]).to(u8),
                             to_plane(e["rec_v"]).to(u8)),
                amvp=e["amvp"])


def fixed_result(mvs, best_cost, lev_y, lev_u, lev_v, recon_y, recon_u,
                 recon_v) -> dict:
    """The fixed-CU P stage's result from its block outputs (block rows
    first: MVs, best integer costs, levels per block) and uint8
    reconstructions, with the one-buffer host wire."""
    mvs = mvs.to(I32)
    ly16 = lev_y.to(torch.int16)
    lu16 = lev_u.to(torch.int16)
    lv16 = lev_v.to(torch.int16)
    best_cost = best_cost.to(I32)
    meta = torch.cat([mvs.reshape(-1), best_cost.reshape(-1)])
    return dict(
        mvs=mvs,
        sad=best_cost,            # best integer ME cost (scene-cut signal)
        lev_y=ly16, lev_u=lu16, lev_v=lv16,
        # one buffer for everything the host needs per P frame: levels,
        # then the int32 MVs and costs bitcast to int16 pairs
        wire=torch.cat([ly16.reshape(-1), lu16.reshape(-1), lv16.reshape(-1),
                        meta.view(torch.int16)]),
        recon_y=recon_y, recon_u=recon_u, recon_v=recon_v,
    )


@functools.lru_cache(maxsize=None)
def _mv_bits_grid4(R4: int) -> np.ndarray:
    """MV bit proxy of every coarse offset (4 * d full-pel), (n4*n4,)
    dy-major."""
    bits1 = _bits_tab(16 * R4)[np.abs(16 * np.arange(-R4, R4 + 1))]
    return (bits1[:, None] + bits1[None, :]).reshape(-1).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _zero_anchor_bits() -> np.ndarray:
    """MV bit proxy of the 49 zero-anchor offsets (+-3 full-pel), dy-major."""
    t = _bits_tab(28)
    return np.array([t[abs(4 * dy)] + t[abs(4 * dx)]
                     for dy in range(-3, 4) for dx in range(-3, 4)], np.int32)


def _pool2(g: torch.Tensor) -> torch.Tensor:
    """2x2 sum-pool of the last two axes (SAD additivity: a parent block's
    SAD grid from its four children's)."""
    return block_sum(g, 2, 2)


def _me_hier_coarse(cur, ry, *, sizes, search, lam):
    """Coarse level of the hierarchical ME: {S: (cy, cx, zS)}, the pyramid
    pick of every S-block in full-pel (flat, raster order) and the 49
    zero-anchor SAD grids (49, H/S, W/S) pooled to that size.

    A dense sweep of +-search/4 offsets on 4:1 box-summed planes gives
    per-16 SAD grids; they and the zero-anchor grids are pooled up to each
    size; the pick is the first minimum with the coarse MV cost, dy-major."""
    dev = cur.device
    R4 = search // 4
    n4 = 2 * R4 + 1
    cur = cur.to(I32)
    # the coarse sweep is the SAD grid sweep on the pooled planes: 4x4
    # pooled cells per 16-block, offsets +-R4 inside a pad of PAD / 4
    gS = sad_grids(block_sum(cur, 4, 4), block_sum(ry, 4, 4), S=4,
                   search=R4, pad=PAD // 4)         # (n4*n4, H/16, W/16)
    zS = sad_grids(cur, ry, S=16, search=3, pad=PAD)    # (49, H/16, W/16)
    mvcost4 = (lam * const(_mv_bits_grid4(R4), dev)) >> 8
    out = {}
    S = 16
    for size in sorted(s for s in sizes if s >= 16):
        while S < size:                                 # pool up to `size`
            gS, zS = _pool2(gS), _pool2(zS)
            S *= 2
        k = first_argmin(gS + mvcost4[:, None, None], 0).to(I32)
        out[size] = ((4 * (k // n4 - R4)).reshape(-1),
                     (4 * (k % n4 - R4)).reshape(-1), zS)
    return out


def _me_hier(cur, ry, *, sizes, search, lam, kernels: bool = True):
    """Hierarchical wide-window integer ME (search > HIER_THRESHOLD), the
    reference's `_me_hier` for block sizes 8, 16, 32 and 64.

      coarse: `_me_hier_coarse` (sizes 16 and up);
      refine: full-resolution +-3 around BOTH the zero MV (49 costs from
              static shifted-plane grids, shared across sizes by pooling)
              and the coarse pick (one per-block window gather per size).
              98 ordered candidates, zero anchor first, first minimum;
      8:      each 8-block is seeded from its parent 16-block's refined MV
              (clipped to +-search) and refined the same way against its
              own zero-anchor grids (sizes with 8 hold 16 as well).

    Returns {S: (ivy, ivx, icost)} (nby, nbx) int32 with |mv| <= search + 3.
    """
    H, W = cur.shape
    dev = cur.device
    cur = cur.to(I32)
    coarse = _me_hier_coarse(cur, ry, sizes=sizes, search=search, lam=lam)
    zcost_off = (lam * const(_zero_anchor_bits(), dev)) >> 8
    bits_f = const(_bits_tab(4 * search + 16), dev)
    cur16 = cur.to(torch.int16)
    d7 = torch.arange(-3, 4, device=dev, dtype=I32)

    def refine(size, vy, vx, zS):
        nby, nbx = H // size, W // size
        nb = nby * nbx
        bi = torch.arange(nb, device=dev, dtype=I32)
        r = bi // nbx
        c = bi % nbx
        zc = zS.reshape(49, nb) + zcost_off[:, None]
        blk = _blocks(cur16, size)
        win = gather_windows(ry, r * size + vy - 3 + PAD,
                             c * size + vx - 3 + PAD, size + 6,
                             kernels=kernels)           # (nb, size+6, size+6)
        # all 49 shifts of the window as a strided view: (nb, 7, 7, s, s);
        # 8-bit samples, so the int16 differences cannot overflow
        shifts = win.unfold(1, size, 1).unfold(2, size, 1)
        sad = ((blk[:, None, None] - shifts).abs()
               .sum(dim=(-1, -2), dtype=I32))           # (nb, 7, 7)
        bb = (bits_f[(4 * (vy[:, None] + d7)).abs()][:, :, None]
              + bits_f[(4 * (vx[:, None] + d7)).abs()][:, None, :])
        cs = sad + ((lam * bb) >> 8)
        cost98 = torch.cat([zc, cs.reshape(nb, 49).T])  # zero anchor first
        j = first_argmin(cost98, 0).to(I32)
        icost = cost98.min(dim=0).values
        jj = j % 49
        dy = jj // 7 - 3
        dx = jj % 7 - 3
        is_pyr = j >= 49
        ivy = torch.where(is_pyr, vy + dy, dy).reshape(nby, nbx)
        ivx = torch.where(is_pyr, vx + dx, dx).reshape(nby, nbx)
        return ivy, ivx, icost.reshape(nby, nbx).to(I32)

    out = {size: refine(size, *coarse[size]) for size in sorted(coarse)}
    if 8 in sizes:
        ivy16, ivx16, _ = out[16]

        def seed(v):
            return (v.repeat_interleave(2, 0).repeat_interleave(2, 1)
                    .clamp(-search, search).reshape(-1))

        z8 = sad_grids(cur, ry, S=8, search=3, pad=PAD)
        out[8] = refine(8, seed(ivy16), seed(ivx16), z8)
    return out


def worst_n(cost: torch.Tensor, n_sel: int) -> torch.Tensor:
    """Indices of the n_sel largest entries of a 1-D cost, ties going to the
    lower index (what jax.lax.top_k returns; torch.topk promises no order
    among ties, a stable descending sort does)."""
    return torch.sort(cost, descending=True, stable=True).indices[:n_sel]


def _up(a: torch.Tensor, k: int) -> torch.Tensor:
    """Each entry of a 2-D grid repeated k x k times."""
    return a.repeat_interleave(k, 0).repeat_interleave(k, 1)


def _upu(a: torch.Tensor, S: int) -> torch.Tensor:
    """Block grid (at block size S) -> 4x4-unit grid."""
    return _up(a, S // 4)


def _intra_in_p(cur, u_pad, v_pad, rec, c32eff, *, qp, lamf, sign_hiding,
                qp_rows=None):
    """Per-CU intra fallback of the tree P stage (CTU 32): whole CTUs whose
    best intra-32 encode beats the tree's chosen inter cost.

    Runs on the N CTUs with the worst inter RD cost only (`worst_n`), codes
    them (`_intra_candidates`) and accepts them through the 4-colour
    cascade (`_intra_cascade`). With `qp_rows` each candidate codes at its
    CTU row's QP; the RD lambda `lamf` stays the frame's. Returns (acc
    (nby, nbx) bool, mode (nby, nbx), luma (lev, rec) (nby, nbx, 32, 32),
    [(lev, rec) (nby, nbx, 16, 16) for U and V])."""
    nb_all = c32eff.numel()
    sel_idx = worst_n(c32eff.reshape(-1), intra_sel_count(nb_all))
    icst, im, luma, outs_c = _intra_candidates(
        cur, u_pad, v_pad, rec, sel_idx, qp=qp, lamf=lamf,
        sign_hiding=sign_hiding, qp_rows=qp_rows)
    return _intra_cascade(icst < c32eff), im, luma, outs_c


def intra_sel_count(nb_all: int) -> int:
    """How many of a frame's `nb_all` CTUs intra-in-P tries: the worst N by
    inter cost, counted over the whole frame."""
    return min(nb_all, max(128, nb_all // 8))


def _intra_candidates(cur, u_pad, v_pad, rec, sel_idx, *, qp, lamf,
                      sign_hiding, qp_rows=None, above=None, row0: int = 0):
    """The intra-32 encode of the CTUs `sel_idx` (raster indices into the
    planes' CTU grid). References come from the pre-deblock inter
    reconstruction `rec` with the decoder's availability clips; the 11-mode
    battery is ranked by SAD, the top 2 are full-coded, the winner is
    re-coded with sign hiding.

    For a band of a frame (parallel/sharded.py): `row0` is the band's first
    CTU row in the frame, and `above` the last row of the band above's
    `rec` (luma, Cb, Cr): the top references of the band's first CTU row,
    top-right samples included, read from it and count as available, as in
    the whole frame. Returns (cost (nby, nbx), 1 << 30 where not tried,
    mode, luma (lev, rec), [(lev, rec) for U and V]), every grid over the
    planes' CTUs."""
    from .intra_torch import encode_block_one_mode
    H, W = cur.shape
    dev = cur.device
    nby, nbx = H // 32, W // 32
    nb_all = nby * nbx
    n_sel = sel_idx.numel()
    recy, recu, recv = rec
    rr = torch.arange(nby, device=dev)
    cc = torch.arange(nbx, device=dev)
    hl = (cc[None] > 0).expand(nby, nbx).reshape(-1)
    ht = (rr[:, None] + row0 > 0).expand(nby, nbx).reshape(-1)

    def rings(plane, n, above_row):
        """Top (2n samples, clipped at the plane's last column), left (n
        samples, the last replicated below) and corner of every n-block;
        the first row's top and corner from `above_row` when given."""
        o = int(above_row is not None)
        if o:
            plane = torch.cat([above_row[None].to(plane.dtype), plane])
        ph, pw = plane.shape
        ar = torch.arange(2 * n, device=dev)
        ty = (rr * n - 1 + o).clamp(min=0)
        lx = (cc * n - 1).clamp(min=0)
        top = plane[ty[:, None, None],
                    (cc[None, :, None] * n + ar).clamp(0, pw - 1)]
        left = plane[(rr[:, None, None] * n + ar.clamp(max=n - 1) + o)
                     .clamp(0, ph - 1), lx[None, :, None]]
        corner = plane[ty[:, None], lx[None]]
        return (top.reshape(nb_all, -1), left.reshape(nb_all, -1),
                corner.reshape(-1))

    above = (None,) * 3 if above is None else above
    if qp_rows is not None:
        qp = qp_rows.to(I32)[sel_idx // nbx]         # (N,) each CTU's row
    topv, leftv, cornr = (t[sel_idx] for t in rings(recy, 32, above[0]))
    o = _blocks(cur, 32)[sel_idx]
    hl_s, ht_s = hl[sel_idx], ht[sel_idx]

    # stage 1: rank the 11-mode battery by SAD; stage 2: full-code the top 2
    refs = intra_ops.prepare_refs(topv, leftv, cornr, hl_s, ht_s, size=32,
                                  c_idx=0, strong_smoothing=True)
    modes = const(INTRA_IN_P_MODES, dev)
    preds11 = intra_ops.predict_all_modes(*refs, size=32, c_idx=0)[:, modes]
    sad11 = (o[:, None] - preds11).abs().sum(dim=(-1, -2))
    lanes = torch.arange(n_sel, device=dev)
    k1 = first_argmin(sad11, 1)
    sad_2 = sad11.clone()
    sad_2[lanes, k1] = 1 << 30
    k2 = first_argmin(sad_2, 1)
    mode_c = torch.stack([k1, k2], 1)                        # (N, 2)
    preds = preds11[lanes[:, None], mode_c]                  # (N, 2, 32, 32)
    o2 = o[:, None]
    coeff = tx_ops.forward_transform(o2 - preds)
    lev = quant_ops.quantize(coeff, qp, 5, is_intra=True)
    rr_ = tx_ops.inverse_transform(quant_ops.dequantize(lev, qp, 5))
    nz_ = (lev != 0).any(dim=-1).any(dim=-1)
    rr_ = torch.where(nz_[..., None, None], rr_, 0)
    rec_ = (preds + rr_).clamp(0, 255)
    ssd = ((o2 - rec_) * (o2 - rec_)).sum(dim=(-1, -2))
    bits = torch.clamp(tables.level_bits_est_t(lev), max=16383)
    cost = ssd + (((lamf >> 4) * (bits + 8)) >> 4)
    k = first_argmin(cost, 1)
    icst_s = cost[lanes, k].to(I32)
    im_s = modes[mode_c[lanes, k]].to(I32)
    pred_k = preds[lanes, k]
    ilev_s = lev[lanes, k]
    if sign_hiding:
        ilev_s = quant_ops.sign_bit_hiding(ilev_s, coeff[lanes, k], qp, 5)
        rr_k = tx_ops.inverse_transform(quant_ops.dequantize(ilev_s, qp, 5))
        nz_k = (ilev_s != 0).any(dim=-1).any(dim=-1)
        rr_k = torch.where(nz_k[:, None, None], rr_k, 0)
        irec_s = (pred_k + rr_k).clamp(0, 255)
    else:
        irec_s = rec_[lanes, k]

    def spread(vals, fill=0):
        full = torch.full((nb_all,) + vals.shape[1:], fill, dtype=vals.dtype,
                          device=dev)
        full[sel_idx] = vals
        return full.reshape((nby, nbx) + vals.shape[1:])

    im = spread(im_s)
    icst = spread(icst_s, 1 << 30)

    # chroma: the luma mode (DM) at 16x16, one mode per CU
    qp_c = tables.chroma_qp_t(qp)
    outs_c = []
    for rc_c, plane_c, ab in ((recu, u_pad, above[1]),
                              (recv, v_pad, above[2])):
        topc, leftc, corc = (t[sel_idx] for t in rings(rc_c, 16, ab))
        lvc_s, rcc_s = encode_block_one_mode(
            _blocks(plane_c.to(I32), 16)[sel_idx], topc, leftc, corc, hl_s,
            ht_s, im_s, size=16, c_idx=1, qp=qp_c, strong_smoothing=False,
            sign_hiding=sign_hiding)
        outs_c.append((spread(lvc_s), spread(rcc_s)))
    return icst, im, (spread(ilev_s), spread(irec_s)), outs_c


def _intra_cascade(cand: torch.Tensor) -> torch.Tensor:
    """Acceptance of the intra candidates `cand` (nby, nbx) bool, a whole
    frame's CTU grid: a 4-colour cascade so that no accepted CU's
    reference ring touches another accepted CU. Colour k accepts only where
    no earlier accept lies in its 8-neighbourhood; same-colour CUs never
    share a ring. Every neighbour an accepted CU predicts from keeps its
    inter reconstruction, so the order-free batch equals the decoder's
    sequential result."""
    nby, nbx = cand.shape
    dev = cand.device
    rr = torch.arange(nby, device=dev)
    cc = torch.arange(nbx, device=dev)
    col = (rr[:, None] % 2) * 2 + (cc[None] % 2)
    acc = torch.zeros((nby, nbx), dtype=torch.bool, device=dev)

    def ring(m):
        p = torch.nn.functional.pad(m, (1, 1, 1, 1))
        return (p[:-2, :-2] | p[:-2, 1:-1] | p[:-2, 2:]
                | p[1:-1, :-2] | p[1:-1, 2:]
                | p[2:, :-2] | p[2:, 1:-1] | p[2:, 2:])

    for kcol in range(4):
        acc = acc | (cand & (col == kcol) & ~ring(acc))
    return acc


def _p_stage_tree(y_pad, u_pad, v_pad, ry, ru, rv, *, ctu: int, qp,
                  search: int, me_precision: int, sign_hiding: bool,
                  tr_split: bool = False, intra_in_p: bool = False,
                  cu8: bool = False, qp_rows=None, wpp: bool = False,
                  vis=None, kernels: bool = True):
    """Inter CU quadtree P stage (CTU 32 or 64 -> 16, or -> 8 with `cu8`;
    PU = TU = CU unless `tr_split`), the reference's `_p_stage_tree`.

    One integer search for all levels (hierarchical above HIER_THRESHOLD,
    else the dense SAD grid sweep at the finest level with the parents'
    grids pooled from it); every level is subpel-refined and residual-coded
    batched, and the split choice is a dense masked select over the node
    costs, bottom up (`_tree_levels`). `intra_in_p` (CTU 32 only) adds the
    per-CU intra fallback. `qp_rows` (H // ctu,) codes each CTU row at its
    own QP (cu_qp_delta; the ME lambda and the split overhead stay at the
    frame QP `qp`, the slice QP), and `wpp` selects the decoder's QP
    prediction with entropy sync (see `decoded_qp_maps`). Returns the unit
    maps (4x4 units), the decoded-QP maps, the selected level planes and
    reconstruction, and the one-buffer host wire of the per-frame path
    (`tree_finish`). A band of a frame (parallel/sharded.py) runs these
    phases one by one with what it reads of the other bands: `_tree_levels`
    (`top_mv`), `_intra_candidates` (`above`, `row0`), `_intra_cascade` on
    the frame's grid, `tree_finish` (`qp_start`)."""
    st = _tree_levels(y_pad, u_pad, v_pad, ry, ru, rv, ctu=ctu, qp=qp,
                      search=search, me_precision=me_precision,
                      sign_hiding=sign_hiding, tr_split=tr_split, cu8=cu8,
                      qp_rows=qp_rows, vis=vis, kernels=kernels)
    if intra_in_p and ctu == 32:
        intra = _intra_in_p(st["cur"], u_pad, v_pad, st["rec"], st["c32eff"],
                            qp=st["qp"], lamf=st["lamf"],
                            sign_hiding=sign_hiding, qp_rows=qp_rows)
        tree_intra(st, *intra)
    return tree_finish(st, qp_rows=qp_rows, wpp=wpp)


def _tree_levels(y_pad, u_pad, v_pad, ry, ru, rv, *, ctu: int, qp,
                 search: int, me_precision: int, sign_hiding: bool,
                 tr_split: bool = False, cu8: bool = False, qp_rows=None,
                 vis=None, kernels: bool = True, top_mv=None) -> dict:
    """The inter half of `_p_stage_tree`: integer search, every level's
    encode and the bottom-up split select. `top_mv` {S: (nbx, 2)}: the
    refined MVs of the S-row above the first, per level (see
    `_level_encode`). Returns the stage's state: the selected unit maps and
    planes, the CTU-32 node costs `c32eff` (what intra-in-P competes with)
    and `top` {S: the last S-row's refined MVs}, what a band below reads as
    its `top_mv`."""
    if ctu not in (32, 64):
        raise NotImplementedError(f"tree P stage at ctu={ctu} (32 and 64 are "
                                  "ported)")
    H, W = y_pad.shape
    dev = y_pad.device
    qp = _qp_tensor(qp, dev)
    qp_c = tables.chroma_qp_t(qp)
    lam = const(tables.LAMBDA_ME_FX_P, dev)[qp]
    lamf = const(tables.LAMBDA_FX_P, dev)[qp]
    if qp_rows is not None and tuple(qp_rows.shape) != (H // ctu,):
        raise ValueError(f"qp_rows must hold one QP per CTU row "
                         f"({H // ctu}), not {tuple(qp_rows.shape)}")
    cur = y_pad.to(I32)
    sizes = ((8,) if cu8 else ()) + (16, 32) + ((64,) if ctu == 64 else ())

    if search > HIER_THRESHOLD:
        ints = _me_hier(cur, ry, sizes=sizes, search=search, lam=lam,
                        kernels=kernels)
    else:
        n = 2 * search + 1
        mvcost = (lam * const(_mv_bits_grid(search), dev)) >> 8
        # one sweep at the finest level; each parent's grid is the 2x2
        # sum-pool of its children's (exact: SAD is additive)
        grids = {sizes[0]: sad_grids(cur, ry, S=sizes[0], search=search,
                                     pad=PAD)}
        for S in sizes[1:]:
            grids[S] = _pool2(grids[S // 2])
        ints = {}
        for S, g in grids.items():
            cost = g + mvcost[:, None, None]
            k = first_argmin(cost, 0).to(I32)           # first min, dy-major
            ints[S] = (k // n - search, k % n - search,
                       cost.min(dim=0).values.to(I32))

    enc = {}
    for S in sizes:
        ivy, ivx, icost = ints[S]
        enc[S] = _level_encode(cur, u_pad, v_pad, ry, ru, rv, ivy, ivx, S=S,
                               qp=qp, qp_c=qp_c, lam=lam, search=search,
                               me_precision=me_precision,
                               sign_hiding=sign_hiding, tr_split=tr_split,
                               qp_rows=qp_rows, vis=vis, kernels=kernels,
                               top_mv=None if top_mv is None else top_mv[S])
        enc[S]["icost"] = icost

    # bottom-up split select: a node splits when its four children's best
    # costs plus the split overhead proxy beat coding it whole
    ov = ((lamf >> 4) * 10) >> 4
    best = {sizes[0]: enc[sizes[0]]["cost"]}
    split = {}
    for S in sizes[1:]:
        cs = _pool2(best[S // 2]) + ov
        split[S] = cs < enc[S]["cost"]
        best[S] = torch.where(split[S], cs, enc[S]["cost"]).to(I32)
    # CU depth per unit: one more level wherever every enclosing node split
    depth_u = torch.zeros((H // 4, W // 4), dtype=I32, device=dev)
    inside = torch.ones_like(depth_u, dtype=torch.bool)
    for S in reversed(sizes[1:]):
        inside = inside & _upu(split[S], S)
        depth_u = depth_u + inside.to(I32)
    ctu_log2 = ctu.bit_length() - 1

    def by_depth(d_map, vals):
        """vals {S: tensor} -> the entry of the CU size at each depth."""
        out = vals[sizes[0]]
        for S in sizes[1:]:
            m = d_map == ctu_log2 - (S.bit_length() - 1)
            out = torch.where(m.reshape(m.shape + (1,) * (out.dim()
                                                          - m.dim())),
                              vals[S], out)
        return out

    def mv_units(e, S):
        return torch.stack([_upu(e["mvx"], S), _upu(e["mvy"], S)], -1)

    def cbf_units(e, S):
        lv = e["lev_y"]
        if S == 64:                                     # TU 32 inside
            nby, nbx = lv.shape[:2]
            c = (lv.reshape(nby, nbx, 2, 32, 2, 32) != 0).any(5).any(3)
            return _upu(c.permute(0, 2, 1, 3).reshape(nby * 2, nbx * 2), 32)
        return _upu((lv != 0).any(dim=-1).any(dim=-1), S)

    mv_u = by_depth(depth_u, {S: mv_units(e, S) for S, e in enc.items()})
    cbf_u = by_depth(depth_u, {S: cbf_units(e, S) for S, e in enc.items()})
    # only 32-CUs carry a depth-1 residual quadtree
    trd_u = ((_upu(enc[32]["trd"], 32)
              * (depth_u == ctu_log2 - 5)).to(I32) if tr_split
             else torch.zeros_like(depth_u))

    def sel_plane(key, sub):                            # sub: 4 luma, 2 chroma
        d_px = depth_u.repeat_interleave(sub, 0).repeat_interleave(sub, 1)
        return by_depth(d_px, {S: to_plane(e[key]) for S, e in enc.items()})

    return dict(
        cur=cur, qp=qp, lamf=lamf, ctu=ctu, cu8=cu8, tr_split=tr_split,
        depth_u=depth_u, mv_u=mv_u, cbf_u=cbf_u, trd_u=trd_u,
        pred_intra_u=torch.zeros_like(depth_u),
        lev=[sel_plane("lev_y", 4), sel_plane("lev_u", 2),
             sel_plane("lev_v", 2)],
        rec=(sel_plane("rec_y", 4), sel_plane("rec_u", 2),
             sel_plane("rec_v", 2)),
        c32eff=best[32], sad=enc[ctu]["icost"],
        top={S: e["amvp"][-1] for S, e in enc.items()})


def tree_intra(st: dict, acc, im, luma, outs_c) -> None:
    """Put the accepted intra-in-P CUs (`_intra_in_p`'s outputs, `acc`
    over the state's CTU grid) into a `_tree_levels` state, in place: their
    levels and reconstruction, depth 0, no TU split, the intra flag, and
    the luma mode in the MV's x slot of the wire."""
    ilev, irec = luma

    def sub_plane(plane, blocks_new, S):
        m = acc.repeat_interleave(S, 0).repeat_interleave(S, 1)
        return torch.where(m, to_plane(blocks_new), plane)

    lev = st["lev"]
    lev[0] = sub_plane(lev[0], ilev, 32)
    lev[1] = sub_plane(lev[1], outs_c[0][0], 16)
    lev[2] = sub_plane(lev[2], outs_c[1][0], 16)
    rec = st["rec"]
    st["rec"] = (sub_plane(rec[0], irec, 32),
                 sub_plane(rec[1], outs_c[0][1], 16),
                 sub_plane(rec[2], outs_c[1][1], 16))
    accu = _upu(acc, 32)
    st["pred_intra_u"] = accu.to(I32)
    st["depth_u"] = torch.where(accu, 0, st["depth_u"])
    st["trd_u"] = torch.where(accu, 0, st["trd_u"])
    imode_u = _upu(im, 32)
    st["mv_u"] = torch.where(
        accu[..., None], torch.stack([imode_u, torch.zeros_like(imode_u)],
                                     -1), st["mv_u"])
    st["cbf_u"] = torch.where(
        accu, _upu((ilev != 0).any(dim=-1).any(dim=-1), 32), st["cbf_u"])


def tree_finish(st: dict, *, qp_rows=None, wpp: bool = False,
                qp_start=None) -> dict:
    """The tree P stage's result from a `_tree_levels` state (after
    `tree_intra`): TB-granular cbf, the per-unit nonzero map, the
    decoded-QP maps (`qp_start`: see `decoded_qp_maps`) and the wire."""
    depth_u, trd_u = st["depth_u"], st["trd_u"]
    lev_yp, lev_up, lev_vp = st["lev"]
    ctu, cu8 = st["ctu"], st["cu8"]
    H, W = lev_yp.shape
    cbf_u = st["cbf_u"]
    if st["tr_split"]:
        # TB-granular luma cbf for deblocking: split CUs deblock their
        # interior TU edges from per-16 coefficient presence
        nz16 = (lev_yp.reshape(H // 16, 16, W // 16, 16) != 0).any(3).any(1)
        cbf_u = torch.where(trd_u.to(torch.bool), _upu(nz16, 16), cbf_u)

    # per-unit any-nonzero (Y | Cb | Cr) for the host's skip derivation
    uh, uw = H // 4, W // 4
    nz = ((lev_yp.reshape(uh, 4, uw, 4) != 0).any(3).any(1)
          | (lev_up.reshape(uh, 2, uw, 2) != 0).any(3).any(1)
          | (lev_vp.reshape(uh, 2, uw, 2) != 0).any(3).any(1)).to(I32)

    # the reference models CU QPs per 16x16 block, which is exact unless
    # 8x8 CUs are coded; the port keeps that model at CTU 32 (its AUs equal
    # the reference's) and, at CTU 64, where the reference has none, models
    # 8x8 CUs exactly
    qp = st["qp"]
    qp_ctu, qp_u = decoded_qp_maps(qp, qp_rows, ctu=ctu, nz_u=nz,
                                   depth_u=depth_u, wpp=wpp,
                                   block=8 if cu8 and ctu == 64 else 16,
                                   qp_start=qp_start)
    u8 = torch.uint8
    return tree_result(depth_u, st["mv_u"], cbf_u, trd_u,
                       st["pred_intra_u"], nz, qp_ctu, qp_u, st["sad"],
                       lev_yp, lev_up, lev_vp, *(p.to(u8) for p in st["rec"]))


def tree_result(depth_u, mv_u, cbf_u, trd_u, pred_intra_u, nz_u, qp_ctu,
                qp_u, sad, lev_y, lev_u, lev_v, recon_y, recon_u,
                recon_v) -> dict:
    """The tree P stage's result dict from its maps, level planes and uint8
    reconstruction, with the one-buffer host wire of the per-frame path
    (levels, then the unit maps and the per-CTU SAD as int32 bitcast to
    int16 pairs)."""
    ly16 = lev_y.to(torch.int16)
    lu16 = lev_u.to(torch.int16)
    lv16 = lev_v.to(torch.int16)
    mv_u = mv_u.to(I32)
    meta = torch.cat([depth_u.reshape(-1), mv_u.reshape(-1),
                      nz_u.reshape(-1), trd_u.reshape(-1),
                      pred_intra_u.reshape(-1), sad.reshape(-1)])
    return dict(
        depth_u=depth_u, mv_u=mv_u, cbf_u=cbf_u, trd_u=trd_u,
        pred_intra_u=pred_intra_u, nz_u=nz_u, qp_ctu=qp_ctu,
        qp16=qp_u[::4, ::4], qp_u=qp_u, sad=sad,
        lev_y=ly16, lev_u=lu16, lev_v=lv16,
        wire=torch.cat([ly16.reshape(-1), lu16.reshape(-1), lv16.reshape(-1),
                        meta.view(torch.int16)]),
        recon_y=recon_y, recon_u=recon_u, recon_v=recon_v,
    )


@functools.lru_cache(maxsize=None)
def _zorder(hb: int, wb: int, k: int) -> np.ndarray:
    """Z-order index of every block inside its CTB of k x k blocks."""
    by = (np.arange(hb) % k)[:, None]
    bx = (np.arange(wb) % k)[None, :]
    z = np.zeros((hb, wb), np.int32)
    for b in range(k.bit_length()):
        z |= (((by >> b) & 1) << (2 * b + 1)) | (((bx >> b) & 1) << (2 * b))
    return z


def decoded_qp_maps(qp, qp_rows, *, ctu: int, nz_u, depth_u, wpp: bool,
                    block: int = 16, qp_start=None):
    """The QPs a decoder assigns to a tree P frame coded with per-CTU-row
    targets `qp_rows` (one quantisation group per CTB): `qp_ctu` (H/ctu,
    W/ctu), what the syntax carries, and `qp_u` (H/4, W/4), what the
    deblocking filter reads. Both are the frame QP `qp` without row plans.

    A CTB with any coded residual (`nz_u`, 4x4 units, Y or Cb or Cr) codes
    cu_qp_delta and takes its row's target; an uncoded one keeps the
    prediction, which is the QP of the last coded CTB before it in its row,
    else the row's start value: the slice QP on every row with WPP (entropy
    sync resets the predictor), the last coded row's target without it.
    Inside a CTB the decoder assigns QPs per CU as it parses, so CUs before
    the first coded CU in z-order keep the prediction. CUs are read from
    `depth_u` in blocks of `block` (8 or 16) samples: a CU smaller than a
    block counts as the whole block, so 16 is exact unless 8x8 CUs are
    coded and 8 always is. For a band of a frame without WPP, `qp_start`
    is the start value of its first row when no row of the band is coded
    before it: the target of the last coded row of the bands above, else
    the slice QP (`qp_carry` passes it on)."""
    dev = nz_u.device
    uh, uw = nz_u.shape
    nby, nbx = uh * 4 // ctu, uw * 4 // ctu
    if qp_rows is None:
        return qp.expand(nby, nbx), qp.expand(uh, uw)
    g = ctu // 4
    coded = (nz_u != 0).reshape(nby, g, nbx, g).any(3).any(1)
    rows = qp_rows.to(I32)
    row_t = rows[:, None].expand(nby, nbx)
    ci = coded.to(I32)
    seen_before = (torch.cumsum(ci, 1) - ci) > 0
    if wpp:
        start = qp.expand(nby)
    else:
        # the target of the last coded row strictly above, else the slice QP
        ri = torch.arange(nby, device=dev)
        last = torch.cummax(torch.where(coded.any(1), ri, -1), 0).values
        last = torch.cat([last.new_full((1,), -1), last[:-1]])
        start = torch.where(last >= 0, rows[last.clamp(min=0)],
                            qp if qp_start is None else qp_start)
    pred = torch.where(seen_before, row_t, start[:, None])
    qp_ctu = torch.where(coded, row_t, pred)

    # per block: before or from the CTB's first coded CU in z-order
    g = block // 4                                  # units per block
    hb, wb = uh // g, uw // g
    k = ctu // block
    nzb = (nz_u != 0).reshape(hb, g, wb, g).any(3).any(1)
    db = depth_u[::g, ::g]
    m = ((torch.full_like(db, ctu) >> db) // block).clamp(min=1)  # CU side
    z = const(_zorder(hb, wb, k), dev)
    cu_first = z & ~(m * m - 1)               # z of the CU's first block
    cu_coded = nzb
    s = 1
    while s < k:
        s *= 2
        pooled = nzb.reshape(hb // s, s, wb // s, s).any(3).any(1)
        cu_coded = torch.where(m == s, _up(pooled, s), cu_coded)
    first = torch.where(cu_coded, cu_first, 1 << 20)
    first = first.reshape(nby, k, nbx, k).amin(3).amin(1)
    qp_b = torch.where(cu_first >= _up(first, k), _up(row_t, k),
                       _up(pred, k))
    return qp_ctu, _up(qp_b, g)


def qp_carry(qp_rows, nz_u, ctu: int, qp_start):
    """The decoded-QP start value that rows below these ones inherit
    without WPP: the target of the last CTU row here with any coded
    residual (`nz_u`, 4x4 units), else `qp_start`."""
    uh, uw = nz_u.shape
    coded = (nz_u != 0).reshape(uh * 4 // ctu, -1).any(1)
    ri = torch.arange(coded.shape[0], device=nz_u.device)
    last = torch.where(coded, ri, -1).max()
    return torch.where(last >= 0, qp_rows.to(I32)[last.clamp(min=0)],
                       qp_start)


def tree_deblock(rec, res, ctu: int):
    """Loop filter of a tree P frame from its unit maps."""
    bs_v, bs_h = dbk.inter_bs_from_units(
        res["depth_u"], res["mv_u"], res["cbf_u"], ctu.bit_length() - 1,
        trd_u=res["trd_u"], intra_u=res["pred_intra_u"])
    return dbk.deblock_frame(rec[0], rec[1], rec[2], bs_v=bs_v, bs_h=bs_h,
                             qp_map=res["qp_u"])


def inter_deblock(rec, mvs, lev_y, qp, B: int):
    """Loop filter of a fixed-grid P frame: bS from MVs and luma cbf (per
    32-TB quadrant of a 64-CU)."""
    H, W = rec[0].shape
    cbf_blk = (lev_y != 0).any(dim=-1).any(dim=-1)
    qcbf = None
    if B == 64:
        nby, nbx = cbf_blk.shape
        qcbf = (lev_y.reshape(nby, nbx, 2, 32, 2, 32) != 0).any(5).any(3)
    bs_v, bs_h = dbk.inter_bs_from_blocks(mvs, cbf_blk, B, qcbf=qcbf)
    qp_map = _qp_tensor(qp, rec[0].device).expand(H // 4, W // 4)
    return dbk.deblock_frame(rec[0], rec[1], rec[2], bs_v=bs_v, bs_h=bs_h,
                             qp_map=qp_map)


def p_frame_device(y_pad, u_pad, v_pad, ref_y, ref_u, ref_v, *, B: int, qp,
                   search: int, me_precision: int, deblock: bool = False,
                   sign_hiding: bool = False, kernels: bool = True):
    """One P frame against the previous decoded frame (uint8 planes).
    Returns the reference's p_frame_device dict (plus ref_* when
    deblocking)."""
    ry = edge_pad(ref_y.to(torch.int16), PAD)
    ru = edge_pad(ref_u.to(torch.int16), PAD // 2)
    rv = edge_pad(ref_v.to(torch.int16), PAD // 2)
    result = _p_stage(y_pad, u_pad, v_pad, ry, ru, rv, B=B, qp=qp,
                      search=search, me_precision=me_precision,
                      sign_hiding=sign_hiding, kernels=kernels)
    return with_loop_filter(result, qp, B) if deblock else result


def with_loop_filter(result: dict, qp, B: int) -> dict:
    """Add the loop-filtered planes ref_* to a fixed-CU P stage's result."""
    rec = tuple(result[k].to(I32) for k in ("recon_y", "recon_u", "recon_v"))
    fy, fu, fv = inter_deblock(rec, result["mvs"], result["lev_y"], qp, B)
    result["ref_y"] = fy.to(torch.uint8)
    result["ref_u"] = fu.to(torch.uint8)
    result["ref_v"] = fv.to(torch.uint8)
    return result


def p_frame_tree_device(y_pad, u_pad, v_pad, ref_y, ref_u, ref_v, *, ctu: int,
                        qp, search: int, me_precision: int,
                        deblock: bool = False, sign_hiding: bool = False,
                        tr_split: bool = False, intra_in_p: bool = False,
                        cu8: bool = False, qp_rows=None, wpp: bool = False,
                        vis=None, kernels: bool = True):
    """One quadtree P frame against the previous decoded frame (uint8
    planes): `_p_stage_tree` plus the loop filter of the selected
    reconstruction at the decoded QPs. Returns the reference's
    p_frame_tree_device dict."""
    ry = edge_pad(ref_y.to(torch.int16), PAD)
    ru = edge_pad(ref_u.to(torch.int16), PAD // 2)
    rv = edge_pad(ref_v.to(torch.int16), PAD // 2)
    result = _p_stage_tree(y_pad, u_pad, v_pad, ry, ru, rv, ctu=ctu, qp=qp,
                           search=search, me_precision=me_precision,
                           sign_hiding=sign_hiding, tr_split=tr_split,
                           intra_in_p=intra_in_p, cu8=cu8, qp_rows=qp_rows,
                           wpp=wpp, vis=vis, kernels=kernels)
    if deblock:
        rec = tuple(result[k].to(I32)
                    for k in ("recon_y", "recon_u", "recon_v"))
        fy, fu, fv = tree_deblock(rec, result, ctu)
        result["ref_y"] = fy.to(torch.uint8)
        result["ref_u"] = fu.to(torch.uint8)
        result["ref_v"] = fv.to(torch.uint8)
    return result


def deblock_intra_device(rec_y, rec_u, rec_v, *, qp, depth_units,
                         trd_units=None):
    """Deblocking of an all-intra frame; `depth_units` is the unit-granular
    CU depth map relative to 32-containers (TU = 32 >> depth), `trd_units`
    marks the CUs whose transform splits one level further."""
    H, W = rec_y.shape
    bs_v, bs_h = dbk.intra_bs_from_depth_units(depth_units, trd_u=trd_units)
    qp_map = _qp_tensor(qp, rec_y.device).expand(H // 4, W // 4)
    fy, fu, fv = dbk.deblock_frame(rec_y.to(I32), rec_u.to(I32),
                                   rec_v.to(I32), bs_v=bs_v, bs_h=bs_h,
                                   qp_map=qp_map)
    u8 = torch.uint8
    return fy.to(u8), fu.to(u8), fv.to(u8)
