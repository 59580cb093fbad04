"""P-frame pipeline, fixed CU = B grid: frame-batched integer ME, quarter-pel
refinement, merge/skip RD, MC and residual coding.

Port of the non-tree path of homerhevc_tpu/pipeline/p_jax.py (`_p_stage`
dense branch, `_level_encode` without the TU split or row QPs,
`_p_stage_tail`, `p_frame_device`, `deblock_intra_device`). Inter
prediction reads only the previous decoded frame, so every block is
independent and the whole frame runs as batched tensor ops with the block
axis first: (nb, ...). Two steps go through hand-written CUDA kernels on
the card: the integer SAD sweep (ops/me.py) and the per-block window
gathers (ops/gather.py). All arithmetic is exact int32, equal to the
reference output for output.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import tables
from ..device import I32, const, edge_pad
from ..ops import deblock as dbk
from ..ops import interp
from ..ops import quant as quant_ops
from ..ops import transforms as tx_ops
from ..ops.gather import gather_windows
from ..ops.me import integer_me

# Edge padding of the reference planes: the largest search range of the
# reference's hierarchical ME (64) + the 8-tap filter support (as
# homerhevc_tpu/pipeline/p_golden.py).
PAD = 72

# Search ranges above this take the reference's hierarchical ME, which is
# not ported; at or below it the dense full-window sweep runs.
HIER_THRESHOLD = 24

# Merge-signalling bit proxies (merge_flag + unary idx), as the reference.
MB_LEFT, MB_TOP, MB_ZERO = 3, 4, 5


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
             kernels: bool = True):
    """Core frame-batched P stage over PAD-pre-padded int16 reference
    planes (dense integer search, the reference's `_p_stage`)."""
    if search > HIER_THRESHOLD:
        raise NotImplementedError(
            f"me_search_range={search} > {HIER_THRESHOLD} (hierarchical ME)")
    dev = y_pad.device
    qp = _qp_tensor(qp, dev)
    qp_c = tables.chroma_qp_t(qp)
    lam = const(tables.LAMBDA_ME_FX_P, dev)[qp]
    cur = y_pad.to(I32)
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
                         kernels=kernels)


def _level_encode(cur, u_pad, v_pad, ry, ru, rv, ivy, ivx, *, S, qp, qp_c,
                  lam, search, me_precision, sign_hiding,
                  kernels: bool = True):
    """Subpel refinement + merge/skip RD + MC + residual coding for every
    S-sized block (S <= 32). Returns per-block levels / recon and MVs."""
    H, W = cur.shape
    nby, nbx = H // S, W // S
    nb = nby * nbx
    S2 = S // 2
    G = S + 2                                  # qpel grid spatial extent
    log2 = S.bit_length() - 1
    if log2 > 5:
        raise NotImplementedError(f"CU size {S} > 32 (implicit TU split)")
    dev = cur.device
    bits_q = const(_bits_tab(4 * search + 16), dev)
    lam_full_t = const(tables.LAMBDA_FX_P, dev)

    bi = torch.arange(nb, device=dev, dtype=I32)
    r = bi // nbx
    c = bi % nbx
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
    cands = [(shifted(mvxg, 0, -1), shifted(mvyg, 0, -1), c > 0, MB_LEFT),
             (shifted(mvxg, -1, 0), shifted(mvyg, -1, 0), r > 0, MB_TOP),
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

    # ---- residual coding on (nb, n, n) batches ----
    def rd_zero(orig, pred, lev, rec, qpq):
        # skip-vs-code RD: drop the residual when prediction alone costs
        # less in D + lambda*R
        lamf = lam_full_t[qpq]
        ssd_c = ((orig - rec) * (orig - rec)).sum(dim=(-1, -2))
        ssd_s = ((orig - pred) * (orig - pred)).sum(dim=(-1, -2))
        bits = torch.clamp(tables.level_bits_est_t(lev), max=16383)
        keep = (ssd_c + (((lamf >> 4) * bits) >> 4) < ssd_s)[:, None, None]
        return torch.where(keep, lev, 0), torch.where(keep, rec, pred)

    def code(orig, pred, qpq, lg2):
        coeff = tx_ops.forward_transform(orig - pred)
        lev = quant_ops.quantize(coeff, qpq, lg2, is_intra=False)
        if sign_hiding:
            lev = quant_ops.sign_bit_hiding(lev, coeff, qpq, lg2)
        rr = tx_ops.inverse_transform(quant_ops.dequantize(lev, qpq, lg2))
        any_nz = (lev != 0).any(dim=-1).any(dim=-1)
        rr = torch.where(any_nz[:, None, None], rr, 0)
        rec = (pred + rr).clamp(0, 255)
        return rd_zero(orig, pred, lev, rec, qpq)

    lev_y, rec_y = code(blk, pred_y, qp, log2)
    lev_u, rec_u = code(blk_u, pred_u, qp_c, log2 - 1)
    lev_v, rec_v = code(blk_v, pred_v, qp_c, log2 - 1)

    out = {k: t.reshape(nby, nbx, S, S)
           for k, t in (("lev_y", lev_y), ("rec_y", rec_y))}
    out.update({k: t.reshape(nby, nbx, S2, S2)
                for k, t in (("lev_u", lev_u), ("lev_v", lev_v),
                             ("rec_u", rec_u), ("rec_v", rec_v))})
    out["mvx"] = mvx.reshape(nby, nbx)
    out["mvy"] = mvy.reshape(nby, nbx)
    return out


def _p_stage_tail(cur, u_pad, v_pad, ry, ru, rv, ivy, ivx, best_cost, *,
                  B, qp, qp_c, lam, search, me_precision, sign_hiding,
                  kernels=True):
    """Subpel refinement + MC + residual coding behind the integer search
    (fixed CU = B grid), and the one-buffer host wire of a P frame."""
    e = _level_encode(cur, u_pad, v_pad, ry, ru, rv, ivy, ivx, S=B, qp=qp,
                      qp_c=qp_c, lam=lam, search=search,
                      me_precision=me_precision, sign_hiding=sign_hiding,
                      kernels=kernels)
    mvs = torch.stack([e["mvx"], e["mvy"]], -1).to(I32)
    ly16 = e["lev_y"].to(torch.int16)
    lu16 = e["lev_u"].to(torch.int16)
    lv16 = e["lev_v"].to(torch.int16)
    best_cost = best_cost.to(I32)
    meta = torch.cat([mvs.reshape(-1), best_cost.reshape(-1)])
    u8 = torch.uint8
    return dict(
        mvs=mvs,
        sad=best_cost,            # best integer ME cost (scene-cut signal)
        lev_y=ly16, lev_u=lu16, lev_v=lv16,
        # one buffer for everything the host needs per P frame: levels,
        # then the int32 MVs and costs bitcast to int16 pairs
        wire=torch.cat([ly16.reshape(-1), lu16.reshape(-1), lv16.reshape(-1),
                        meta.view(torch.int16)]),
        recon_y=to_plane(e["rec_y"]).to(u8),
        recon_u=to_plane(e["rec_u"]).to(u8),
        recon_v=to_plane(e["rec_v"]).to(u8),
    )


def inter_deblock(rec, mvs, lev_y, qp, B: int):
    """Loop filter of a fixed-grid P frame: bS from MVs and luma cbf."""
    H, W = rec[0].shape
    cbf_blk = (lev_y != 0).any(dim=-1).any(dim=-1)
    bs_v, bs_h = dbk.inter_bs_from_blocks(mvs, cbf_blk, B)
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
    if deblock:
        rec = tuple(result[k].to(I32)
                    for k in ("recon_y", "recon_u", "recon_v"))
        fy, fu, fv = inter_deblock(rec, result["mvs"], result["lev_y"], qp, B)
        result["ref_y"] = fy.to(torch.uint8)
        result["ref_u"] = fu.to(torch.uint8)
        result["ref_v"] = fv.to(torch.uint8)
    return result


def deblock_intra_device(rec_y, rec_u, rec_v, *, qp, depth_units):
    """Deblocking of an all-intra frame; `depth_units` is the unit-granular
    CU depth map relative to 32-containers (TU = CU)."""
    H, W = rec_y.shape
    bs_v, bs_h = dbk.intra_bs_from_depth_units(depth_units)
    qp_map = _qp_tensor(qp, rec_y.device).expand(H // 4, W // 4)
    fy, fu, fv = dbk.deblock_frame(rec_y.to(I32), rec_u.to(I32),
                                   rec_v.to(I32), bs_v=bs_v, bs_h=bs_h,
                                   qp_map=qp_map)
    u8 = torch.uint8
    return fy.to(u8), fu.to(u8), fv.to(u8)
