"""All-intra (IDR) frame pipeline, CU = TU = B, no split RDO.

Port of the non-split path of homerhevc_tpu/pipeline/intra_jax.py
(`encode_frame_intra` with split_rdo=False, rd_mode FULL). The reference's
`lax.fori_loop` over block anti-diagonals (skew 2, the WPP dependency
pattern) becomes a Python loop; every block on a diagonal is processed in
one batch, and each luma block evaluates all 35 modes closed-loop as one
batched tensor op; chroma follows with the luma mode. Predictions come from
reconstructed neighbours, so levels and recon are what a conformant decoder
reproduces. Exact int32, equal to the reference output for output.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tables
from ..device import I32, const, first_argmin
from ..ops import intra as intra_ops
from ..ops import quant as quant_ops
from ..ops import transforms as tx_ops
from .p_chunk import compact, to4
from .p_torch import _qp_tensor, to_plane


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
            lv_d, lv_h, lv_v = (quant_ops.sign_bit_hiding(
                levels, coeff, qp, log2, scan_idx=s) for s in (0, 1, 2))
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


def encode_block_all_modes(orig, top, left, corner, has_left, has_top, *,
                           size, c_idx, qp, lam_fx, strong_smoothing,
                           sign_hiding=False):
    """All-35-mode closed-loop encode of N blocks: (levels, recon) (N, 35,
    n, n) and cost (N, 35) = SSD + lambda * bit estimate."""
    refs = intra_ops.prepare_refs(top, left, corner, has_left, has_top,
                                  size=size, c_idx=c_idx,
                                  strong_smoothing=strong_smoothing)
    preds = intra_ops.predict_all_modes(*refs, size=size, c_idx=c_idx)
    modes = torch.arange(35, device=orig.device)[None]
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


def _refs_for(bot, right, rs, x0, n: int, w: int):
    """Neighbour samples of the lanes' blocks: top row from the CTU row
    above (top-right replicates at the picture edge), left column from the
    left block (below-left replicates its last sample), corner."""
    rm1 = (rs - 1).clamp(min=0)
    trow = bot[rm1]                                          # (N, w)
    ar = torch.arange(2 * n, device=bot.device)
    top = torch.gather(trow, 1, (x0[:, None] + ar).clamp(0, w - 1))
    lcol = right[rs]                                         # (N, n)
    left = torch.cat([lcol, lcol[:, n - 1:n].expand(-1, n)], dim=1)
    corner = torch.gather(trow, 1, (x0 - 1).clamp(0, w - 1)[:, None])[:, 0]
    return top, left, corner


def encode_frame_intra(y_pad, u_pad, v_pad, *, B: int, qp,
                       strong_smoothing: bool = True,
                       sign_hiding: bool = False):
    """Encode one padded frame all-intra with CU = TU = B (the
    FASTEST_COMPUTATION IDR: no split RDO, rd_mode FULL). Returns the
    reference's output dict: modes, unit maps, block levels, uint8 recon
    planes and the compact wire."""
    H, W = y_pad.shape
    dev = y_pad.device
    nby, nbx = H // B, W // B
    B2 = B // 2
    qp = _qp_tensor(qp, dev)
    qp_c = tables.chroma_qp_t(qp)
    lam_t = const(tables.LAMBDA_FX, dev)
    lam, lam_c = lam_t[qp], lam_t[qp_c]

    def blocks(p, s):
        return (p.to(I32).reshape(nby, s, nbx, s).permute(0, 2, 1, 3))

    orig_y, orig_u, orig_v = blocks(y_pad, B), blocks(u_pad, B2), \
        blocks(v_pad, B2)

    def z(*shape):
        return torch.zeros(shape, dtype=I32, device=dev)

    bot = {"y": z(nby, W), "u": z(nby, W // 2), "v": z(nby, W // 2)}
    right = {"y": z(nby, B), "u": z(nby, B2), "v": z(nby, B2)}
    mode_b = z(nby, nbx)
    lev = {"y": z(nby, nbx, B, B), "u": z(nby, nbx, B2, B2),
           "v": z(nby, nbx, B2, B2)}
    rec = {k: torch.zeros_like(t) for k, t in lev.items()}

    for d in range(nbx + 2 * (nby - 1)):
        # lanes: block rows r with 0 <= c = d - 2r < nbx
        r_lo = max(0, (d - nbx + 2) // 2)
        r_hi = min(nby - 1, d // 2)
        rs = torch.arange(r_lo, r_hi + 1, device=dev)
        cs = d - 2 * rs
        has_top = rs > 0
        has_left = cs > 0

        x0 = cs * B
        top, left, corner = _refs_for(bot["y"], right["y"], rs, x0, B, W)
        lv35, rc35, cost = encode_block_all_modes(
            orig_y[rs, cs], top, left, corner, has_left, has_top, size=B,
            c_idx=0, qp=qp, lam_fx=lam, strong_smoothing=strong_smoothing,
            sign_hiding=sign_hiding)
        mi = first_argmin(cost, 1)
        lanes = torch.arange(rs.shape[0], device=dev)
        out = {"y": (lv35[lanes, mi], rc35[lanes, mi])}

        cx0 = cs * B2
        for key, plane_o, c_idx in (("u", orig_u, 1), ("v", orig_v, 2)):
            t, lft, co = _refs_for(bot[key], right[key], rs, cx0, B2,
                                   W // 2)
            out[key] = encode_block_one_mode(
                plane_o[rs, cs], t, lft, co, has_left, has_top, mi, size=B2,
                c_idx=c_idx, qp=qp_c, strong_smoothing=False,
                sign_hiding=sign_hiding)

        mode_b[rs, cs] = mi.to(I32)
        for key, n, xs in (("y", B, x0), ("u", B2, cx0), ("v", B2, cx0)):
            lv, rc = out[key]
            lev[key][rs, cs] = lv
            rec[key][rs, cs] = rc
            cols = xs[:, None] + torch.arange(n, device=dev)
            bot[key][rs[:, None], cols] = rc[:, -1, :]
            right[key][rs] = rc[:, :, -1]

    un = B // 4
    mode_units = mode_b.repeat_interleave(un, 0).repeat_interleave(un, 1)
    zeros_u = torch.zeros_like(mode_units)
    u8 = torch.uint8
    out = dict(
        modes=mode_b,
        mode_units=mode_units, depth_units=zeros_u, part_units=zeros_u,
        trd_units=zeros_u,
        lev_y=lev["y"], lev_u=lev["u"], lev_v=lev["v"],
        recon_y=to_plane(rec["y"]).to(u8),
        recon_u=to_plane(rec["u"]).to(u8),
        recon_v=to_plane(rec["v"]).to(u8),
    )
    out["wire"] = pack_intra_wire(
        to_plane(lev["y"]), to_plane(lev["u"]), to_plane(lev["v"]),
        mode_units, zeros_u, zeros_u, zeros_u)
    return out
