"""Sample Adaptive Offset (spec 7.3.8.3 syntax, 8.7.3 application).

Port of the device side of homerhevc_tpu/ops/sao.py: edge-index maps,
decoder-exact application, per-CTU statistics (exact integer reshape-sums
instead of the reference's one-hot f32 block sums), and a torch
`derive_all_from_stats` for the in-chunk path (int32, as the reference's
in-jit derivation). The IDR path derives on the host with the numpy
derivation of ops/sao_host.py (`sao_stage_device`), as the JAX package does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import tables
from ..device import const, first_argmin, take
from .sao_host import EO_NEIGHBORS, MAX_OFFSET
from .sao_host import derive_all_from_stats as derive_all_np

I32 = torch.int32


def edge_idx_map(rec: torch.Tensor, eo_class: int) -> torch.Tensor:
    """edgeIdx 0..4 per pixel (2 = no category); pixels whose neighbour
    falls outside the picture get 2."""
    H, W = rec.shape
    r = rec.to(I32)
    (dy0, dx0), (dy1, dx1) = EO_NEIGHBORS[eo_class]

    def shifted(dy, dx):
        return torch.roll(r, shifts=(-dy, -dx), dims=(0, 1))

    idx = (2 + torch.sign(r - shifted(dy0, dx0))
           + torch.sign(r - shifted(dy1, dx1))).to(I32)
    ys = torch.arange(H, device=rec.device)[:, None]
    xs = torch.arange(W, device=rec.device)[None, :]
    valid = torch.ones((H, W), dtype=torch.bool, device=rec.device)
    for dy, dx in ((dy0, dx0), (dy1, dx1)):
        if dy:
            valid = valid & (ys + dy >= 0) & (ys + dy < H)
        if dx:
            valid = valid & (xs + dx >= 0) & (xs + dx < W)
    return torch.where(valid, idx, 2)


def _halo_core(rec: torch.Tensor, halo):
    """(int32 plane with `halo` = (rows above, rows below) of neighbouring
    bands, its own rows)."""
    r_ext = rec.to(I32)
    return r_ext, r_ext[halo[0]:r_ext.shape[0] - halo[1]]


def _edge_idx(r_ext, eo_class: int, halo):
    """edge_idx_map of a band's own rows, its neighbours' rows `halo`
    around it (the picture's edge where there are none)."""
    return edge_idx_map(r_ext, eo_class)[halo[0]:r_ext.shape[0] - halo[1]]


def apply_sao(rec: torch.Tensor, params: dict, ctu: int,
              halo=(0, 0)) -> torch.Tensor:
    """Decoder-exact SAO application for one component plane (int32). For a
    band of CTU rows, `rec` holds `halo` = (1, 1) rows of the neighbouring
    bands above and below (0 at the picture's edge), what the edge offsets
    of its first and last rows read, and the result is the band's rows."""
    r_ext, r = _halo_core(rec, halo)

    def up(a):
        a = torch.as_tensor(a, device=rec.device).to(I32)
        return a.repeat_interleave(ctu, 0).repeat_interleave(ctu, 1)

    typ_px = up(params["type"])
    cls_px = up(params["eo_class"])
    pos_px = up(params["band_pos"])
    offsets = torch.as_tensor(params["offsets"], device=rec.device)
    off_px = [up(offsets[..., i]) for i in range(4)]

    rel = (r >> 3) - pos_px
    bo_off = torch.zeros_like(r)
    for i in range(4):
        bo_off = torch.where(rel == i, off_px[i], bo_off)
    bo_out = (r + bo_off).clamp(0, 255)

    eo_out = r
    for cls in range(4):
        idx = _edge_idx(r_ext, cls, halo)
        o = torch.zeros_like(r)
        for cat, ei in enumerate((0, 1, 3, 4)):
            o = torch.where(idx == ei, off_px[cat], o)
        eo_out = torch.where(cls_px == cls, (r + o).clamp(0, 255), eo_out)
    return torch.where(typ_px == 1, bo_out,
                       torch.where(typ_px == 2, eo_out, r))


def stats_one(orig: torch.Tensor, rec: torch.Tensor, ctu: int,
              halo=(0, 0)):
    """(ke, se, kb, sb) int32 per-CTU stat tensors for one component:
    EO counts/sums (4 classes x 4 categories) and BO counts/sums (32 bands)
    of orig - rec, each (.., nby, nbx). For a band, `rec` holds `halo` rows
    of the neighbours, as in apply_sao."""
    H, W = orig.shape
    dev = orig.device
    nby, nbx = H // ctu, W // ctu
    r_ext, r = _halo_core(rec, halo)
    diff = (orig.to(I32) - r).reshape(-1).to(torch.int64)
    ones = torch.ones_like(diff)
    cid = ((torch.arange(H, device=dev)[:, None] // ctu) * nbx
           + torch.arange(W, device=dev)[None, :] // ctu).reshape(-1)

    def per_ctu(cat, ncat):
        # exact integer per-(CTU, category) count and sum of orig - rec
        key = cid * ncat + cat.reshape(-1).to(torch.int64)
        z = torch.zeros(nby * nbx * ncat, dtype=torch.int64, device=dev)
        k = z.scatter_add(0, key, ones).reshape(nby, nbx, ncat)
        s = z.scatter_add(0, key, diff).reshape(nby, nbx, ncat)
        return k.permute(2, 0, 1).to(I32), s.permute(2, 0, 1).to(I32)

    ke, se = [], []
    for cls in range(4):
        k, s = per_ctu(_edge_idx(r_ext, cls, halo), 5)
        ke.append(torch.cat([k[0:2], k[3:5]]))     # edgeIdx 0, 1, 3, 4
        se.append(torch.cat([s[0:2], s[3:5]]))
    kb, sb = per_ctu(r >> 3, 32)
    return torch.stack(ke), torch.stack(se), kb, sb


# ---------------------------------------------------------------------------
# in-chunk derivation (torch twin of the reference's xp=jnp derivation)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _offset_candidates(sign_constraint: int):
    """Candidate offsets h (int32) and their bit costs |h| + 1."""
    hs = np.arange(-MAX_OFFSET, MAX_OFFSET + 1, dtype=np.int32)
    if sign_constraint > 0:
        hs = hs[hs >= 0]
    elif sign_constraint < 0:
        hs = hs[hs <= 0]
    return hs, np.abs(hs) + 1


def _best_offset(k, s, lam_fx, sign_constraint=0):
    hs, bits = (const(a, k.device)
                for a in _offset_candidates(sign_constraint))
    k_ = k[..., None].to(I32)
    s_ = s[..., None].to(I32)
    cost = (k_ * hs * hs - 2 * hs * s_ + ((lam_fx * bits) >> 8)).to(I32)
    j = first_argmin(cost, -1)
    return hs[j], torch.gather(cost, -1, j[..., None])[..., 0]


def _component_costs_from_stats(ke, se, kb, sb, lam_fx):
    nby, nbx = ke.shape[-2:]
    offs_cat = []
    cost_eo = None
    for cat in range(4):
        sign = 1 if cat < 2 else -1
        h, c = _best_offset(ke[:, cat], se[:, cat], lam_fx, sign)
        offs_cat.append(h)
        cost_eo = c if cost_eo is None else cost_eo + c
    offs = torch.stack(offs_cat, dim=1)                 # (4cls, 4cat, ..)
    hb, cb = _best_offset(kb, sb, lam_fx, 0)
    win_costs = torch.stack([cb[p:p + 4].sum(0) for p in range(29)]).to(I32)
    band_pos = first_argmin(win_costs, 0)
    bo_cost = win_costs.min(0).values
    bo_off = torch.stack([torch.gather(hb, 0, (band_pos + i)[None])[0]
                          for i in range(4)])
    return dict(cost_eo=cost_eo, eo_offs=offs, band_pos=band_pos,
                bo_cost=bo_cost, bo_off=bo_off,
                zero=torch.zeros((nby, nbx), dtype=I32, device=ke.device))


def _pack(typ, cls, band_pos, bo_off, eo_offs):
    idx = cls[None, None].expand(1, eo_offs.shape[1], -1, -1)
    eo_off = torch.gather(eo_offs, 0, idx)[0]
    offsets = torch.where(typ[None] == 1, bo_off,
                          torch.where(typ[None] == 2, eo_off, 0))
    i8 = torch.int8
    return dict(type=typ.to(i8), eo_class=cls.to(i8),
                band_pos=band_pos.to(i8),
                offsets=offsets.permute(1, 2, 0).to(i8))


def _shift_params(par, direction):
    ax = 1 if direction == "left" else 0
    return {k: torch.roll(v, 1, dims=ax) for k, v in par.items()}


def _shift_bool(m, direction):
    out = torch.zeros_like(m)
    if direction == "left":
        out[:, 1:] = m[:, :-1]
    else:
        out[1:, :] = m[:-1, :]
    return out


def _eval_params_cost(stats, par):
    ke, se, kb, sb = (t.to(I32) for t in stats)
    typ = par["type"].to(I32)
    cls = par["eo_class"].to(torch.int64)
    bp = par["band_pos"].to(I32)
    off = par["offsets"].to(I32)                           # (nby, nbx, 4)
    idx = cls[None, None].expand(1, 4, -1, -1)
    ke_g = torch.gather(ke, 0, idx)[0]                     # (4cat, ..)
    se_g = torch.gather(se, 0, idx)[0]
    d_eo = torch.zeros_like(typ)
    for cat in range(4):
        h = off[..., cat]
        d_eo = d_eo + ke_g[cat] * h * h - 2 * h * se_g[cat]
    d_bo = torch.zeros_like(typ)
    for i in range(4):
        bi = (bp + i).clamp(0, 31).to(torch.int64)[None]
        h = off[..., i]
        d_bo = (d_bo + torch.gather(kb, 0, bi)[0] * h * h
                - 2 * h * torch.gather(sb, 0, bi)[0])
    return torch.where(typ == 2, d_eo, torch.where(typ == 1, d_bo, 0))


def derive_all_from_stats(st_y, st_cb, st_cr, qp, qp_c, slice_p=False):
    """Full SAO parameter derivation on the device, qp / qp_c as 0-d
    tensors (no host sync). Returns (luma, cb, cr, merge_left, merge_up)
    exactly as the reference's derivation."""
    dev = st_y[0].device
    fx = const(tables.LAMBDA_FX_P if slice_p else tables.LAMBDA_FX, dev)
    lam_y = take(fx, torch.clamp(qp, max=51))
    lam_c = take(fx, torch.clamp(qp_c, max=51))
    ccy = _component_costs_from_stats(*st_y, lam_y)
    ccb = _component_costs_from_stats(*st_cb, lam_c)
    ccr = _component_costs_from_stats(*st_cr, lam_c)

    cost_eo = ccy["cost_eo"] + ((lam_y * 14) >> 8)
    cls = first_argmin(cost_eo, 0)
    eo_cost = torch.gather(cost_eo, 0, cls[None])[0]
    bo_cost = ccy["bo_cost"] + ((lam_y * 22) >> 8)
    off_cost = ccy["zero"] + ((lam_y * 2) >> 8)
    typ = first_argmin(torch.stack([off_cost, bo_cost, eo_cost]), 0)
    luma = _pack(typ, cls, ccy["band_pos"], ccy["bo_off"], ccy["eo_offs"])

    cost_eo_c = ccb["cost_eo"] + ccr["cost_eo"] + ((lam_c * 14) >> 8)
    cls_c = first_argmin(cost_eo_c, 0)
    bo_cost_c = ccb["bo_cost"] + ccr["bo_cost"] + ((lam_c * 28) >> 8)
    off_cost_c = ccb["zero"] + ((lam_c * 2) >> 8)
    eo_cost_c = torch.gather(cost_eo_c, 0, cls_c[None])[0]
    typ_c = first_argmin(torch.stack([off_cost_c, bo_cost_c, eo_cost_c]), 0)
    cbp = _pack(typ_c, cls_c, ccb["band_pos"], ccb["bo_off"], ccb["eo_offs"])
    crp = _pack(typ_c, cls_c, ccr["band_pos"], ccr["bo_off"], ccr["eo_offs"])

    new_cost = (torch.minimum(torch.minimum(off_cost, bo_cost), eo_cost)
                + torch.minimum(torch.minimum(off_cost_c, bo_cost_c),
                                eo_cost_c))

    def merged_cost(shift):
        d = (_eval_params_cost(st_y, _shift_params(luma, shift))
             + _eval_params_cost(st_cb, _shift_params(cbp, shift))
             + _eval_params_cost(st_cr, _shift_params(crp, shift)))
        bits = 2 if shift == "left" else 3
        return d + ((lam_y * bits) >> 8)

    nby, nbx = new_cost.shape
    idx_x = torch.arange(nbx, device=dev)[None, :]
    idx_y = torch.arange(nby, device=dev)[:, None]
    candL = (merged_cost("left") < new_cost) & (idx_x > 0)
    candU = (merged_cost("up") < new_cost) & (idx_y > 0)
    # length-1 merge chains (see the reference): up-merges first, then left
    # candidate runs alternate from each run start
    src_pure = ~(candL | candU)
    accU = candU & ~candL & _shift_bool(src_pure, "up")
    runs = candL & ~_shift_bool(candL, "left")
    blocked = _shift_bool(accU, "left")
    pos = torch.broadcast_to(idx_x, candL.shape).to(I32)
    seed = torch.where(runs, pos + blocked.to(I32), -1)
    anchor = torch.cummax(seed, dim=1).values
    accL = candL & (((pos - anchor) % 2) == 0)

    def apply_merge(par):
        out = {}
        pl = _shift_params(par, "left")
        pu = _shift_params(par, "up")
        for k in par:
            sel = accL if par[k].dim() == 2 else accL[..., None]
            selu = accU if par[k].dim() == 2 else accU[..., None]
            out[k] = torch.where(sel, pl[k], torch.where(selu, pu[k],
                                                         par[k]))
        return out

    return (apply_merge(luma), apply_merge(cbp), apply_merge(crp),
            accL, accU)


def sao_stage_device(orig_planes, dbk_planes, ctu: int, qp: int, qp_c: int,
                     slice_p: bool = False):
    """Device stats -> host numpy derivation (the reference's own) -> device
    application; one device-to-host copy of the stat tensors, as the JAX
    package does. Returns (sao_info, filtered uint8 planes)."""
    oy, ou, ov = orig_planes
    ry, ru, rv = dbk_planes
    info = derive_on_host(stats_one(oy, ry, ctu) + stats_one(ou, ru, ctu // 2)
                          + stats_one(ov, rv, ctu // 2), qp, qp_c,
                          slice_p=slice_p)
    filt = tuple(apply_sao(r, p, c).to(torch.uint8)
                 for r, p, c in ((ry, info["luma"], ctu),
                                 (ru, info["cb"], ctu // 2),
                                 (rv, info["cr"], ctu // 2)))
    return info, filt


def derive_on_host(parts, qp: int, qp_c: int, slice_p: bool = False) -> dict:
    """The SAO parameters (the session's sao_info) from the twelve per-CTU
    stat tensors of Y, Cb and Cr (stats_one's, in that order), derived on
    the host by the reference's numpy derivation after one copy."""
    nby, nbx = parts[0].shape[-2:]
    flat = torch.cat([t.reshape(-1, nby, nbx) for t in parts]).cpu().numpy()
    st = []
    o = 0
    for _ in range(3):
        st.append(flat[o:o + 16].reshape(4, 4, nby, nbx)); o += 16
        st.append(flat[o:o + 16].reshape(4, 4, nby, nbx)); o += 16
        st.append(flat[o:o + 32]); o += 32
        st.append(flat[o:o + 32]); o += 32
    luma, cbp, crp, ml, mu = derive_all_np(
        tuple(st[0:4]), tuple(st[4:8]), tuple(st[8:12]), qp, qp_c,
        slice_p=slice_p)
    return dict(luma=luma, cb=cbp, cr=crp, merge_left=ml, merge_up=mu,
                sao_luma=True, sao_chroma=True)
