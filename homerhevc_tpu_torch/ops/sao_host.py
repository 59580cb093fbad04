"""Host (numpy) SAO parameter derivation from per-CTU statistics.

The port's own copy of `derive_all_from_stats` and what it calls from
homerhevc_tpu/ops/sao.py, numpy only (int64). The per-frame path
(ops/sao.py `sao_stage_device`) fetches the device statistics once and
derives here, as the reference does; the chunked path derives on the device
with the torch twin in ops/sao.py. Both give the reference's parameters.
"""

from __future__ import annotations

import numpy as np

from .. import tables

# EO neighbor offsets per class (hPos/vPos, spec Table 8-16).
EO_NEIGHBORS = {
    0: ((0, -1), (0, 1)),        # horizontal
    1: ((-1, 0), (1, 0)),        # vertical
    2: ((-1, -1), (1, 1)),       # 135 degrees
    3: ((-1, 1), (1, -1)),       # 45 degrees
}

MAX_OFFSET = 7                   # (1 << (Min(bitDepth,10)-5)) - 1 for 8-bit


def _best_offset(k, s, lam_fx, sign_constraint=0):
    """Vectorized best offset per (.., nby, nbx) stat cell.

    Minimises D(h) = k h^2 - 2 h s plus lam * bits(|h|); sign_constraint:
    +1 -> h >= 0, -1 -> h <= 0, 0 -> free. Returns (h, cost_delta).
    int64 here; the device twin (ops/sao.py) runs the identical integer
    math in int32 (every term < 2**24, so the narrower dtype cannot change
    the argmin)."""
    hs_np = np.arange(-MAX_OFFSET, MAX_OFFSET + 1)
    if sign_constraint > 0:
        hs_np = hs_np[hs_np >= 0]
    elif sign_constraint < 0:
        hs_np = hs_np[hs_np <= 0]
    acc = np.int64
    hs = np.asarray(hs_np)
    # shape (H..., len(hs))
    k_ = k[..., None].astype(acc)
    s_ = s[..., None].astype(acc)
    bits = np.asarray(np.abs(hs_np) + 1)
    cost = k_ * hs * hs - 2 * hs * s_ + ((lam_fx * bits) >> 8)
    j = np.argmin(cost, axis=-1)
    h = hs[j]
    c = np.take_along_axis(cost, j[..., None], axis=-1)[..., 0]
    return h.astype(np.int32), c


def _pack(typ, cls, band_pos, bo_off, eo_offs):
    eo_off = np.take_along_axis(eo_offs, cls[None, None], axis=0)[0]
    offsets = np.where(typ[None] == 1, bo_off,
                       np.where(typ[None] == 2, eo_off, 0))
    dt = np.int8
    return dict(type=typ.astype(dt), eo_class=cls.astype(dt),
                band_pos=band_pos.astype(dt),
                offsets=offsets.transpose(1, 2, 0).astype(dt))


def _shift_params(par, direction):
    """Neighbor's params aligned to each CTU (edge values are junk — the
    candidate masks exclude the first row/column)."""
    ax = 1 if direction == "left" else 0
    return {k: np.roll(v, 1, axis=ax) for k, v in par.items()}


def _shift_bool(m, direction):
    if direction == "left":
        return np.pad(m[:, :-1], ((0, 0), (1, 0)), mode="constant",
                      constant_values=False)
    return np.pad(m[:-1, :], ((1, 0), (0, 0)), mode="constant",
                  constant_values=False)


def _eval_params_cost(stats, par):
    """Closed-form SAO distortion delta of applying `par` to a CTU's stat
    moments: sum over active offsets of k*h^2 - 2*h*s (negative = better
    than no SAO). Off CTUs cost 0."""
    ke, se, kb, sb = stats
    acc = np.int64
    ke = np.asarray(ke).astype(acc)
    se = np.asarray(se).astype(acc)
    kb = np.asarray(kb).astype(acc)
    sb = np.asarray(sb).astype(acc)
    typ = par["type"].astype(np.int32)
    cls = par["eo_class"].astype(np.int32)
    bp = par["band_pos"].astype(np.int32)
    off = par["offsets"].astype(acc)                # (nby, nbx, 4)
    ke_g = np.take_along_axis(ke, cls[None, None], axis=0)[0]   # (4cat, ..)
    se_g = np.take_along_axis(se, cls[None, None], axis=0)[0]
    d_eo = np.zeros_like(typ).astype(acc)
    for cat in range(4):
        h = off[..., cat]
        d_eo = d_eo + ke_g[cat] * h * h - 2 * h * se_g[cat]
    d_bo = np.zeros_like(typ).astype(acc)
    for i in range(4):
        idx = np.clip(bp + i, 0, 31)
        kb_g = np.take_along_axis(kb, idx[None], axis=0)[0]
        sb_g = np.take_along_axis(sb, idx[None], axis=0)[0]
        h = off[..., i]
        d_bo = d_bo + kb_g * h * h - 2 * h * sb_g
    return np.where(typ == 2, d_eo, np.where(typ == 1, d_bo, 0))


def _component_costs_from_stats(ke, se, kb, sb, lam_fx: int):
    """Per-CTU costs/offsets for one component from its stat tensors (tiny
    (4,4,nby,nbx)/(32,nby,nbx) arrays): EO per class, BO, off."""
    acc = np.int64
    ke = np.asarray(ke).astype(acc)
    se = np.asarray(se).astype(acc)
    kb = np.asarray(kb).astype(acc)
    sb = np.asarray(sb).astype(acc)
    nby, nbx = ke.shape[-2:]
    offs_cat = []
    cost_eo = None
    for cat in range(4):
        sign = 1 if cat < 2 else -1
        h, c = _best_offset(ke[:, cat], se[:, cat], lam_fx, sign)
        offs_cat.append(h)
        cost_eo = c if cost_eo is None else cost_eo + c
    offs = np.stack(offs_cat, axis=1)                 # (4cls, 4cat, nby, nbx)
    hb, cb = _best_offset(kb, sb, lam_fx, 0)
    win_costs = np.stack([cb[p:p + 4].sum(axis=0) for p in range(29)])
    band_pos = np.argmin(win_costs, axis=0)
    bo_cost = np.min(win_costs, axis=0)
    bo_off = np.stack([np.take_along_axis(hb, (band_pos + i)[None], 0)[0]
                       for i in range(4)])
    return dict(cost_eo=cost_eo, eo_offs=offs, band_pos=band_pos,
                bo_cost=bo_cost, bo_off=bo_off,
                zero=np.zeros((nby, nbx), acc))


def derive_all_from_stats(st_y, st_cb, st_cr, qp: int, qp_c: int,
                          slice_p: bool = False):
    """Full SAO parameter derivation from per-CTU stat tensors for all three
    components (luma independent; chroma type/EO-class shared, spec 7.3.8.3)
    + equality-based merge flags, on the host over fetched stats. Returns
    (luma, cb, cr, merge_left, merge_up).

    slice_p selects the P-slice RD lambda (the reference prices SAO with
    the slice lambda, hmr_tables.c:372 sao_lambdas[0] = lambda — using the
    I-slice table on P frames underpriced offsets ~2x and SAO grew to ~20%
    of P bits)."""
    fx = tables.LAMBDA_FX_P if slice_p else tables.LAMBDA_FX
    lam_y = int(fx[min(qp, 51)])
    lam_c = int(fx[min(qp_c, 51)])
    ccy = _component_costs_from_stats(*st_y, lam_y)
    ccb = _component_costs_from_stats(*st_cb, lam_c)
    ccr = _component_costs_from_stats(*st_cr, lam_c)

    # Bit-cost estimates calibrated against measured CABAC output on the
    # synthetic 720p RD clip (sweep 2026-08: eo=14/bo=22/off=2 saved ~350B
    # per P frame for -0.04dB vs the old 6/10/1 optimistic estimates).
    cost_eo = ccy["cost_eo"] + ((lam_y * 14) >> 8)
    cls = np.argmin(cost_eo, axis=0)
    eo_cost = np.take_along_axis(cost_eo, cls[None], axis=0)[0]
    bo_cost = ccy["bo_cost"] + ((lam_y * 22) >> 8)
    off_cost = ccy["zero"] + ((lam_y * 2) >> 8)
    typ = np.argmin(np.stack([off_cost, bo_cost, eo_cost]), axis=0)
    luma = _pack(typ, cls, ccy["band_pos"], ccy["bo_off"], ccy["eo_offs"])

    cost_eo_c = ccb["cost_eo"] + ccr["cost_eo"] + ((lam_c * 14) >> 8)
    cls_c = np.argmin(cost_eo_c, axis=0)
    bo_cost_c = ccb["bo_cost"] + ccr["bo_cost"] + ((lam_c * 28) >> 8)
    off_cost_c = ccb["zero"] + ((lam_c * 2) >> 8)
    eo_cost_c = np.take_along_axis(cost_eo_c, cls_c[None], axis=0)[0]
    typ_c = np.argmin(np.stack([off_cost_c, bo_cost_c, eo_cost_c]), axis=0)
    cbp = _pack(typ_c, cls_c, ccb["band_pos"], ccb["bo_off"], ccb["eo_offs"])
    crp = _pack(typ_c, cls_c, ccr["band_pos"], ccr["bo_off"], ccr["eo_offs"])

    # ---- merge-left/up RDO (role of hmr_sao.c:663/:854/:1295) ----
    # cost of coding NEW params for this CTU (all components, lambda-R in)
    new_cost = (np.minimum(np.minimum(off_cost, bo_cost), eo_cost)
                + np.minimum(np.minimum(off_cost_c, bo_cost_c), eo_cost_c))

    def merged_cost(shift):
        """Cost of copying the neighbor's (pre-merge) params: closed-form
        distortion of applying them to THIS CTU's stats + 1-2 flag bits."""
        d = (_eval_params_cost(st_y, _shift_params(luma, shift))
             + _eval_params_cost(st_cb, _shift_params(cbp, shift))
             + _eval_params_cost(st_cr, _shift_params(crp, shift)))
        bits = 2 if shift == "left" else 3
        return d + ((lam_y * bits) >> 8)

    nby, nbx = new_cost.shape
    idx_x = np.arange(nbx)[None, :]
    idx_y = np.arange(nby)[:, None]
    costL = merged_cost("left")
    costU = merged_cost("up")
    candL = (costL < new_cost) & (idx_x > 0)
    candU = (costU < new_cost) & (idx_y > 0)
    # length-1 chains only: a merge SOURCE must keep its new params, so the
    # decoder's copied params equal the ones this RDO evaluated. Left runs
    # alternate (accept even positions within each candidate run); up
    # accepts only from neighbors that are no candidates at all.
    # acceptance must guarantee every merge SOURCE kept its NEW params
    # (length-1 chains), or the decoder's copy would diverge from the
    # params this RDO evaluated/applied. Up-merges are decided first
    # (acyclic: only non-left-candidates, from a source that is no
    # candidate at all — accU positions are never candL). Left candidate
    # runs then alternate from each run start; a run whose start sits
    # right of an up-merged CTU starts one position later (that source's
    # final params are not its new ones).
    src_pure = ~(candL | candU)
    accU = candU & ~candL & _shift_bool(src_pure, "up")
    runs = candL & ~_shift_bool(candL, "left")
    blocked = _shift_bool(accU, "left")
    pos = np.broadcast_to(idx_x, candL.shape).astype(np.int32)
    seed = np.where(runs, pos + blocked.astype(np.int32), -1)
    anchor = np.maximum.accumulate(seed, axis=1)
    accL = candL & (((pos - anchor) % 2) == 0)

    def apply_merge(par):
        out = {}
        pl = _shift_params(par, "left")
        pu = _shift_params(par, "up")
        for k in par:
            sel = accL if par[k].ndim == 2 else accL[..., None]
            selu = accU if par[k].ndim == 2 else accU[..., None]
            out[k] = np.where(sel, pl[k], np.where(selu, pu[k], par[k]))
        return out

    return (apply_merge(luma), apply_merge(cbp), apply_merge(crp),
            accL, accU)
