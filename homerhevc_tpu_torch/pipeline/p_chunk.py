"""Chunked multi-frame P pipeline: K frames per dispatch, references kept
on the device.

Port of homerhevc_tpu/pipeline/p_chunk.py for the fixed-CU path
(`tree=False`) and the CU-quadtree path (`tree=True`, CTU 32 or 64, down to
8x8 CUs with `cu8`, per-CTU-row QPs with and without WPP), on one device or
in bands of CTU rows on a mesh.
The reference's `lax.scan` over K frames becomes a Python loop of
batched tensor ops whose carry — the deblocked, SAO-filtered reference
planes — never leaves the device. Each frame yields one compacted int32
wire row, word-identical to the reference's, so the host unpack below (a
copy of the reference's numpy helpers, whose module imports jax) reads it
unchanged: per-16-block (per-8-block with 8x8 CUs) decisions (CU depth, TU
split, intra flag, MV or intra mode), per-CTU SAD (scene-cut signal), packed
SAO parameters, and the nonzero 4x4 coefficient sub-blocks as int8 with an
int16 escape list, under a fixed capacity.

The fixed-capacity compaction (`jnp.nonzero(size=cap, fill_value=...)` in
the reference) is a cumulative sum and a binary search on the device: no
host sync, no scatter with colliding indices.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import tables
from ..device import I32, edge_pad
from ..ops import sao as sao_ops
from ..parallel import sharded
from . import p_torch
from .p_torch import PAD


# ---------------------------------------------------------------------------
# device side
# ---------------------------------------------------------------------------

def to4(plane: torch.Tensor) -> torch.Tensor:
    """(h, w) int -> (h*w/16, 16) int16 rows of 4x4 sub-blocks."""
    h, w = plane.shape
    return (plane.reshape(h // 4, 4, w // 4, 4).permute(0, 2, 1, 3)
            .reshape(-1, 16).to(torch.int16))


def compact(mask: torch.Tensor, cap: int) -> torch.Tensor:
    """Ascending indices of the True entries of a 1-D mask, the first `cap`
    of them, padded with len(mask): the k-th True entry is the first
    position whose running count reaches k. int64 (cap,)."""
    cs = torch.cumsum(mask.to(torch.int64), 0)
    want = torch.arange(1, cap + 1, device=mask.device, dtype=torch.int64)
    return torch.searchsorted(cs, want)


def pk_params(par, merge=None) -> torch.Tensor:
    """SAO param dict -> (nby, nbx) packed int32 word per CTU:
    type(2b) | eo_class(2b) | band_pos(5b) | 4 x (offset+7)(4b); bits 25/26
    carry merge_left/up when `merge` is given (luma word)."""
    w = (par["type"].to(I32) | (par["eo_class"].to(I32) << 2)
         | (par["band_pos"].to(I32) << 4))
    off = par["offsets"].to(I32) + 7
    for i in range(4):
        w = w | (off[..., i] << (9 + 4 * i))
    if merge is not None:
        ml, mu = merge
        w = w | (ml.to(I32) << 25) | (mu.to(I32) << 26)
    return w


def _sao_device(cur, rec, ctu: int, qp, qp_c):
    """In-loop SAO stage: stats -> derive (device, int32) -> apply. Returns
    (packed params (3, nby, nbx), filtered int32 planes)."""
    st = [sao_ops.stats_one(o, r, c)
          for o, r, c in zip(cur, rec, (ctu, ctu // 2, ctu // 2))]
    luma, cbp, crp, ml, mu = sao_ops.derive_all_from_stats(
        *st, qp, qp_c, slice_p=True)
    filt = tuple(sao_ops.apply_sao(r, p, c) for r, p, c in
                 zip(rec, (luma, cbp, crp), (ctu, ctu // 2, ctu // 2)))
    pp = torch.stack([pk_params(luma, merge=(ml, mu)), pk_params(cbp),
                      pk_params(crp)])
    return pp, filt


def _frame_wire(depth_u, trd_u, intra_u, mv_u, sad, pp, lev_planes,
                cap: int, fine: bool = False):
    """One frame's compacted wire row (int32) from the 4x4-unit decision
    maps (read at stride 4: one word per 16x16 block; with `fine`, at
    stride 2: one word per 8x8 block, for 8x8 inter CUs)."""
    L4 = sum(p.numel() for p in lev_planes) // 16
    lv4 = torch.cat([to4(p) for p in lev_planes])                # (L4, 16)
    nzm = (lv4 != 0).any(dim=1)
    cnt = nzm.sum().to(I32)
    idx = compact(nzm, cap)
    vals = lv4[idx.clamp(max=L4 - 1)]
    vals = torch.where((idx < L4)[:, None], vals, 0).to(torch.int16)
    vals8 = vals.clamp(-128, 127).to(torch.int8).view(torch.int32)  # (cap, 4)
    esc = (vals.to(I32).abs() > 127).any(dim=1)
    cap2 = max(64, cap // 8)
    cnt2 = esc.sum().to(I32)
    erow = compact(esc, cap2)
    evals = vals[erow.clamp(max=cap - 1)]
    evals = torch.where((erow < cap)[:, None], evals, 0).to(torch.int16)
    evals32 = evals.view(torch.int32)                             # (cap2, 8)
    # 16- (or 8-) granular decision grid: bits 0-1 depth, 2 TU split, 3
    # intra, then the two MV components (the intra mode rides the x slot)
    st = 2 if fine else 4
    mv16 = mv_u[::st, ::st].to(I32)
    dec16 = ((depth_u[::st, ::st] & 3) | ((trd_u[::st, ::st] & 1) << 2)
             | ((intra_u[::st, ::st] & 1) << 3)
             | ((mv16[..., 0] + 2048) << 4) | ((mv16[..., 1] + 2048) << 16))
    return torch.cat([
        cnt.reshape(1), cnt2.reshape(1), dec16.reshape(-1).to(I32),
        sad.reshape(-1).to(I32), pp.reshape(-1).to(I32), idx.to(I32),
        vals8.reshape(-1), erow.to(I32), evals32.reshape(-1)])


def fixed_frame(y, u, v, ref_y, ref_u, ref_v, qp, *, ctu: int, cap: int,
                deblock: bool, sao: bool, **stage):
    """One fixed-CU P frame on one device: the P stage against the uint8
    reference planes, its loop filter and its wire. `stage`: `_p_stage`'s
    search, me_precision, sign_hiding and kernels. Returns (wire row, dense
    level row, the filtered reference planes as uint8)."""
    H, W = y.shape
    dev = y.device
    padded = (edge_pad(ref_y.to(torch.int16), PAD),
              edge_pad(ref_u.to(torch.int16), PAD // 2),
              edge_pad(ref_v.to(torch.int16), PAD // 2))
    res = p_torch._p_stage(y, u, v, *padded, qp=qp, B=ctu, **stage)
    zeros = torch.zeros((H // 4, W // 4), dtype=I32, device=dev)
    mv_u = p_torch._upu(res["mvs"], ctu)
    lev = tuple(p_torch.to_plane(res[key])
                for key in ("lev_y", "lev_u", "lev_v"))
    rec = tuple(res[key].to(I32) for key in ("recon_y", "recon_u", "recon_v"))
    if deblock:
        rec = p_torch.inter_deblock(rec, res["mvs"], res["lev_y"], qp, ctu)
    if sao:
        qp_c = tables.chroma_qp_t(qp)
        # the reference filters the uint8 loop-filter output
        pp, rec = _sao_device((y.to(I32), u.to(I32), v.to(I32)), rec, ctu,
                              qp, qp_c)
    else:
        pp = torch.zeros((3, H // ctu, W // ctu), dtype=I32, device=dev)
    wire = _frame_wire(zeros, zeros, zeros, mv_u, res["sad"], pp, lev, cap)
    dense = torch.cat([p.to(torch.int16).reshape(-1) for p in lev])
    return (wire, dense, *(p.to(torch.uint8) for p in rec))


def _fixed_chunk(ys, us, vs, ref, qps, graphs, **kw):
    """The fixed-CU chunk on one device: `fixed_frame` per frame, called
    directly, or run through the session's `graphs`
    (pipeline/p_graph.py), whose output buffers the next replay
    overwrites: each frame's rows and the last reference planes are
    copied out of them."""
    step = functools.partial(fixed_frame, **kw)
    wires, denses = [], []
    for k in range(ys.shape[0]):
        args = (ys[k], us[k], vs[k], *ref, qps[k])
        if graphs is None:
            wire, dense, *ref = step(*args)
        else:
            wire, dense, *ref = graphs.run(step, args)
            wire, dense = wire.clone(), dense.clone()
        wires.append(wire)
        denses.append(dense)
    if graphs is not None:
        ref = [p.clone() for p in ref]
    return (torch.stack(wires), torch.stack(denses), *ref)


def p_chunk_device(ys, us, vs, ref_y, ref_u, ref_v, qps, *, ctu: int,
                   search: int, me_precision: int, sign_hiding: bool,
                   deblock: bool, sao: bool, cap: int, tree: bool = False,
                   tr_split: bool = False, intra_in_p: bool = False,
                   cu8: bool = False, qp_rows=None, wpp: bool = False,
                   vis=None, kernels: bool = True, mesh=None, graphs=None):
    """Encode K consecutive P frames on the device.

    ys (K, H, W) uint8 etc., ref_* uint8 planes, qps (K,) int32 on the
    device. `tree` selects the CU-quadtree stage (with `tr_split`,
    `intra_in_p`, 8x8 CUs `cu8`, the visible size `vis`, and with
    `qp_rows` (K, H // ctu) int32 one QP per CTU row of each frame, whose
    decoded-QP model follows `wpp`) over the fixed-CU one, which codes each
    frame at its QP in `qps`. With `mesh` (a list of devices) either stage
    and the loop filter run in bands on its devices (parallel/sharded.py),
    each band keeping its filtered reference rows from frame to frame; the
    wire is built on the planes' device, and the reference planes are
    joined there at the chunk's end. The fixed-CU stage on one device runs
    each frame through `graphs` (the session's p_graph.StepGraphs) where
    it is given. Returns
    (wires (K, L) int32, denses (K, D) int16 dense level planes for the
    capacity-overflow fallback, final reference planes)."""
    K, H, W = ys.shape
    dev = ys.device
    uh, uw = H // 4, W // 4
    ref = (ref_y, ref_u, ref_v)
    common = dict(search=search, me_precision=me_precision,
                  sign_hiding=sign_hiding, kernels=kernels)
    if not tree and mesh is None:
        return _fixed_chunk(ys, us, vs, ref, qps, graphs, ctu=ctu, cap=cap,
                            deblock=deblock, sao=sao, **common)
    if mesh is not None:
        rows, devs = sharded.band_rows(mesh, H, ctu)
        ref = sharded.cut_planes(ref, rows, devs)
    stage = dict(common, B=ctu)
    wires, denses = [], []
    for k in range(K):
        y, u, v, qp = ys[k], us[k], vs[k], qps[k]
        tree_kw = dict(common, ctu=ctu, tr_split=tr_split,
                       intra_in_p=intra_in_p, cu8=cu8,
                       qp_rows=None if qp_rows is None else qp_rows[k],
                       wpp=wpp, vis=vis)
        if mesh is None:
            padded = (edge_pad(ref[0].to(torch.int16), PAD),
                      edge_pad(ref[1].to(torch.int16), PAD // 2),
                      edge_pad(ref[2].to(torch.int16), PAD // 2))
            res = p_torch._p_stage_tree(y, u, v, *padded, qp=qp, **tree_kw)
        else:
            cur = sharded.cut_planes((y, u, v), rows, devs)
            outs = (sharded._band_stage_tree(cur, ref, qp, **tree_kw)
                    if tree else sharded._band_stage(cur, ref, qp, **stage))
            res = (sharded.join_tree(outs, dev) if tree
                   else sharded.join_fixed(outs, dev))
        if tree:
            depth_u, trd_u = res["depth_u"], res["trd_u"]
            intra_u, mv_u = res["pred_intra_u"], res["mv_u"]
            lev = (res["lev_y"], res["lev_u"], res["lev_v"])
        else:
            depth_u = trd_u = intra_u = torch.zeros((uh, uw), dtype=I32,
                                                    device=dev)
            mv_u = p_torch._upu(res["mvs"], ctu)
            lev = tuple(p_torch.to_plane(res[key])
                        for key in ("lev_y", "lev_u", "lev_v"))
        pp = None
        if mesh is not None:
            rec, pp = sharded.band_loop_filter(
                cur, outs, tree=tree, ctu=ctu, qp=qp, deblock=deblock,
                sao=sao)
            ref = [tuple(p.to(torch.uint8) for p in r) for r in rec]
        else:
            rec = tuple(res[key].to(I32)
                        for key in ("recon_y", "recon_u", "recon_v"))
            if deblock:
                rec = p_torch.tree_deblock(rec, res, ctu)
            if sao:
                qp_c = tables.chroma_qp_t(qp)
                # the reference filters the uint8 loop-filter output
                pp, rec = _sao_device((y.to(I32), u.to(I32), v.to(I32)),
                                      rec, ctu, qp, qp_c)
            ref = tuple(p.to(torch.uint8) for p in rec)
        if pp is None:
            pp = torch.zeros((3, H // ctu, W // ctu), dtype=I32, device=dev)
        wires.append(_frame_wire(depth_u, trd_u, intra_u, mv_u, res["sad"],
                                 pp, lev, cap, fine=cu8))
        denses.append(torch.cat([p.to(torch.int16).reshape(-1)
                                 for p in lev]))
    if mesh is not None:
        ref = sharded.join_planes(ref, dev)
    return (torch.stack(wires), torch.stack(denses), *ref)


# ---------------------------------------------------------------------------
# host side (copies of the reference's numpy helpers)
# ---------------------------------------------------------------------------

def _from4(rows, h, w):
    """Host inverse of to4 (numpy)."""
    return (rows.reshape(h // 4, w // 4, 4, 4).transpose(0, 2, 1, 3)
            .reshape(h, w))


def unpk_params(w):
    """Host inverse of pk_params -> (param dict, merge_left, merge_up)."""
    off = np.stack([((w >> (9 + 4 * i)) & 15) - 7 for i in range(4)], -1)
    par = dict(type=(w & 3).astype(np.int8),
               eo_class=((w >> 2) & 3).astype(np.int8),
               band_pos=((w >> 4) & 31).astype(np.int8),
               offsets=off.astype(np.int8))
    return par, ((w >> 25) & 1).astype(bool), ((w >> 26) & 1).astype(bool)


def wire_layout(H: int, W: int, ctu: int, cap: int, fine: bool = False):
    """Static per-frame wire layout: list of (name, shape) in int32 words
    (the decision grid per 16x16 block, per 8x8 block when `fine`)."""
    g = 8 if fine else 16
    hg, wg = H // g, W // g
    nby, nbx = H // ctu, W // ctu
    cap2 = max(64, cap // 8)
    return [
        ("cnt", (1,)),
        ("cnt2", (1,)),
        ("dec16", (hg, wg)),
        ("sad", (nby, nbx)),
        ("sao_pp", (3, nby, nbx)),
        ("idx", (cap,)),
        ("vals8", (cap, 4)),         # (cap, 16) int8 bitcast to (cap, 4)
        ("erow", (cap2,)),
        ("evals", (cap2, 8)),        # (cap2, 16) int16 bitcast
    ]


def unpack_wire(row: np.ndarray, H: int, W: int, ctu: int, cap: int,
                fine: bool = False):
    """Host-side wire row -> dict of numpy arrays: depth16, mv16, sad, SAO
    words, idx, vals (int16, escapes re-widened), cnt. With `fine` the
    decision grids are 8-granular (the keys keep their *16 names; the
    caller upsamples by `gran` to 4x4 units)."""
    out = {}
    o = 0
    for name, shape in wire_layout(H, W, ctu, cap, fine):
        n = int(np.prod(shape))
        out[name] = row[o:o + n].reshape(shape)
        o += n
    v8 = np.ascontiguousarray(out.pop("vals8")).view(np.int8)
    vals = v8.astype(np.int16)
    cap2 = max(64, cap // 8)
    n2 = min(int(out["cnt2"][0]), cap2)
    if n2:
        ev = np.ascontiguousarray(out["evals"]).view(np.int16)
        rows_i = out["erow"][:n2]
        vals[rows_i] = ev[:n2]
    out["vals"] = vals
    d = out.pop("dec16")
    out["depth16"] = (d & 3).astype(np.int32)
    out["trd16"] = ((d >> 2) & 1).astype(np.int32)
    out["intra16"] = ((d >> 3) & 1).astype(np.int32)
    out["mv16"] = np.stack([((d >> 4) & 4095) - 2048,
                            ((d >> 16) & 4095) - 2048], -1).astype(np.int32)
    out["gran"] = 2 if fine else 4
    return out


def scatter_levels(idx: np.ndarray, vals: np.ndarray, cnt: int,
                   H: int, W: int):
    """Rebuild dense level planes from compacted 4x4 sub-blocks (host)."""
    ny4 = (H // 4) * (W // 4)
    nc4 = (H // 8) * (W // 8)
    dense = np.zeros((ny4 + 2 * nc4, 16), np.int32)
    dense[idx[:cnt]] = vals[:cnt]
    return (_from4(dense[:ny4], H, W),
            _from4(dense[ny4:ny4 + nc4], H // 2, W // 2),
            _from4(dense[ny4 + nc4:], H // 2, W // 2))
