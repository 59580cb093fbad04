"""Band sharding of the P stages and the loop filter over several devices.

Port of homerhevc_tpu/parallel/sharded.py. Two axes, as there:
  * 'gop'  — lanes: each encodes its own frame (the reference's
             `num_enc_engines` engine threads, hmr_encoder_lib.c:3132);
  * 'band' — horizontal bands of one frame, each computed on its own device.
             A band's reference plane is extended by the rows the motion
             search and the 8-tap filter can reach (the halo), copied from
             the devices of the bands above and below (the reference's WPP
             row threads and their reference-progress semaphores,
             hmr_encoder_lib.c:2849-2987, :2393-2403).

A mesh is a (G, nb) nested sequence of torch devices that one process
drives, as JAX's single-controller mesh is; a device may be named several
times, so a mesh also runs on one card or on the CPU. Band outputs equal the
single-device stages of pipeline/p_torch.py element for element: the halo
carries exactly the rows the whole-frame computation reads, and a band at the
picture's top or bottom repeats the picture's edge row, as the whole-frame
edge padding does.

Both P stages run in bands: the fixed-CU stage (`_band_stage`,
`p_frame_bands`) and the CU quadtree (`_band_stage_tree`,
`p_frame_tree_bands`), and so do the deblocking filter and SAO after
either, or after an IDR (`band_loop_filter`), and the B stage
(`b_frame_bands`). The session (api.HomerEncoder with `mesh=` or
`wpp_shards`) runs every frame this way: P frames per frame and in chunks
(pipeline/p_chunk.py, where each band keeps its filtered reference rows
from frame to frame), IDRs through parallel/intra_bands.py, B frames
through `b_frame_bands`: one lane, bands of whole CTU rows, as even as the
picture's height allows (`band_heights`).
"""

from __future__ import annotations

import torch

from .. import tables
from ..device import I32, edge_pad
from ..ops import deblock as dbk
from ..ops import sao as sao_ops
from ..pipeline import b_torch, p_torch

PAD = p_torch.PAD

# the seven outputs of the sharded step, in the reference's order
OUTPUTS = ("mvs", "lev_y", "lev_u", "lev_v", "recon_y", "recon_u", "recon_v")

# the outputs of a band of the tree stage that the frame's result joins
TREE_KEYS = ("depth_u", "mv_u", "cbf_u", "trd_u", "pred_intra_u", "nz_u",
             "qp_ctu", "qp_u", "sad", "lev_y", "lev_u", "lev_v", "recon_y",
             "recon_u", "recon_v")
# the unit maps the tree stage's deblocking reads
UNIT_MAPS = ("depth_u", "mv_u", "cbf_u", "trd_u", "pred_intra_u", "qp_u")


def halo_rows(search: int) -> int:
    """Rows above and below a band that the P stages can read: the search
    range plus the 8-tap filter support, rounded up to 4, at most PAD
    (search 64: the hierarchical search's refine reaches |mv| <= 67, the
    luma support window 4 rows above and 5 below). Beyond them the band is
    edge-padded up to PAD, so the in-band indexing is the whole frame's;
    that outer ring is never read (tests/test_torch_parallel.py)."""
    return min(PAD, ((search + 8 + 3) // 4) * 4)


def _halo_extend(bands, pad: int) -> list:
    """Every band (rows, W), each on its own device, extended by `pad` rows
    above and below: the rows of the picture's edge-padded plane there. A
    band taller than `pad` takes them from its two neighbours; a shorter
    neighbour passes on what it has and the next band beyond gives the rest;
    past the picture's top or bottom the edge row is repeated.

    Rows go device to device with `.to(device, non_blocking=True)`, never
    through the host. A copy between two CUDA devices runs on the source's
    current stream after an event of the destination's current stream, and
    the destination's current stream waits for it in turn (PyTorch's
    cross-device copy), so each band's work is ordered after its halo."""
    top_edge, bottom_edge = bands[0][:1], bands[-1][-1:]
    out = []
    for i, band in enumerate(bands):
        dev = band.device

        def take(order, last: bool):
            parts, need = [], pad
            for j in order:
                if need == 0:
                    break
                k = min(need, bands[j].shape[0])
                rows = bands[j][-k:] if last else bands[j][:k]
                parts.append(rows.to(dev, non_blocking=True))
                need -= k
            return parts, need

        above, miss_top = take(range(i - 1, -1, -1), last=True)
        below, miss_bottom = take(range(i + 1, len(bands)), last=False)
        top = top_edge.to(dev, non_blocking=True).expand(miss_top, -1)
        bottom = bottom_edge.to(dev, non_blocking=True).expand(miss_bottom, -1)
        out.append(torch.cat([top, *above[::-1], band, *below, bottom]))
    return out


def _ref_bands(ref, search: int) -> list:
    """Each band's (y, u, v) uint8 reference rows as the PAD-padded int16
    planes its P stage reads: extended by `halo_rows(search)` rows of the
    neighbouring bands, then edge-padded to PAD rows and columns."""
    halo = halo_rows(search)
    e = PAD - halo
    ext = [_halo_extend([r[k].to(torch.int16) for r in ref],
                        halo if k == 0 else halo // 2) for k in range(3)]
    return [(edge_pad(ext[0][b], e, PAD),
             edge_pad(ext[1][b], e // 2, PAD // 2),
             edge_pad(ext[2][b], e // 2, PAD // 2))
            for b in range(len(ref))]


def _to(t, dev):
    return None if t is None else t.to(dev, non_blocking=True)


def _band_stage(cur, ref, qp, *, B: int, search: int, me_precision: int,
                sign_hiding: bool, kernels: bool) -> list:
    """The fixed-CU P stage on the bands of one frame. `cur` and `ref` hold
    per band its (y, u, v) uint8 planes on the band's device. Returns the
    per-band results of p_torch._p_stage (each on its band's device).

    Besides the reference rows, a band reads one thing of the band above:
    the refined MVs of its last block row, the merge candidate `top` of the
    band's first row. The bands run top to bottom and each passes that row
    on (device to device), so the merge decisions are the whole frame's.
    (The reference's band function gives the first row no top candidate,
    and so differs from its single-device stage where a block there would
    merge with the block above: ROADMAP, faults of the reference.)"""
    outs, top = [], None
    for (y, u, v), padded in zip(cur, _ref_bands(ref, search)):
        out = p_torch._p_stage(
            y, u, v, *padded, B=B, qp=qp, search=search,
            me_precision=me_precision, sign_hiding=sign_hiding,
            kernels=kernels, top_mv=_to(top, y.device))
        top = out["amvp"][-1]
        outs.append(out)
    return outs


def _band_stage_tree(cur, ref, qp, *, ctu: int, search: int,
                     me_precision: int, sign_hiding: bool,
                     tr_split: bool = False, intra_in_p: bool = False,
                     cu8: bool = False, qp_rows=None, wpp: bool = False,
                     vis=None, kernels: bool = True) -> list:
    """The CU-quadtree P stage (p_torch._p_stage_tree) on the bands of one
    frame, `cur` and `ref` as in `_band_stage`; `qp_rows` (one QP per CTU
    row) and `vis` (the visible picture) are the whole frame's. Returns the
    per-band results (each on its band's device).

    What a band reads of the others, besides the reference rows:
      * the band above's last S-row of refined MVs at every CU size S, the
        merge candidate `top` of its first row (passed on top to bottom);
      * intra-in-P (CTU 32): see `_band_intra`;
      * without WPP, the decoded-QP start of its first row: the target of
        the last coded row above it, else the slice QP (passed on top to
        bottom; with WPP every row starts from the slice QP).
    Its rows of `qp_rows` are cut from the frame's, and `vis` is given in
    band coordinates, so only the bottom band sees the conformance
    padding."""
    if ctu not in (32, 64):
        raise NotImplementedError(f"tree P stage in bands at ctu={ctu} (32 "
                                  "and 64 are ported)")
    states, top, r0 = [], None, 0
    for (y, u, v), padded in zip(cur, _ref_bands(ref, search)):
        dev, n = y.device, y.shape[0]
        qr = (None if qp_rows is None
              else _to(qp_rows[r0 // ctu:(r0 + n) // ctu], dev))
        st = p_torch._tree_levels(
            y, u, v, *padded, ctu=ctu, qp=qp, search=search,
            me_precision=me_precision, sign_hiding=sign_hiding,
            tr_split=tr_split, cu8=cu8, qp_rows=qr, kernels=kernels,
            vis=None if vis is None else (vis[0] - r0, vis[1]),
            top_mv=None if top is None else {S: _to(t, dev)
                                             for S, t in top.items()})
        top = st["top"]
        states.append((st, qr, r0))
        r0 += n
    if intra_in_p and ctu == 32:
        _band_intra(cur, states, sign_hiding)
    outs, start = [], None
    for st, qr, _ in states:
        if start is not None:
            start = _to(start, st["qp"].device)
        res = p_torch.tree_finish(st, qp_rows=qr, wpp=wpp, qp_start=start)
        if qr is not None and not wpp:
            start = p_torch.qp_carry(qr, res["nz_u"], ctu,
                                     st["qp"] if start is None else start)
        outs.append(res)
    return outs


def _band_intra(cur, states, sign_hiding: bool) -> None:
    """Intra-in-P (CTU 32) over the bands' `_tree_levels` states, in place.
    The CTUs tried are the frame's worst N by inter cost
    (`p_torch.intra_sel_count` of the whole frame), selected once over the
    bands' cost grids gathered on the first device, ties to the lower frame
    index; each band codes its own of them, its first CTU row's top
    references (luma and chroma, top right included) read from the last
    row of the band above's pre-deblock inter reconstruction; the 4-colour
    acceptance cascade runs once, on the frame's candidate grid (colours
    and 8-neighbourhoods across band edges are the frame's); each band
    takes its accepted CUs. Which CTUs a band codes is read on the host:
    one synchronisation per frame."""
    dst = cur[0][0].device
    grid = torch.cat([_to(st["c32eff"], dst) for st, _, _ in states])
    sel = p_torch.worst_n(grid.reshape(-1),
                          p_torch.intra_sel_count(grid.numel()))
    cands, above, lo = [], None, 0
    for (_, u, v), (st, qr, r0) in zip(cur, states):
        dev = st["cur"].device
        nb = st["c32eff"].numel()
        mine = sel[(sel >= lo) & (sel < lo + nb)] - lo
        cands.append(None if not mine.numel() else p_torch._intra_candidates(
            st["cur"], u, v, st["rec"], _to(mine, dev), qp=st["qp"],
            lamf=st["lamf"], sign_hiding=sign_hiding, qp_rows=qr,
            above=None if above is None else tuple(_to(a, dev)
                                                   for a in above),
            row0=r0 // 32))
        # the band below reads this band's inter rows, before any intra CU
        # replaces them
        above = tuple(p[-1] for p in st["rec"])
        lo += nb
    acc = p_torch._intra_cascade(torch.cat([
        torch.zeros(st["c32eff"].shape, dtype=torch.bool, device=dst)
        if c is None else _to(c[0] < st["c32eff"], dst)
        for c, (st, _, _) in zip(cands, states)]))
    r = 0
    for c, (st, _, _) in zip(cands, states):
        nby = st["c32eff"].shape[0]
        if c is not None:
            p_torch.tree_intra(st, _to(acc[r:r + nby], st["cur"].device),
                               *c[1:])
        r += nby


def _cut(plane, rows, devs) -> list:
    """A plane cut into consecutive bands of `rows` rows, band b put on
    devs[b]."""
    out, r0 = [], 0
    for n, dev in zip(rows, devs):
        out.append(plane[r0:r0 + n].to(dev, non_blocking=True))
        r0 += n
    return out


def cut_planes(planes, rows, devs) -> list:
    """(y, u, v) planes cut into bands of `rows` luma rows: per band its
    (y, u, v) on devs[b]."""
    return list(zip(*(_cut(p, [n >> (k > 0) for n in rows], devs)
                      for k, p in enumerate(planes))))


def join_planes(bands, dst) -> tuple:
    """Per-band (y, u, v) planes joined into whole planes on `dst`."""
    return tuple(torch.cat([_to(b[k], dst) for b in bands])
                 for k in range(3))


def band_heights(ctu_rows: int, nb: int) -> list:
    """CTU rows per band when `ctu_rows` are cut into at most `nb` bands as
    evenly as possible, the first bands taking the extra rows (no empty
    band: fewer rows than bands gives one band per row)."""
    return [ctu_rows // nb + (b < ctu_rows % nb)
            for b in range(min(nb, ctu_rows))]


def band_rows(devs, height: int, ctu: int):
    """(luma rows per band, the devices that get a band) for a picture of
    `height` rows in CTU rows of `ctu`, cut by band_heights."""
    rows = [n * ctu for n in band_heights(height // ctu, len(devs))]
    return rows, devs[:len(rows)]


def join_fixed(outs, dst) -> dict:
    """The fixed-CU stage's frame result (p_torch.fixed_result) on `dst`
    from its bands' results."""
    def cat(key):
        return torch.cat([_to(o[key], dst) for o in outs])

    return p_torch.fixed_result(*(cat(k) for k in (
        "mvs", "sad", "lev_y", "lev_u", "lev_v", "recon_y", "recon_u",
        "recon_v")))


def join_tree(outs, dst) -> dict:
    """The tree stage's frame result (p_torch.tree_result, the wire too) on
    `dst` from its bands' results."""
    return p_torch.tree_result(*(torch.cat([_to(o[k], dst) for o in outs])
                                 for k in TREE_KEYS))


def _neighbours(parts, b: int, above, below):
    """The last rows of parts[b - 1] and the first rows of parts[b + 1]
    (each a tuple of tensors, rows first; `above` and `below` rows of each,
    or a count per tensor), on parts[b]'s device; None past the picture's
    top or bottom."""
    dev = parts[b][0].device
    n = len(parts[b])
    above = (above,) * n if isinstance(above, int) else above
    below = (below,) * n if isinstance(below, int) else below
    up = (None if b == 0 else
          tuple(_to(t[-k:], dev) for t, k in zip(parts[b - 1], above)))
    down = (None if b == len(parts) - 1 else
            tuple(_to(t[:k], dev) for t, k in zip(parts[b + 1], below)))
    return up, down


def _deblock_bands(recs, outs, *, tree: bool, ctu: int, qp,
                   intra: bool = False) -> list:
    """The deblocking filter on the bands of one frame: per band its
    filtered int32 (y, u, v), equal to the whole frame's rows there. A band
    reads dbk.HALO_Y luma and dbk.HALO_C chroma rows of its neighbours'
    reconstruction and the bS / QP inputs of dbk.HALO_UNITS unit rows: of
    the tree stage, its unit maps; of an IDR (`intra`), its CU depth and TU
    split maps (the intra bS of a unit row reads that row's maps alone, so
    the tree's unit halo holds for it); of the fixed-CU stage, the block
    row above and below (MVs and cbf). Each band filters in zeros of the
    span the maps cover (above: a block row, or the rows back to the 32-row
    TU grid, 1 to 32; below: a block row, or 16 rows), so the TU grid and
    the chroma edge grid stay aligned. The IDR's TU grid is 32 rows even at
    CTU 16 (fault 2 of the reference), where a band may start 16 rows off
    it."""
    nb = len(recs)
    r0 = [0]
    for r in recs[:-1]:
        r0.append(r0[-1] + r[0].shape[0])
    # unit rows above and below a band (lead: back to the 32-row grid)
    lead_u, trail_u = [(32 - (-r) % 32) // 4 for r in r0], 4
    units = dbk.HALO_UNITS
    if intra:
        maps = [(o["depth_units"],) if o["trd_units"] is None
                else (o["depth_units"], o["trd_units"]) for o in outs]
    elif tree:
        maps = [tuple(o[k] for k in UNIT_MAPS) for o in outs]
    else:
        maps = []
        for o in outs:
            lev = o["lev_y"]
            m = (o["mvs"], (lev != 0).any(dim=-1).any(dim=-1))
            if ctu == 64:                       # the cbf of its four TBs
                nby, nbx = lev.shape[:2]
                m += ((lev.reshape(nby, nbx, 2, 32, 2, 32) != 0)
                      .any(5).any(3),)
            maps.append(m)
        lead_u, trail_u = [1] * nb, 1           # block rows
        units = (1, 1)
    halo_px = (dbk.HALO_Y, dbk.HALO_C, dbk.HALO_C)
    out = []
    for b in range(nb):
        lead = 0 if b == 0 else lead_u[b]
        trail = 0 if b == nb - 1 else trail_u
        m_up, m_down = _neighbours(maps, b, *units)
        ext = [dbk.embed_rows(m, None if m_up is None else m_up[i],
                              None if m_down is None else m_down[i],
                              lead, trail)
               for i, m in enumerate(maps[b])]
        if intra:
            bs_v, bs_h = dbk.intra_bs_from_depth_units(
                ext[0], trd_u=ext[1] if len(ext) > 1 else None)
            qp_u = p_torch._qp_tensor(qp, recs[b][0].device).expand(
                bs_v.shape[0], bs_h.shape[1])
            lead_px = lead * 4
        elif tree:
            depth_u, mv_u, cbf_u, trd_u, intra_u, qp_u = ext
            bs_v, bs_h = dbk.inter_bs_from_units(
                depth_u, mv_u, cbf_u, ctu.bit_length() - 1, trd_u=trd_u,
                intra_u=intra_u)
            lead_px = lead * 4
        else:
            bs_v, bs_h = dbk.inter_bs_from_blocks(
                ext[0], ext[1], ctu, qcbf=ext[2] if ctu == 64 else None)
            qp_u = p_torch._qp_tensor(qp, recs[b][0].device).expand(
                bs_v.shape[0], bs_h.shape[1])
            lead_px = lead * ctu
        up, down = _neighbours(recs, b, halo_px, halo_px)
        out.append(dbk.deblock_band(*recs[b], up, down, bs_v=bs_v, bs_h=bs_h,
                                    qp_map=qp_u, lead=lead_px))
    return out


def _sao_bands(curs, recs, *, ctu: int, qp, host: bool,
               slice_p: bool = True):
    """SAO on the bands of one frame's deblocked int32 planes `recs`
    (sources `curs`): each band's statistics read one row of each
    neighbour, the parameters are derived once from the statistics
    gathered on the first device (`host`: copied to the host and derived
    there, as the session's per-frame path does; `slice_p`: with the P
    slice's lambdas, else the I slice's), each band is filtered with its
    rows of them and the same one-row halo. Returns (per-band filtered
    int32 planes, the derivation's result: the packed words (3, nby, nbx)
    on the first device, or with `host` the sao_info)."""
    nb = len(recs)
    sizes = (ctu, ctu // 2, ctu // 2)
    exts, halos, stats = [], [], []
    for b in range(nb):
        up, down = _neighbours(recs, b, 1, 1)
        halo = (int(up is not None), int(down is not None))
        ext = tuple(torch.cat([p for p in (None if up is None else up[k],
                                           recs[b][k],
                                           None if down is None else down[k])
                               if p is not None]) for k in range(3))
        exts.append(ext)
        halos.append(halo)
        stats.append([t for k in range(3) for t in sao_ops.stats_one(
            curs[b][k].to(I32), ext[k], sizes[k], halo)])
    dst = recs[0][0].device
    parts = [torch.cat([_to(st[i], dst) for st in stats], dim=-2)
             for i in range(12)]
    if host:
        qp_i = int(qp)
        info = sao_ops.derive_on_host(
            parts, qp_i, int(tables.chroma_qp_from_luma(qp_i)),
            slice_p=slice_p)
        params = (info["luma"], info["cb"], info["cr"])
        derived = info
    else:
        from ..pipeline.p_chunk import pk_params
        qp_t = p_torch._qp_tensor(qp, dst)
        luma, cbp, crp, ml, mu = sao_ops.derive_all_from_stats(
            tuple(parts[0:4]), tuple(parts[4:8]), tuple(parts[8:12]), qp_t,
            tables.chroma_qp_t(qp_t), slice_p=slice_p)
        params = (luma, cbp, crp)
        derived = torch.stack([pk_params(luma, merge=(ml, mu)),
                               pk_params(cbp), pk_params(crp)])
    out, r = [], 0
    for b in range(nb):
        dev = recs[b][0].device
        nby = recs[b][0].shape[0] // ctu

        def rows(par):
            return {k: (torch.as_tensor(v)[r:r + nby]).to(dev)
                    for k, v in par.items()}

        out.append(tuple(sao_ops.apply_sao(exts[b][k], rows(params[k]),
                                           sizes[k], halos[b])
                         for k in range(3)))
        r += nby
    return out, derived


def band_loop_filter(curs, outs, *, tree: bool = False, ctu: int, qp,
                     deblock: bool, sao: bool, host: bool = False,
                     intra: bool = False):
    """The loop filter of one frame in its bands: `outs` are the bands'
    stage results (`_band_stage`; with `tree`, `_band_stage_tree`'s; with
    `intra`, an IDR's: recon_*, depth_units and trd_units, None without a
    TU split), `curs` their source planes. Deblocking (`_deblock_bands`)
    and then SAO (`_sao_bands`, an I slice's with `intra`), each band on
    its own device, equal to the whole-frame filter's rows. Returns
    (per-band filtered int32 (y, u, v), the SAO derivation's result or
    None)."""
    recs = [tuple(o[k].to(I32) for k in ("recon_y", "recon_u", "recon_v"))
            for o in outs]
    if deblock:
        recs = _deblock_bands(recs, outs, tree=tree, ctu=ctu, qp=qp,
                              intra=intra)
    if not sao:
        return recs, None
    return _sao_bands(curs, recs, ctu=ctu, qp=qp, host=host,
                      slice_p=not intra)


def _frame_bands(devs, planes, ref, *, tree: bool, ctu: int, qp,
                 deblock: bool, sao: bool, stage: dict):
    """One P frame in bands, per frame: the stage, its loop filter (SAO
    derived on the host, as the session's per-frame path does), the result
    joined on the planes' device with ref_* the filtered planes and, with
    SAO, sao_info."""
    y = planes[0]
    rows, devs = band_rows(devs, y.shape[0], ctu)
    cur = cut_planes(planes, rows, devs)
    ref_b = cut_planes(ref, rows, devs)
    if tree:
        outs = _band_stage_tree(cur, ref_b, qp, ctu=ctu, **stage)
        result = join_tree(outs, y.device)
    else:
        outs = _band_stage(cur, ref_b, qp, B=ctu, **stage)
        result = join_fixed(outs, y.device)
    if deblock or sao:
        filt, info = band_loop_filter(cur, outs, tree=tree, ctu=ctu, qp=qp,
                                      deblock=deblock, sao=sao, host=True)
        fy, fu, fv = join_planes(filt, y.device)
        result["ref_y"] = fy.to(torch.uint8)
        result["ref_u"] = fu.to(torch.uint8)
        result["ref_v"] = fv.to(torch.uint8)
        if sao:
            result["sao_info"] = info
    return result


def p_frame_bands(devs, y, u, v, ref_y, ref_u, ref_v, *, B: int, qp,
                  search: int, me_precision: int, deblock: bool = False,
                  sao: bool = False, sign_hiding: bool = False,
                  kernels: bool = True) -> dict:
    """p_torch.p_frame_device with the stage and the loop filter in bands on
    `devs`; with `sao`, ref_* are SAO-filtered too and `sao_info` holds
    the parameters."""
    return _frame_bands(devs, (y, u, v), (ref_y, ref_u, ref_v), tree=False,
                        ctu=B, qp=qp, deblock=deblock, sao=sao, stage=dict(
                            search=search, me_precision=me_precision,
                            sign_hiding=sign_hiding, kernels=kernels))


def p_frame_tree_bands(devs, y, u, v, ref_y, ref_u, ref_v, *, ctu: int, qp,
                       deblock: bool = False, sao: bool = False,
                       **stage) -> dict:
    """p_torch.p_frame_tree_device with the stage (`_band_stage_tree`,
    `stage`: its keywords) and the loop filter in bands on `devs`; with
    `sao`, ref_* are SAO-filtered too and `sao_info` holds the
    parameters."""
    return _frame_bands(devs, (y, u, v), (ref_y, ref_u, ref_v), tree=True,
                        ctu=ctu, qp=qp, deblock=deblock, sao=sao,
                        stage=stage)


def b_frame_bands(devs, y, u, v, r0y, r0u, r0v, r1y, r1u, r1v, *, B: int,
                  qp, search: int, me_precision: int,
                  sign_hiding: bool = False, vis=None,
                  kernels: bool = True) -> dict:
    """b_torch.b_frame_device in bands of whole CTU rows on `devs`
    (`band_rows`). Each band runs the B stage on its rows against both
    references cut with `_ref_bands` (halo_rows(search) rows of the
    neighbouring bands, device to device; the hierarchical search's PAD
    rows come from the bands beyond where a band is shorter), `vis` seen
    from the band's first row. Blocks read nothing else of another band:
    the merge/AMVP walk that links them runs on the host
    (b_golden.build_b_plans) over the joined arrays. The result is joined
    on y's device, the wire packed once from the joined arrays (word for
    word the single device's)."""
    if B not in (16, 32):
        raise NotImplementedError(f"B stage in bands at B={B} (16 and 32 "
                                  "are ported)")
    dst = y.device
    rows, devs = band_rows(devs, y.shape[0], B)
    cur = cut_planes((y, u, v), rows, devs)
    refs = [_ref_bands(cut_planes(ref, rows, devs), search)
            for ref in ((r0y, r0u, r0v), (r1y, r1u, r1v))]
    outs, r0 = [], 0
    for b, (yb, ub, vb) in enumerate(cur):
        outs.append(b_torch.b_stage(
            yb, ub, vb, (refs[0][b], refs[1][b]), B=B, qp=qp, search=search,
            me_precision=me_precision, sign_hiding=sign_hiding, vis=vis,
            row0=r0, kernels=kernels))
        r0 += rows[b]
    out = {k: torch.cat([_to(o[k], dst) for o in outs]) for k in outs[0]}
    out["wire"] = b_torch.pack_b_wire(out)
    return out


def make_p_frame_sharded(mesh, *, B: int, search: int, me_precision: int,
                         sign_hiding: bool = False, kernels: bool = True):
    """The band- and lane-sharded P stage on a (G, nb) mesh of devices.

    The returned step takes (G, H, W) uint8 frames and references (chroma
    (G, H/2, W/2)) and one QP per lane, and returns the reference's seven
    outputs (mvs, lev_y, lev_u, lev_v, recon_y, recon_u, recon_v), lane
    axis first and block rows next, on the mesh's first device. Lane g's
    frame is cut into nb equal bands, band b computed on mesh[g][b]. Raises
    ValueError where the reference's shard_map asserts: H not divisible by
    nb, a band height that is not a multiple of B, a band shorter than the
    halo."""
    mesh = [[torch.device(d) for d in row] for row in mesh]
    nb = len(mesh[0])
    if not nb or any(len(row) != nb for row in mesh):
        raise ValueError(f"mesh rows must hold one device per band: "
                         f"{[len(row) for row in mesh]}")
    halo = halo_rows(search)

    def step(y, u, v, ry, ru, rv, qp):
        G, H, _ = y.shape
        if G != len(mesh):
            raise ValueError(f"{G} lanes on a mesh of {len(mesh)} rows")
        if H % nb:
            raise ValueError(f"height {H} is not divisible by {nb} bands")
        hb = H // nb
        if hb % B:
            raise ValueError(f"band height {hb} is not a multiple of B={B}")
        if hb < halo:
            raise ValueError(f"band height {hb} < halo {halo}; use fewer "
                             "bands")
        lanes = []
        for g, devs in enumerate(mesh):
            cur = list(zip(*(_cut(p[g], [hb >> (k > 0)] * nb, devs)
                             for k, p in enumerate((y, u, v)))))
            ref = list(zip(*(_cut(p[g], [hb >> (k > 0)] * nb, devs)
                             for k, p in enumerate((ry, ru, rv)))))
            lanes.append(_band_stage(cur, ref, qp[g], B=B, search=search,
                                     me_precision=me_precision,
                                     sign_hiding=sign_hiding,
                                     kernels=kernels))
        dst = mesh[0][0]
        return tuple(
            torch.stack([torch.cat([o[k].to(dst, non_blocking=True)
                                    for o in outs]) for outs in lanes])
            for k in OUTPUTS)

    return step


def dryrun(mesh, *, B: int = 16, frames_hw=(128, 64), search: int = 8):
    """One sharded P step on small shapes (synth_clip frames, one clip per
    lane, QP 32), held against the single-device stage on every lane and
    every output; True, or AssertionError."""
    import numpy as np

    from ..utils.synth import synth_clip

    mesh = [[torch.device(d) for d in row] for row in mesh]
    G = len(mesh)
    h, w = frames_hw
    fs = [list(synth_clip(w, h, 2, seed=g)) for g in range(G)]
    dev = mesh[0][0]
    refs = [torch.as_tensor(np.stack([fs[g][0][i] for g in range(G)]),
                            device=dev) for i in range(3)]
    curs = [torch.as_tensor(np.stack([fs[g][1][i] for g in range(G)]),
                            device=dev) for i in range(3)]
    step = make_p_frame_sharded(mesh, B=B, search=search, me_precision=2)
    got = step(*curs, *refs, [32] * G)
    for g in range(G):
        single = p_torch.p_frame_device(
            *(p[g] for p in curs), *(p[g] for p in refs), B=B, qp=32,
            search=search, me_precision=2)
        for k, out in zip(OUTPUTS, got):
            if not torch.equal(out[g], single[k]):
                raise AssertionError(f"sharded {k} diverges from "
                                     f"single-device on lane {g}")
    return True
