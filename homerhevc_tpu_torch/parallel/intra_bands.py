"""The IDR in bands of CTU rows over several devices: pass A of the
split-RDO IDR, the closed-loop wavefront of pass B (the fixed-CU IDR runs
the same loop), and the IDR's deblocking and SAO.

The JAX session row-shards every uploaded plane over its mesh's 'band' axis
and GSPMD partitions the IDR's wavefront loop (homerhevc_tpu/api.py,
pipeline/intra_jax.py); here each band of whole CTU rows
(sharded.band_rows) runs on its own device, and every output equals
pipeline/intra_torch.encode_frame_intra's element for element. What a band
reads across its edges:

  * pass A is open-loop: every reference sample comes from the source
    plane, so a band needs source rows of its neighbours and no
    reconstruction. A block's top reference is the row above it (one row
    above the band), and the left column of a block of size S runs 2S
    samples down (S rows below the band at its last block row: 32 where
    pass A runs at B 32, 16 at B 16); `open_loop_halo` gives the two, and
    tests/test_torch_parallel_idr_b.py and tests/test_torch_ctu16.py show
    that one row fewer either way changes a map;
  * pass B: lane (r, c) of diagonal d reads the bottom row of CTU row r-1
    from column x0 - 1 to x0 + 2B - 1, coded at diagonals d-3 .. d-1, and
    its own row's left neighbour. Nothing reads across a CTU row downward,
    so a band needs one thing of the band above: its last bottom row as it
    stood after diagonal d-1 (luma and both chroma, one int32 row of 2W
    samples), copied device to device (`hand_off`) before each diagonal on
    which the band's first row has a lane. The bands run each diagonal from
    the bottom up, so the band above has not yet run it; a band with no
    lane on a diagonal launches nothing, and no diagonal waits for the host;
  * the loop filter: sharded.band_loop_filter with the IDR's maps
    (`intra`): the deblocking halos of ops/deblock.py, SAO's one row, its
    parameters derived once for the I slice.

The joined result is on the first device, its wire packed once from the
joined planes: a concatenation of band wires would reorder it.
"""

from __future__ import annotations

import torch

from .. import tables
from ..device import const
from ..pipeline import intra_torch
from ..pipeline.p_torch import _qp_tensor, to_plane
from . import sharded

# source rows a band's pass A at B 32 reads beyond its own: (above, below)
OPEN_LOOP_HALO = (1, 32)


def open_loop_halo(B: int) -> tuple:
    """(above, below): the source rows a band's pass A at block size B (16
    or 32) reads beyond its own; below, the largest block's side."""
    return OPEN_LOOP_HALO[0], min(OPEN_LOOP_HALO[1], B)


def open_loop_maps_bands(y, rows, devs, *, qp, strong_smoothing: bool,
                         rd_mode: int, tu_split: bool, B: int = 32) -> list:
    """Pass A (intra_torch._open_loop_maps at block size B, 16 or 32) on
    bands of `rows` luma rows of the padded luma plane `y`, band b on
    devs[b]: per band its (mode_u, depth_u, part_u, trd_u) unit maps of its
    own rows, on its device. A band's plane is cut from `y` with
    `open_loop_halo(B)` rows beyond it, fewer at the picture's top and
    bottom."""
    H = y.shape[0]
    halo = open_loop_halo(B)
    out, r0 = [], 0
    for n, dev in zip(rows, devs):
        above = min(halo[0], r0)
        below = min(halo[1], H - r0 - n)
        plane = y[r0 - above:r0 + n + below].to(dev, non_blocking=True)
        qp_t = _qp_tensor(qp, dev)
        out.append(intra_torch._open_loop_maps(
            plane, B=B, qp=qp_t, lam_fx=const(tables.LAMBDA_FX, dev)[qp_t],
            strong_smoothing=strong_smoothing, rd_mode=rd_mode,
            tu_split=tu_split, above=above, below=below))
        r0 += n
    return out


def hand_off(above: intra_torch.Wave, below: intra_torch.Wave) -> None:
    """Give `below`'s first CTU row the last bottom row of the band above
    (luma, Cb and Cr in one row), device to device."""
    below.bot_rows[0].copy_(above.bot_rows[-1], non_blocking=True)


def intra_frame_bands(devs, y, u, v, *, B: int, qp,
                      strong_smoothing: bool = True,
                      sign_hiding: bool = False, split_rdo: bool = False,
                      rd_mode: int = 1, tu_depth: int = 0,
                      deblock: bool = False, sao: bool = False) -> dict:
    """intra_torch.encode_frame_intra with the frame in bands of whole CTU
    rows on `devs`: pass A in bands (split RDO; the decided tree joined on
    y's device, copied to the host once and cut per band), then the
    wavefront, each band running its lanes of every diagonal on its
    device. Returns encode_frame_intra's dict on y's device; with
    `deblock` or `sao` also the loop filter in bands (an IDR's: bS from its
    CU depth and, with `tu_depth`, TU split maps; SAO derived on the host,
    as the session's per-frame path does): ref_y/u/v the filtered planes
    and, with `sao`, `sao_info`."""
    if B not in (16, 32, 64):
        raise NotImplementedError(f"IDR in bands at B={B} (16, 32 and 64 "
                                  "are ported)")
    H, W = y.shape
    dst = y.device
    rows, devs = sharded.band_rows(devs, H, B)
    cur = sharded.cut_planes((y, u, v), rows, devs)
    tu_on = bool(tu_depth) and split_rdo
    maps = tree = parts = None
    if split_rdo:
        parts = open_loop_maps_bands(y, rows, devs, qp=qp,
                                     strong_smoothing=strong_smoothing,
                                     rd_mode=rd_mode, tu_split=tu_on,
                                     B=min(B, 32))
        maps = tuple(torch.cat([sharded._to(p[k], dst) for p in parts])
                     for k in range(4))
        tree = intra_torch.decided_tree(maps, B, tu_on)
    waves, r0 = [], 0
    for (yb, ub, vb), n in zip(cur, rows):
        lo, hi = r0 // B, (r0 + n) // B
        band_tree = None if tree is None else tuple(
            t[lo:hi] if i > 2 else sharded._to(t[lo:hi], yb.device)
            for i, t in enumerate(tree))
        waves.append(intra_torch.Wave(yb, ub, vb, r0=lo, B=B, qp=qp,
                                      rd_mode=rd_mode, tree=band_tree))
        r0 += n
    for d in range(intra_torch.n_diagonals(H // B, W // B)):
        # bottom up: the band above has run diagonal d-1, not yet d
        for b in range(len(waves) - 1, -1, -1):
            wv = waves[b]
            lanes = wv.lanes(d)
            if lanes is None:
                continue
            if b and lanes[0] == wv.r0:
                hand_off(waves[b - 1], wv)
            intra_torch.run_diagonal(wv, d, sign_hiding=sign_hiding,
                                     strong_smoothing=strong_smoothing)

    def join(key):
        return {k: torch.cat([sharded._to(getattr(w, key)[k], dst)
                              for w in waves]) for k in ("y", "u", "v")}

    res = intra_torch.intra_result(
        join("lev"), join("rec"), B=B, maps=maps,
        mode_cb=None if split_rdo else torch.cat(
            [sharded._to(w.mode_cb, dst) for w in waves]))
    if deblock or sao:
        outs = []
        for b, wv in enumerate(waves):
            o = {f"recon_{k}": to_plane(wv.rec[k]) for k in ("y", "u", "v")}
            o["depth_units"] = (parts[b][1] if split_rdo else torch.zeros(
                (rows[b] // 4, W // 4), dtype=torch.int32, device=wv.device))
            o["trd_units"] = parts[b][3] if tu_depth and split_rdo else None
            outs.append(o)
        filt, info = sharded.band_loop_filter(
            cur, outs, ctu=B, qp=qp, deblock=deblock, sao=sao, host=True,
            intra=True)
        for k, p in zip(("y", "u", "v"), sharded.join_planes(filt, dst)):
            res[f"ref_{k}"] = p.to(torch.uint8)
        if sao:
            res["sao_info"] = info
    return res
