"""Intra prediction (spec 8.4.4.2.2-.6), batched over blocks.

Port of homerhevc_tpu/ops/intra.py. The reference computes one block and is
vmapped; here every function takes a leading block axis N. The reference's
one-hot f32 contractions (the negative-reference extension and the angular
shift-select, TPU tricks for the MXU) become integer `torch.gather`s. All
arithmetic is exact int32, equal to the reference element for element.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import tables
from ..device import const

I32 = torch.int32


@functools.lru_cache(maxsize=None)
def _mode_tables(n: int):
    """Per-mode angle / invAngle / family / filter flag, and the per-row
    (idx, fact) of the angular projection, for block size n (copy of the
    reference's numpy table function, whose module imports jax)."""
    modes = np.arange(35)
    angle = tables.INTRA_PRED_ANGLE.copy()
    inv_angle = tables.INV_ANGLE.copy()
    is_vertical = modes >= 18
    min_dist = np.minimum(np.abs(modes - 26), np.abs(modes - 10))
    thres = {8: 7, 16: 1, 32: 0}.get(n, 100)
    filter_flag = (min_dist > thres) & (modes != 1) & (n > 4)
    filter_flag[0] = n > 4 and min_dist[0] > thres
    y = np.arange(n)
    pos = (y[None, :] + 1) * angle[:, None]
    return (angle.astype(np.int32), inv_angle.astype(np.int32), is_vertical,
            filter_flag, (pos >> 5).astype(np.int32),
            (pos & 31).astype(np.int32))


def _tabs(n: int, device):
    return tuple(const(a, device) for a in _mode_tables(n))


def prepare_refs(top, left, corner, has_left, has_top, *, size: int,
                 c_idx: int, strong_smoothing: bool, bit_depth: int = 8):
    """Substitute unavailable refs and produce filtered variants.

    top/left (N, 2n) int32, corner (N,), has_left/has_top (N,) bool.
    Returns (top, left, corner, ftop, fleft, fcorner)."""
    n2 = 2 * size
    mid = 1 << (bit_depth - 1)
    hl = has_left.to(torch.bool)
    ht = has_top.to(torch.bool)
    top = top.to(I32)
    left = left.to(I32)
    corner = corner.to(I32)
    corner = torch.where(hl & ht, corner,
                         torch.where(hl, left[:, 0],
                                     torch.where(ht, top[:, 0], mid)))
    top = torch.where(ht[:, None], top,
                      torch.where(hl[:, None], left[:, :1].expand(-1, n2),
                                  mid))
    left = torch.where(hl[:, None], left,
                       torch.where(ht[:, None], top[:, :1].expand(-1, n2),
                                   mid))
    if c_idx != 0:
        return top, left, corner, top, left, corner

    # 3-tap [1 2 1] smoothing over the scan (left reversed, corner, top)
    vals = torch.cat([left.flip(-1), corner[:, None], top], dim=-1)
    sm = vals.clone()
    sm[:, 1:-1] = (vals[:, :-2] + 2 * vals[:, 1:-1] + vals[:, 2:] + 2) >> 2
    fleft = sm[:, :n2].flip(-1)
    fcorner = sm[:, n2]
    ftop = sm[:, n2 + 1:]

    if size == 32 and strong_smoothing:
        b = 1 << (bit_depth - 5)
        cond = (((corner + top[:, n2 - 1] - 2 * top[:, size - 1]).abs() < b)
                & ((corner + left[:, n2 - 1] - 2 * left[:, size - 1]).abs()
                   < b))
        xs = torch.arange(n2, device=top.device, dtype=I32)
        stop = ((63 - xs) * corner[:, None] + (xs + 1) * top[:, n2 - 1:n2]
                + 32) >> 6
        sleft = ((63 - xs) * corner[:, None] + (xs + 1) * left[:, n2 - 1:n2]
                 + 32) >> 6
        stop[:, n2 - 1] = top[:, n2 - 1]
        sleft[:, n2 - 1] = left[:, n2 - 1]
        ftop = torch.where(cond[:, None], stop, ftop)
        fleft = torch.where(cond[:, None], sleft, fleft)
        fcorner = torch.where(cond, corner, fcorner)
    return top, left, corner, ftop, fleft, fcorner


def _planar_dc(top, left, top_m0, left_m0, n: int, c_idx: int):
    """Planar from the (mode-0-selected) refs and DC from the unfiltered
    refs: (N, n, n) each."""
    log2 = n.bit_length() - 1
    x = torch.arange(n, device=top.device, dtype=I32)
    xx = x[None, None, :]                      # column index
    yy = x[None, :, None]                      # row index
    l0y = left_m0[:, :n][:, :, None]           # l0[yy]
    t0x = top_m0[:, :n][:, None, :]            # t0[xx]
    planar = ((n - 1 - xx) * l0y + (xx + 1) * top_m0[:, n, None, None]
              + (n - 1 - yy) * t0x + (yy + 1) * left_m0[:, n, None, None]
              + n) >> (log2 + 1)
    dc = (top[:, :n].sum(-1) + left[:, :n].sum(-1) + n) >> (log2 + 1)
    dcb = dc[:, None, None].expand(-1, n, n).to(I32).clone()
    if c_idx == 0 and n < 32:
        dcb[:, 0, :] = ((top[:, :n] + 3 * dc[:, None] + 2) >> 2).to(I32)
        dcb[:, :, 0] = ((left[:, :n] + 3 * dc[:, None] + 2) >> 2).to(I32)
        dcb[:, 0, 0] = ((left[:, 0] + 2 * dc + top[:, 0] + 2) >> 2).to(I32)
    return planar.to(I32), dcb


def predict_all_modes(top, left, corner, ftop, fleft, fcorner, *, size: int,
                      c_idx: int, bit_depth: int = 8) -> torch.Tensor:
    """(N, 35, n, n) int32 predictions from prepared refs (N, 2n)."""
    n = size
    dev = top.device
    N = top.shape[0]
    angle, inv_angle, is_vert, ff, idx, fact = _tabs(n, dev)
    if c_idx != 0:
        ff = torch.zeros_like(ff)
    top, left = top.to(I32), left.to(I32)
    ftop, fleft = ftop.to(I32), fleft.to(I32)

    ffb = ff[None, :, None]
    top_m = torch.where(ffb, ftop[:, None, :], top[:, None, :])   # (N,35,2n)
    left_m = torch.where(ffb, fleft[:, None, :], left[:, None, :])
    corner_m = torch.where(ff[None, :], fcorner[:, None],
                           corner[:, None]).to(I32)              # (N, 35)
    vb = is_vert[None, :, None]
    main = torch.where(vb, top_m, left_m)
    side = torch.where(vb, left_m, top_m)

    # ref[.., N + i] for i in -n..2n (+1 spare slot)
    npos = 3 * n + 2
    ref = torch.zeros((N, 35, npos), dtype=I32, device=dev)
    ref[:, :, n] = corner_m
    ref[:, :, n + 1:3 * n + 1] = main
    i_neg = torch.arange(-n, 0, device=dev, dtype=I32)
    j = ((i_neg[None, :] * inv_angle[:, None] + 128) >> 8) - 1     # (35, n)
    side_ext = torch.cat([corner_m[:, :, None], side], dim=-1)  # (N,35,2n+1)
    jj = (j + 1).clamp(0, 2 * n).to(torch.int64)
    neg_vals = torch.gather(side_ext, 2, jj[None].expand(N, -1, -1))
    use_neg = (angle < 0)[None, :, None]
    ref[:, :, :n] = torch.where(use_neg, neg_vals, ref[:, :, :n])

    # angular in vertical orientation: row y of mode m reads
    # ref[m, n + 1 + idx[m, y] + x] for x in 0..n
    x1 = torch.arange(n + 1, device=dev)
    pos = (n + 1 + idx.to(torch.int64))[:, :, None] + x1           # (35,n,n+1)
    sel = torch.gather(ref, 2, pos.reshape(1, 35, -1).expand(N, -1, -1))
    sel = sel.reshape(N, 35, n, n + 1)
    p0 = sel[..., :n]
    p1 = sel[..., 1:]
    f = fact[None, :, :, None]
    pred = ((32 - f) * p0 + f * p1 + 16) >> 5                      # (N,35,y,x)

    if c_idx == 0 and n < 32:
        maxv = (1 << bit_depth) - 1
        col = (main[:, :, 0:1] + ((side[:, :, :n] - corner[:, None, None])
                                  >> 1)).clamp(0, maxv)          # (N, 35, n)
        is_pure = (angle == 0)[None, :, None]
        pred[:, :, :, 0] = torch.where(is_pure, col, pred[:, :, :, 0])

    pred = torch.where(is_vert[None, :, None, None], pred,
                       pred.transpose(-1, -2))
    planar, dcb = _planar_dc(top, left, top_m[:, 0], left_m[:, 0], n, c_idx)
    pred = pred.clone()
    pred[:, 0] = planar
    pred[:, 1] = dcb
    return pred.to(I32)


def predict_one_mode(top, left, corner, ftop, fleft, fcorner, m, *,
                     size: int, c_idx: int, bit_depth: int = 8):
    """(N, n, n) int32 prediction for ONE decided mode per block, m (N,):
    the apply-pass twin of predict_all_modes (the reference's edge filter
    here reads the mode-selected corner)."""
    n = size
    dev = top.device
    N = top.shape[0]
    angle_t, inv_t, is_vert_t, ff_t, _, _ = _tabs(n, dev)
    m = m.to(torch.int64)
    angle = angle_t[m]                                             # (N,)
    inv_angle = inv_t[m]
    is_vert = is_vert_t[m]
    ff = ff_t[m] if c_idx == 0 else torch.zeros_like(is_vert)
    top, left = top.to(I32), left.to(I32)
    ftop, fleft = ftop.to(I32), fleft.to(I32)
    top_m = torch.where(ff[:, None], ftop, top)
    left_m = torch.where(ff[:, None], fleft, left)
    corner_m = torch.where(ff, fcorner, corner).to(I32)
    main = torch.where(is_vert[:, None], top_m, left_m)
    side = torch.where(is_vert[:, None], left_m, top_m)

    npos = 3 * n + 2
    ref = torch.zeros((N, npos), dtype=I32, device=dev)
    ref[:, n] = corner_m
    ref[:, n + 1:3 * n + 1] = main
    i_neg = torch.arange(-n, 0, device=dev, dtype=I32)
    j = ((i_neg[None, :] * inv_angle[:, None] + 128) >> 8) - 1     # (N, n)
    side_ext = torch.cat([corner_m[:, None], side], dim=-1)
    neg_vals = torch.gather(side_ext, 1,
                            (j + 1).clamp(0, 2 * n).to(torch.int64))
    ref[:, :n] = torch.where((angle < 0)[:, None], neg_vals, ref[:, :n])

    y = torch.arange(n, device=dev, dtype=I32)
    p = (y[None, :] + 1) * angle[:, None]                          # (N, n)
    idx = p >> 5
    fact = p & 31
    x1 = torch.arange(n + 1, device=dev)
    pos = (n + 1 + idx.to(torch.int64))[:, :, None] + x1           # (N,n,n+1)
    sel = torch.gather(ref, 1, pos.reshape(N, -1)).reshape(N, n, n + 1)
    p0 = sel[..., :n]
    p1 = sel[..., 1:]
    f = fact[:, :, None]
    pred = ((32 - f) * p0 + f * p1 + 16) >> 5

    if c_idx == 0 and n < 32:
        maxv = (1 << bit_depth) - 1
        col = (main[:, 0:1] + ((side[:, :n] - corner_m[:, None]) >> 1)
               ).clamp(0, maxv)
        pred[:, :, 0] = torch.where((angle == 0)[:, None], col,
                                    pred[:, :, 0])

    pred = torch.where(is_vert[:, None, None], pred, pred.transpose(-1, -2))
    planar, dcb = _planar_dc(top, left, top_m, left_m, n, c_idx)
    mm = m[:, None, None]
    return torch.where(mm == 0, planar,
                       torch.where(mm == 1, dcb, pred)).to(I32)
