"""In-loop filters: deblocking (H.265 8.7.2) and SAO (8.7.3), 8-bit
4:2:0, over whole pictures at once."""

from __future__ import annotations

import numpy as np

from .predict import chroma_qp

BETA = [0] * 16 + [6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22,
                   24, 26, 28, 30, 32, 34, 36, 38, 40, 42, 44, 46, 48, 50,
                   52, 54, 56, 58, 60, 62, 64]
TC = [0] * 18 + [1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4,
                 5, 5, 6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24]
_BETA = np.array(BETA)
_TC = np.array(TC)


def _edges(maps, c: int):
    """Boundary strength of the vertical edge left of unit column c, per
    unit row: 2 intra, 1 coefficients or motion, 0 none or no edge."""
    tu, intra, nz, mv = maps["tu"], maps["intra"], maps["nz"], maps["mv"]
    edge = tu[:, c - 1] != tu[:, c]
    moved = np.abs(mv[:, c - 1] - mv[:, c]).max(axis=1) >= 4
    bs = np.where(intra[:, c - 1] | intra[:, c], 2,
                  np.where(nz[:, c - 1] | nz[:, c] | moved, 1, 0))
    return np.where(edge, bs, 0)


def _luma_edges(y, maps, beta_off: int, tc_off: int) -> None:
    """Filter every vertical luma edge of plane `y` (in place; int64)."""
    H4, W4 = maps["tu"].shape
    qp = maps["qp"]
    segs = []
    for c in range(2, W4, 2):
        bs = _edges(maps, c)
        j = np.nonzero(bs)[0]
        if j.size:
            segs.append((np.full(j.size, c), j, bs[j]))
    if not segs:
        return
    c, j, bs = (np.concatenate(a) for a in zip(*segs))
    qpl = (qp[j, c - 1] + qp[j, c] + 1) >> 1
    beta = _BETA[np.clip(qpl + 2 * beta_off, 0, 51)][:, None]
    tc = _TC[np.clip(qpl + 2 * (bs - 1) + 2 * tc_off, 0, 53)][:, None]
    rows = 4 * j[:, None] + np.arange(4)                    # (N, 4)
    cols = 4 * c[:, None] - 4 + np.arange(8)                # (N, 8)
    s = y[rows[:, :, None], cols[:, None, :]]               # (N, 4, 8)
    p3, p2, p1, p0, q0, q1, q2, q3 = (s[:, :, i] for i in range(8))
    dp = np.abs(p2 - 2 * p1 + p0)
    dq = np.abs(q2 - 2 * q1 + q0)
    dpq = dp + dq
    d = dpq[:, 0] + dpq[:, 3]
    on = (d < beta[:, 0])[:, None]

    def sam(k):
        return ((2 * dpq[:, k] < (beta[:, 0] >> 2))
                & (np.abs(p3[:, k] - p0[:, k]) + np.abs(q0[:, k] - q3[:, k])
                   < (beta[:, 0] >> 3))
                & (np.abs(p0[:, k] - q0[:, k]) < ((5 * tc[:, 0] + 1) >> 1)))

    strong = (sam(0) & sam(3))[:, None] & on
    side = (beta + (beta >> 1)) >> 3
    dep = (dp[:, 0] + dp[:, 3])[:, None] < side
    deq = (dq[:, 0] + dq[:, 3])[:, None] < side
    t2 = 2 * tc
    out = s.copy()
    sp = [np.clip((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                  p0 - t2, p0 + t2),
          np.clip((p2 + p1 + p0 + q0 + 2) >> 2, p1 - t2, p1 + t2),
          np.clip((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2 - t2,
                  p2 + t2)]
    sq = [np.clip((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3, q0 - t2,
                  q0 + t2),
          np.clip((p0 + q0 + q1 + q2 + 2) >> 2, q1 - t2, q1 + t2),
          np.clip((p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3, q2 - t2,
                  q2 + t2)]
    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    weak = on & ~strong & (np.abs(delta) < tc * 10)
    delta = np.clip(delta, -tc, tc)
    th = tc >> 1
    dpp = np.clip((((p2 + p0 + 1) >> 1) - p1 + delta) >> 1, -th, th)
    dqq = np.clip((((q2 + q0 + 1) >> 1) - q1 - delta) >> 1, -th, th)
    wp = [np.clip(p0 + delta, 0, 255), np.clip(p1 + dpp, 0, 255)]
    wq = [np.clip(q0 - delta, 0, 255), np.clip(q1 + dqq, 0, 255)]
    for i in range(3):                       # p_i at column 3 - i
        out[:, :, 3 - i] = np.where(strong, sp[i], out[:, :, 3 - i])
        out[:, :, 4 + i] = np.where(strong, sq[i], out[:, :, 4 + i])
    out[:, :, 3] = np.where(weak, wp[0], out[:, :, 3])
    out[:, :, 4] = np.where(weak, wq[0], out[:, :, 4])
    out[:, :, 2] = np.where(weak & dep, wp[1], out[:, :, 2])
    out[:, :, 5] = np.where(weak & deq, wq[1], out[:, :, 5])
    y[rows[:, :, None], cols[:, None, :]] = out


def _chroma_edges(u, maps, qp_offset: int, tc_off: int) -> None:
    """Filter every vertical chroma edge (bS 2, on the chroma 8-grid) of
    plane `u` (in place; int64)."""
    H4, W4 = maps["tu"].shape
    qp = maps["qp"]
    segs = []
    for c in range(4, W4, 4):
        bs = _edges(maps, c)
        j = np.nonzero(bs == 2)[0]
        if j.size:
            segs.append((np.full(j.size, c), j))
    if not segs:
        return
    c, j = (np.concatenate(a) for a in zip(*segs))
    qpi = ((qp[j, c - 1] + qp[j, c] + 1) >> 1) + qp_offset
    qpc = np.array([chroma_qp(int(q)) for q in qpi])
    tc = _TC[np.clip(qpc + 2 + 2 * tc_off, 0, 53)][:, None]
    rows = 2 * j[:, None] + np.arange(2)          # two chroma lines per unit
    cols = 2 * c[:, None] - 2 + np.arange(4)
    s = u[rows[:, :, None], cols[:, None, :]]
    p1, p0, q0, q1 = (s[:, :, i] for i in range(4))
    delta = np.clip((((q0 - p0) << 2) + p1 - q1 + 4) >> 3, -tc, tc)
    s[:, :, 1] = np.clip(p0 + delta, 0, 255)
    s[:, :, 2] = np.clip(q0 - delta, 0, 255)
    u[rows[:, :, None], cols[:, None, :]] = s


def deblock(planes, maps, *, beta_off: int, tc_off: int, cb_offset: int,
            cr_offset: int):
    """Deblocked copies of (Y, U, V): vertical edges of the whole picture,
    then horizontal ones. `maps` hold per 4x4 luma unit: tu (transform
    block id), intra, nz (the luma block has coefficients), mv (H4, W4, 2)
    and qp (QpY)."""
    y, u, v = (p.astype(np.int64) for p in planes)
    t = {k: (m.transpose(1, 0, 2) if m.ndim == 3 else m.T)
         for k, m in maps.items()}
    for mp, planes_t in ((maps, (y, u, v)), (t, (y.T, u.T, v.T))):
        _luma_edges(planes_t[0], mp, beta_off, tc_off)
        _chroma_edges(planes_t[1], mp, cb_offset, tc_off)
        _chroma_edges(planes_t[2], mp, cr_offset, tc_off)
    return y, u, v


# EO neighbour offsets (dx, dy) of each class: the pair a and b
_EO = {0: ((-1, 0), (1, 0)), 1: ((0, -1), (0, 1)), 2: ((-1, -1), (1, 1)),
       3: ((1, -1), (-1, 1))}


def _shifted(p, dx, dy):
    """p[y + dy, x + dx], and whether that sample is inside the picture."""
    H, W = p.shape
    out = np.zeros_like(p)
    ok = np.zeros(p.shape, dtype=bool)
    ys = slice(max(0, -dy), H - max(0, dy))
    xs = slice(max(0, -dx), W - max(0, dx))
    ys2 = slice(max(0, dy), H - max(0, -dy))
    xs2 = slice(max(0, dx), W - max(0, -dx))
    out[ys, xs] = p[ys2, xs2]
    ok[ys, xs] = True
    return out, ok


def sao_plane(p, ctb: int, typ, offsets, band, eo_class):
    """SAO of one deblocked plane (int64) with per-CTB parameters: typ
    (R, C) 0 none / 1 band / 2 edge, offsets (R, C, 4), band (R, C), eo
    class (R, C); `ctb` in this plane's samples."""
    H, W = p.shape
    R, C = typ.shape
    if not typ.any():
        return p
    cy = np.minimum(np.arange(H) // ctb, R - 1)
    cx = np.minimum(np.arange(W) // ctb, C - 1)
    ctb_of = cy[:, None] * C + cx[None, :]              # CTB of each sample
    t = typ.ravel()[ctb_of]
    table = np.zeros((R * C, 5), dtype=np.int16)
    table[:, 1:] = offsets.reshape(R * C, 4)
    s = p.astype(np.int16)
    idx = np.zeros((H, W), dtype=np.int16)
    if (typ == 1).any():
        rel = ((s >> 3) - band.ravel()[ctb_of]) & 31
        idx = np.where((t == 1) & (rel < 4), rel + 1, idx).astype(np.int16)
    if (typ == 2).any():
        cls = eo_class.ravel()[ctb_of]
        for c, ((ax, ay), (bx, by)) in _EO.items():
            sel = (t == 2) & (cls == c)
            if not sel.any():
                continue
            a, oka = _shifted(s, ax, ay)
            b, okb = _shifted(s, bx, by)
            e = 2 + np.sign(s - a) + np.sign(s - b)
            e = np.where(e == 2, 0, np.where(e < 2, e + 1, e))
            idx = np.where(sel & oka & okb, e, idx).astype(np.int16)
    val = table.ravel()[ctb_of * 5 + idx]
    return np.clip(p + val, 0, 255)
