"""Prediction and residual reconstruction (H.265 8.4.4.2, 8.5.3.3,
8.6.2 to 8.6.4) for 8-bit 4:2:0."""

from __future__ import annotations

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

# --------------------------------------------------------------- transform
# cos(j * pi / 64) of the integer core transform, j = 0..32 (8.6.4.2's
# transMatrix, written by the angle of each entry)
_COS = {0: 64, 16: 64, 8: 83, 24: 36, 32: 0}
for _j, _v in zip(range(4, 32, 8), (89, 75, 50, 18)):
    _COS[_j] = _v
for _j, _v in zip(range(2, 32, 4), (90, 87, 80, 70, 57, 43, 25, 9)):
    _COS[_j] = _v
for _j, _v in zip(range(1, 32, 2), (90, 90, 88, 85, 82, 78, 73, 67, 61, 54,
                                   46, 38, 31, 22, 13, 4)):
    _COS[_j] = _v


def _cos(j: int) -> int:
    j %= 128
    if j > 64:
        j = 128 - j
    return _COS[j] if j <= 32 else -_COS[64 - j]


def dct_matrix(n: int) -> np.ndarray:
    """transMatrix for nTbS = n: row k holds basis function k."""
    step = 32 // n
    return np.array([[_cos((2 * i + 1) * k * step) for i in range(n)]
                     for k in range(n)], dtype=np.int64)


DCT = {n: dct_matrix(n) for n in (4, 8, 16, 32)}
DST4 = np.array([[29, 55, 74, 84], [74, 74, 0, -74], [84, -29, -74, 55],
                 [55, -84, 74, -29]], dtype=np.int64)
LEVEL_SCALE = np.array([40, 45, 51, 57, 64, 72], dtype=np.int64)
CHROMA_QP = [29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37]


def chroma_qp(qpi: int) -> int:
    """QpC of index qPi for 4:2:0 (Table 8-10)."""
    if qpi < 30:
        return qpi
    if qpi > 43:
        return qpi - 6
    return CHROMA_QP[qpi - 30]


def residuals(levels: np.ndarray, qps: np.ndarray, dst: bool) -> np.ndarray:
    """Scaling (flat lists) and the inverse transform of N blocks of one
    size: levels (N, n, n) [y][x] int, qps (N,) -> residuals (N, n, n)."""
    n = levels.shape[-1]
    log2n = n.bit_length() - 1
    bd_shift = 8 + log2n - 5
    scale = (LEVEL_SCALE[qps % 6] << (qps // 6)) * 16
    d = (levels.astype(np.int64) * scale[:, None, None]
         + (1 << (bd_shift - 1))) >> bd_shift
    d = np.clip(d, -32768, 32767)
    m = DST4 if dst else DCT[n]
    e = np.matmul(m.T[None], d)                     # columns
    g = np.clip((e + 64) >> 7, -32768, 32767)
    r = np.matmul(g, m[None])                       # rows
    return (r + 2048) >> 12


# -------------------------------------------------------- inter prediction
LUMA_TAPS = np.array([[0, 0, 0, 64, 0, 0, 0, 0],
                      [-1, 4, -10, 58, 17, -5, 1, 0],
                      [-1, 4, -11, 40, 40, -11, 4, -1],
                      [0, 1, -5, 17, 58, -10, 4, -1]], dtype=np.int64)
CHROMA_TAPS = np.array([[0, 64, 0, 0], [-2, 58, 10, -2], [-4, 54, 16, -2],
                        [-6, 46, 28, -4], [-4, 36, 36, -4], [-4, 28, 46, -6],
                        [-2, 16, 54, -4], [-2, 10, 58, -2]], dtype=np.int64)


def motion_compensate(ref: np.ndarray, xs, ys, n: int, mvx, mvy,
                      chroma: bool) -> np.ndarray:
    """Uni-prediction of N blocks n x n at (xs, ys) of one reference plane
    (8.5.3.3.3, default weighting): samples (N, n, n) uint8. Motion vectors
    in quarter luma samples (eighth chroma samples for chroma); reference
    samples outside the plane repeat its edge."""
    H, W = ref.shape
    taps = CHROMA_TAPS if chroma else LUMA_TAPS
    t = taps.shape[1]
    before = t // 2 - 1
    shift = 3 if chroma else 2
    frac = (1 << shift) - 1
    xs, ys = np.asarray(xs), np.asarray(ys)
    mvx, mvy = np.asarray(mvx), np.asarray(mvy)
    x0 = xs + (mvx >> shift) - before
    y0 = ys + (mvy >> shift) - before
    span = np.arange(n + t - 1)
    rows = np.clip(y0[:, None] + span, 0, H - 1)
    cols = np.clip(x0[:, None] + span, 0, W - 1)
    win = ref[rows[:, :, None], cols[:, None, :]].astype(np.int64)
    fx = taps[mvx & frac]                                  # (N, t)
    fy = taps[mvy & frac]
    h = np.einsum("nyxk,nk->nyx", sliding_window_view(win, t, axis=2), fx)
    v = np.einsum("nyxk,nk->nyx", sliding_window_view(h, t, axis=1), fy)
    return np.clip(((v >> 6) + 32) >> 6, 0, 255).astype(np.uint8)


# -------------------------------------------------------- intra prediction
ANGLE = [0, 0, 32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21,
         -26, -32, -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9, 13, 17, 21,
         26, 32]
INV_ANGLE = {11: -4096, 12: -1638, 13: -910, 14: -630, 15: -482, 16: -390,
             17: -315, 18: -256, 19: -315, 20: -390, 21: -482, 22: -630,
             23: -910, 24: -1638, 25: -4096}


def reference_samples(plane, avail_fn, x0: int, y0: int, n: int):
    """p[-1][-1..2n-1] (left, from the corner down) and p[-1..2n-1][-1]
    (top, from the corner right) with substitution (8.4.4.2.2). Returns
    (left, top) int64 arrays of 2n+1 samples each, both starting at the
    corner p[-1][-1]."""
    H, W = plane.shape
    # one sample order: bottom-left up to the corner, then right along top
    xs = np.concatenate([np.full(2 * n, x0 - 1), [x0 - 1],
                         x0 + np.arange(2 * n)])
    ys = np.concatenate([y0 + np.arange(2 * n - 1, -1, -1), [y0 - 1],
                         np.full(2 * n, y0 - 1)])
    ok = (xs >= 0) & (ys >= 0) & (xs < W) & (ys < H)
    ok[ok] = avail_fn(xs[ok], ys[ok])
    vals = np.full(4 * n + 1, 128, dtype=np.int64)
    if ok.any():
        vals[ok] = plane[ys[ok], xs[ok]]
        if not ok[0]:
            vals[0] = vals[np.argmax(ok)]
            ok[0] = True
        # every missing sample takes the one before it in this order
        idx = np.where(ok, np.arange(len(ok)), 0)
        np.maximum.accumulate(idx, out=idx)
        vals = vals[idx]
    left = vals[2 * n::-1]          # corner, then down: p[-1][-1..2n-1]
    top = vals[2 * n:]              # corner, then right
    return left, top


def filter_references(left, top, n: int, mode: int, luma: bool,
                      strong: bool):
    """8.4.4.2.3: [1 2 1] smoothing or the strong bilinear one."""
    if not luma or mode == 1 or n == 4:
        return left, top
    dist = min(abs(mode - 26), abs(mode - 10))
    if dist <= {8: 7, 16: 1, 32: 0}[n]:
        return left, top
    c = left[0]
    if (strong and n == 32
            and abs(c + top[2 * n] - 2 * top[n]) < 8
            and abs(c + left[2 * n] - 2 * left[n]) < 8):
        i = np.arange(1, 2 * n)
        nl, nt = left.copy(), top.copy()
        nl[1:2 * n] = ((64 - i) * c + i * left[2 * n] + 32) >> 6
        nt[1:2 * n] = ((64 - i) * c + i * top[2 * n] + 32) >> 6
        return nl, nt
    nl, nt = left.copy(), top.copy()
    nl[0] = nt[0] = (left[1] + 2 * c + top[1] + 2) >> 2
    nl[1:2 * n] = (left[:2 * n - 1] + 2 * left[1:2 * n] + left[2:] + 2) >> 2
    nt[1:2 * n] = (top[:2 * n - 1] + 2 * top[1:2 * n] + top[2:] + 2) >> 2
    return nl, nt


def intra_predict(left, top, n: int, mode: int, luma: bool) -> np.ndarray:
    """Prediction samples (n, n) [y][x] from the (filtered) references:
    left[0] = top[0] = p[-1][-1], left[1 + y] = p[-1][y], top[1 + x] =
    p[x][-1]."""
    y = np.arange(n)[:, None]
    x = np.arange(n)[None, :]
    if mode == 0:                                           # planar
        s = n.bit_length() - 1
        return ((n - 1 - x) * left[1 + y] + (x + 1) * top[1 + n]
                + (n - 1 - y) * top[1 + x] + (y + 1) * left[1 + n]
                + n) >> (s + 1)
    if mode == 1:                                           # DC
        s = n.bit_length() - 1
        dc = (int(top[1:n + 1].sum()) + int(left[1:n + 1].sum()) + n) \
            >> (s + 1)
        out = np.full((n, n), dc, dtype=np.int64)
        if luma and n < 32:
            out[0, 0] = (left[1] + 2 * dc + top[1] + 2) >> 2
            out[0, 1:] = (top[2:n + 1] + 3 * dc + 2) >> 2
            out[1:, 0] = (left[2:n + 1] + 3 * dc + 2) >> 2
        return out
    angle = ANGLE[mode]
    vertical = mode >= 18
    main, side = (top, left) if vertical else (left, top)
    # ref[k] for k = -n..2n, stored at ref[k + n]
    ref = np.zeros(3 * n + 1, dtype=np.int64)
    ref[n:2 * n + 1] = main[:n + 1]
    if angle < 0:
        last = (n * angle) >> 5
        if last < -1:
            k = np.arange(last, 0)
            ref[k + n] = side[((k * INV_ANGLE[mode] + 128) >> 8)]
    else:
        ref[2 * n + 1:] = main[n + 1:2 * n + 1]
    pos = (np.arange(1, n + 1) * angle)          # along the side axis
    idx, fact = pos >> 5, pos & 31
    along = np.arange(n)
    # out_t[i][j]: i along the side axis (y for vertical), j along main
    a = ref[(along[None, :] + idx[:, None] + 1) + n]
    b = ref[(along[None, :] + idx[:, None] + 2).clip(max=2 * n) + n]
    f = fact[:, None]
    out_t = np.where(f == 0, a, ((32 - f) * a + f * b + 16) >> 5)
    if luma and n < 32 and angle == 0:
        # 8.4.4.2.6: the edge filter of pure vertical / horizontal
        c = left[0]
        out_t[:, 0] = np.clip(main[1] + ((side[1:n + 1] - c) >> 1), 0, 255)
    return out_t if vertical else out_t.T


def scan_index(log2: int, c_idx: int, intra: bool, mode: int) -> int:
    """scanIdx (7.4.9.11): 0 diagonal, 1 horizontal, 2 vertical."""
    if intra and (log2 == 2 or (log2 == 3 and c_idx == 0)):
        if 6 <= mode <= 14:
            return 2
        if 22 <= mode <= 30:
            return 1
    return 0


def scan_order(size: int, scan: int) -> list:
    """(x, y) positions of a size x size array in scan order (6.5.3-6.5.5)."""
    if scan == 1:
        return [(x, y) for y in range(size) for x in range(size)]
    if scan == 2:
        return [(x, y) for x in range(size) for y in range(size)]
    out = []
    x = y = 0
    while len(out) < size * size:
        while y >= 0:
            if x < size and y < size:
                out.append((x, y))
            y -= 1
            x += 1
        y, x = x, 0
    return out


SCANS = {(s, k): scan_order(s, k) for s in (1, 2, 4, 8) for k in (0, 1, 2)}
