"""Static HEVC constant tables (ITU-T H.265 spec values), and torch twins
of the two table functions the device code calls on tensors.

The port's own copy of homerhevc_tpu/tables.py: the numpy tables are new
objects of this module (device.const caches device copies by object, so no
table of another package may be mixed in). Equivalent in role to the C
reference's hmr_tables.c (scan pyramids, quant pyramids, z-order tables;
homer_lib/hmr_tables.c) but generated programmatically from the spec
definitions rather than transcribed.

All tables here are normative constants of ITU-T Rec. H.265:
  * transform matrices        — spec 8.6.4.2 (transMatrix)
  * scan orders               — spec 6.5.3/6.5.4/6.5.5
  * quantisation scales       — spec 8.6.3 (levelScale) + HM QUANT_SHIFT
  * intra prediction angles   — spec 8.4.4.2.6 (intraPredAngle/invAngle)
  * chroma QP mapping         — spec Table 8-10
  * last-coeff group tables   — spec 9.3.3.x (binarization of last_sig_coeff)
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .device import const, take

# ---------------------------------------------------------------------------
# Transform matrices (spec 8.6.4.2)
# ---------------------------------------------------------------------------

# First column of the 32-point integer DCT matrix, rows 1..31. Together with
# the DC value 64 this generates the full matrix: entry (i, j) equals
# +/- _DCT_ANGLE[m] for m = fold(i*(2j+1) mod 128) by cosine symmetry.
_DCT_ANGLE = np.array(
    [64, 90, 90, 90, 89, 88, 87, 85, 83, 82, 80, 78, 75, 73, 70, 67,
     64, 61, 57, 54, 50, 46, 43, 38, 36, 31, 25, 22, 18, 13, 9, 4],
    dtype=np.int32,
)


@functools.lru_cache(maxsize=None)
def dct_matrix(n: int) -> np.ndarray:
    """N-point HEVC integer DCT-II matrix (N in {4, 8, 16, 32}).

    Rows of the N-point matrix are subsampled rows of the 32-point matrix
    (spec 8.6.4.2: transMatrix[i << (5 - Log2(nTbS))][j]).
    """
    assert n in (4, 8, 16, 32)
    t = np.zeros((32, 32), dtype=np.int32)
    t[0, :] = 64
    j = np.arange(32)
    for i in range(1, 32):
        m = (i * (2 * j + 1)) % 128
        m = np.where(m > 64, 128 - m, m)          # cos(m) == cos(128 - m)
        sign = np.where(m > 32, -1, 1)            # cos(m) == -cos(64 - m)
        m = np.where(m > 32, 64 - m, m)
        t[i, :] = sign * _DCT_ANGLE[m]
    step = 32 // n
    return np.ascontiguousarray(t[::step, :n])


# DST-VII 4x4 for intra luma 4x4 TBs (spec 8.6.4.1, alternative transform).
DST4 = np.array(
    [[29, 55, 74, 84],
     [74, 74, 0, -74],
     [84, -29, -74, 55],
     [55, -84, 74, -29]],
    dtype=np.int32,
)


# ---------------------------------------------------------------------------
# Scan orders (spec 6.5.3 up-right diagonal, 6.5.4 horizontal, 6.5.5 vertical)
# ---------------------------------------------------------------------------

SCAN_DIAG, SCAN_HOR, SCAN_VER = 0, 1, 2


@functools.lru_cache(maxsize=None)
def scan_order(blk_size: int, scan_idx: int) -> np.ndarray:
    """(blk_size**2, 2) array of (x, y) positions in scan order."""
    pos = []
    if scan_idx == SCAN_DIAG:
        i, x, y = 0, 0, 0
        while i < blk_size * blk_size:
            while y >= 0:
                if x < blk_size and y < blk_size:
                    pos.append((x, y))
                    i += 1
                y -= 1
                x += 1
            y = x
            x = 0
    elif scan_idx == SCAN_HOR:
        for y in range(blk_size):
            for x in range(blk_size):
                pos.append((x, y))
    else:
        for x in range(blk_size):
            for y in range(blk_size):
                pos.append((x, y))
    return np.array(pos, dtype=np.int32)


@functools.lru_cache(maxsize=None)
def coeff_scan(log2_size: int, scan_idx: int) -> np.ndarray:
    """Full-TB coefficient scan as flat raster indices, in scan order.

    HEVC scans transform blocks as 4x4 coefficient sub-blocks: the sub-blocks
    follow `scan_idx` order at sub-block granularity and coefficients within a
    sub-block follow the same order (spec 7.3.8.11 residual_coding).
    For 4x4 TBs there is a single sub-block.
    """
    size = 1 << log2_size
    if size == 4:
        sub = scan_order(4, scan_idx)
        return (sub[:, 1] * size + sub[:, 0]).astype(np.int32)
    nsb = size // 4
    sb = scan_order(nsb, scan_idx)
    inner = scan_order(4, scan_idx)
    out = np.zeros(size * size, dtype=np.int32)
    k = 0
    for sx, sy in sb:
        for ix, iy in inner:
            x = sx * 4 + ix
            y = sy * 4 + iy
            out[k] = y * size + x
            k += 1
    return out


def scan_mode_for_intra(log2_size: int, pred_mode: int, c_idx: int) -> int:
    """Scan selection for intra blocks (spec 7.4.9.11).

    Vertical scan for near-horizontal modes 6..14, horizontal scan for
    near-vertical modes 22..30; only for 4x4 and (luma) 8x8 TBs.
    """
    if log2_size == 2 or (log2_size == 3 and c_idx == 0):
        if 6 <= pred_mode <= 14:
            return SCAN_VER
        if 22 <= pred_mode <= 30:
            return SCAN_HOR
    return SCAN_DIAG


# ---------------------------------------------------------------------------
# Quantisation (spec 8.6.3 + HM forward-quant convention)
# ---------------------------------------------------------------------------

# Forward quantiser scales, indexed by QP % 6 (HM g_quantScales).
QUANT_SCALES = np.array([26214, 23302, 20560, 18396, 16384, 14564], dtype=np.int32)
# Inverse quantiser scales = spec levelScale[] (8.6.3).
INV_QUANT_SCALES = np.array([40, 45, 51, 57, 64, 72], dtype=np.int32)

QUANT_SHIFT = 14
MAX_TR_DYNAMIC_RANGE = 15


def fwd_transform_shifts(log2_size: int, bit_depth: int = 8) -> tuple[int, int]:
    """(stage1, stage2) right-shifts of the forward transform (HM schedule)."""
    s1 = log2_size + bit_depth - 9
    s2 = log2_size + 6
    return s1, s2


def inv_transform_shifts(bit_depth: int = 8) -> tuple[int, int]:
    return 7, 20 - bit_depth


# ---------------------------------------------------------------------------
# Intra prediction angles (spec 8.4.4.2.6)
# ---------------------------------------------------------------------------

# intraPredAngle for modes 2..34 (index by mode).
INTRA_PRED_ANGLE = np.zeros(35, dtype=np.int32)
INTRA_PRED_ANGLE[2:35] = [32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13,
                          -17, -21, -26, -32, -26, -21, -17, -13, -9, -5, -2,
                          0, 2, 5, 9, 13, 17, 21, 26, 32]

# invAngle = round(8192 / intraPredAngle) for modes 11..25 (negative angles).
INV_ANGLE = np.zeros(35, dtype=np.int32)
INV_ANGLE[11:26] = [-4096, -1638, -910, -630, -482, -390, -315, -256, -315,
                    -390, -482, -630, -910, -1638, -4096]


# ---------------------------------------------------------------------------
# Chroma QP mapping (spec Table 8-10, 4:2:0)
# ---------------------------------------------------------------------------

CHROMA_QP_TABLE = np.array([29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36,
                            37, 37], dtype=np.int32)


def chroma_qp_from_luma(qp_i, xp=np):
    """Works on python ints and numpy arrays (`chroma_qp_t` for tensors)."""
    if xp is np:
        qp_i = np.asarray(qp_i)
    out = xp.where(qp_i < 30, qp_i,
                   xp.where(qp_i > 43, qp_i - 6,
                            xp.asarray(CHROMA_QP_TABLE)[
                                xp.clip(qp_i, 30, 43) - 30]))
    if xp is np and out.ndim == 0:
        return int(out)
    return out


# Structure-aware TB bit-cost constants (calibrated against the native
# CABAC bit probe on 720p IPPP content; see tools/rd_calib.py). The old
# flat 3-bits-per-nonzero proxy ignored WHERE coefficients sit: a lone
# level-1 deep in a 32x32 TB really costs last_sig_xy + a run of
# coded_sub_block_flags + 16 sig bins (~40-90 bits), which made rd_zero
# keep scattered one-coefficient TBs that the reference's counter-priced
# RD (hmr_binary_encoding.c:306-551) rejects — measured 52% of our P bits
# were significance flags before this term existed.
TB_BITS_PER_SUBBLOCK = 14     # csbf + ~16 part-adapted sig bins
TB_BITS_PER_SB_DIST = 6       # csbf run + last_sig_xy growth per diagonal
TB_BITS_OVERHEAD = 16         # cbf + last_sig_xy base


def level_bits_est(levels, xp=np, axes=(-1, -2)):
    """Integer CABAC-bit estimate for a quantized TB (role of the
    reference's EE/EC counter duality for RD costing,
    hmr_binary_encoding.c:306-551 — a closed-form proxy instead of running
    the context counter per candidate):

      3*nonzeros + 2*magnitude-doublings            (level/sign/gt1 bins)
      + TB_BITS_PER_SUBBLOCK per coded 4x4 subblock (csbf + sig bins)
      + TB_BITS_PER_SB_DIST * diagonal of the furthest coded subblock
                                                    (csbf run + last_xy)
      + TB_BITS_OVERHEAD                            (cbf + last_xy base)

    Pure integer, so numpy and the torch twin `level_bits_est_t` agree
    bit-exactly.
    Requires the TB on the last two axes (axes must be (-1, -2)).
    """
    assert tuple(axes) == (-1, -2)
    a = xp.abs(levels)
    nz = (a > 0).astype(xp.int32)
    bl = xp.zeros_like(nz)
    for k in range(1, 15):
        bl = bl + ((a >> k) > 0).astype(xp.int32)
    base = (3 * nz + 2 * bl).sum(axis=axes)
    n_r, n_c = levels.shape[-2], levels.shape[-1]
    if n_r >= 8 and n_c >= 8:
        tiles = nz.reshape(nz.shape[:-2] + (n_r // 4, 4, n_c // 4, 4))
        csb = (tiles.sum(axis=(-3, -1)) > 0).astype(xp.int32)
        n_sb = csb.sum(axis=axes)
        di = np.arange(n_r // 4, dtype=np.int32)[:, None]
        dj = np.arange(n_c // 4, dtype=np.int32)[None, :]
        diag = xp.asarray(di + dj)
        dist = (csb * diag).max(axis=axes)
        sb_bits = TB_BITS_PER_SUBBLOCK * n_sb + TB_BITS_PER_SB_DIST * dist
    else:
        sb_bits = 0
    return base + sb_bits + TB_BITS_OVERHEAD


# RD lambda (HM formula 0.57 * 2^((qp-12)/3)) in x256 fixed point, and its
# sqrt (SAD-domain ME lambda) — indexed by QP so traced-QP device code can
# gather instead of recompiling per QP.
LAMBDA_FX = np.array([int(round(0.57 * 2.0 ** ((q - 12) / 3.0) * 256))
                      for q in range(52)], dtype=np.int32)
LAMBDA_ME_FX = np.array(
    [int(round((0.57 * 2.0 ** ((q - 12) / 3.0)) ** 0.5 * 256))
     for q in range(52)], dtype=np.int32)

# Inter (P-slice) lambdas: HM scales the non-I-slice lambda up (weighting
# W_k for referenced pictures); measured on 720p clips, x2 moves the P RD
# point from (7.7 KB, 31.24 dB) to (5.0 KB, 31.03 dB) per frame — a large
# net win toward the reference's operating point. ME lambda scales by
# sqrt(2) (SAD domain).
P_LAMBDA_SCALE = 2
LAMBDA_FX_P = (LAMBDA_FX * P_LAMBDA_SCALE).astype(np.int32)
LAMBDA_ME_FX_P = np.array(
    [int(round((P_LAMBDA_SCALE * 0.57 * 2.0 ** ((q - 12) / 3.0)) ** 0.5
               * 256)) for q in range(52)], dtype=np.int32)


# ---------------------------------------------------------------------------
# Deblocking filter thresholds (spec Table 8-12)
# ---------------------------------------------------------------------------

# beta' indexed by Q = Clip3(0, 51, qpL + beta_offset).
DEBLOCK_BETA = np.array(
    [0] * 16 +
    [6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24,
     26, 28, 30, 32, 34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56,
     58, 60, 62, 64], dtype=np.int32)

# tc' indexed by Q = Clip3(0, 53, qpL + 2*(bS-1) + tc_offset).
DEBLOCK_TC = np.array(
    [0] * 18 +
    [1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4,
     5, 5, 6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24],
    dtype=np.int32)


# ---------------------------------------------------------------------------
# last_sig_coeff binarization tables (spec 9.3.3.x; HM g_uiGroupIdx/g_uiMinInGroup)
# ---------------------------------------------------------------------------

GROUP_IDX = np.array([0, 1, 2, 3, 4, 4, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7,
                      8, 8, 8, 8, 8, 8, 8, 8, 9, 9, 9, 9, 9, 9, 9, 9],
                     dtype=np.int32)
MIN_IN_GROUP = np.array([0, 1, 2, 3, 4, 6, 8, 12, 16, 24], dtype=np.int32)


# ---------------------------------------------------------------------------
# Z-order (z-scan <-> raster) inside a CTU at 4x4 granularity
# (role of create_abs2raster_tables / create_raster2abs_tables,
#  hmr_tables.c:274-313)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def zscan_to_raster(log2_ctu_in_units: int) -> np.ndarray:
    """Map z-scan index -> raster index for a 2^n x 2^n grid of units."""
    n = 1 << log2_ctu_in_units
    out = np.zeros(n * n, dtype=np.int32)

    def fill(z, x, y, size):
        if size == 1:
            out[z] = y * n + x
            return z + 1
        h = size // 2
        z = fill(z, x, y, h)
        z = fill(z, x + h, y, h)
        z = fill(z, x, y + h, h)
        z = fill(z, x + h, y + h, h)
        return z

    fill(0, 0, 0, n)
    return out


@functools.lru_cache(maxsize=None)
def raster_to_zscan(log2_ctu_in_units: int) -> np.ndarray:
    z2r = zscan_to_raster(log2_ctu_in_units)
    out = np.zeros_like(z2r)
    out[z2r] = np.arange(len(z2r), dtype=np.int32)
    return out


# ---------------------------------------------------------------------------
# torch twins of chroma_qp_from_luma and level_bits_est (whose `xp=` form
# calls numpy-only methods)
# ---------------------------------------------------------------------------

def chroma_qp_t(qp: torch.Tensor) -> torch.Tensor:
    """Torch twin of tables.chroma_qp_from_luma (spec Table 8-10)."""
    t = const(CHROMA_QP_TABLE, qp.device)
    return torch.where(qp < 30, qp,
                       torch.where(qp > 43, qp - 6,
                                   take(t, qp.clamp(30, 43) - 30)))


@functools.lru_cache(maxsize=None)
def _diag(h: int, w: int) -> np.ndarray:
    return (np.arange(h)[:, None] + np.arange(w)[None, :]).astype(np.int64)


def level_bits_est_t(levels: torch.Tensor) -> torch.Tensor:
    """Torch twin of tables.level_bits_est: integer CABAC-bit estimate of
    each TB on the last two axes. Returns int64 (values fit int32)."""
    a = levels.abs()
    nz = (a > 0).to(torch.int64)
    bl = torch.zeros_like(nz)
    for k in range(1, 15):
        bl = bl + ((a >> k) > 0).to(torch.int64)
    base = (3 * nz + 2 * bl).sum(dim=(-1, -2))
    n_r, n_c = levels.shape[-2], levels.shape[-1]
    if n_r >= 8 and n_c >= 8:
        tiles = nz.reshape(nz.shape[:-2] + (n_r // 4, 4, n_c // 4, 4))
        csb = (tiles.sum(dim=(-3, -1)) > 0).to(torch.int64)
        n_sb = csb.sum(dim=(-1, -2))
        diag = const(_diag(n_r // 4, n_c // 4), levels.device)
        dist = (csb * diag).amax(dim=(-1, -2))
        sb_bits = TB_BITS_PER_SUBBLOCK * n_sb + TB_BITS_PER_SB_DIST * dist
    else:
        sb_bits = 0
    return base + sb_bits + TB_BITS_OVERHEAD
