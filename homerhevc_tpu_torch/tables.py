"""Spec constant tables: the reference's numpy tables, shared as they are,
plus torch twins of the two table functions whose `xp=` form calls
numpy-only methods (chroma_qp_from_luma, level_bits_est)."""

from __future__ import annotations

import functools

import numpy as np
import torch

from homerhevc_tpu.tables import (  # noqa: F401  (re-exported)
    CHROMA_QP_TABLE, DEBLOCK_BETA, DEBLOCK_TC, DST4, INTRA_PRED_ANGLE,
    INV_ANGLE, INV_QUANT_SCALES, LAMBDA_FX, LAMBDA_FX_P, LAMBDA_ME_FX_P,
    MAX_TR_DYNAMIC_RANGE, QUANT_SCALES, QUANT_SHIFT, TB_BITS_OVERHEAD,
    TB_BITS_PER_SB_DIST, TB_BITS_PER_SUBBLOCK, chroma_qp_from_luma,
    coeff_scan, dct_matrix, fwd_transform_shifts, inv_transform_shifts)

from .device import const


def chroma_qp_t(qp: torch.Tensor) -> torch.Tensor:
    """Torch twin of tables.chroma_qp_from_luma (spec Table 8-10)."""
    t = const(CHROMA_QP_TABLE, qp.device)
    return torch.where(qp < 30, qp,
                       torch.where(qp > 43, qp - 6,
                                   t[qp.clamp(30, 43) - 30]))


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
