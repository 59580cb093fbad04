"""HEVC fractional-sample interpolation filter taps (spec 8.5.3.3.3).

The port's own copy of the two tap tables of homerhevc_tpu/ops/interp.py;
the filtering itself is batched torch code in pipeline/p_torch.py.
"""

from __future__ import annotations

import numpy as np

# Luma fractional-sample filters fL[frac][i], frac = 0..3 (spec Table 8-11).
LUMA_FILTERS = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1],
], dtype=np.int32)

# Chroma filters fC[frac][i], frac = 0..7 (spec Table 8-13).
CHROMA_FILTERS = np.array([
    [0, 64, 0, 0],
    [-2, 58, 10, -2],
    [-4, 54, 16, -2],
    [-6, 46, 28, -4],
    [-4, 36, 36, -4],
    [-4, 28, 46, -6],
    [-2, 16, 54, -4],
    [-2, 10, 58, -2],
], dtype=np.int32)
