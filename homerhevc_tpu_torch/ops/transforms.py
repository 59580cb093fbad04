"""Integer transforms (HM forward schedule; spec 8.6.4 inverse), exact.

Port of homerhevc_tpu/ops/transforms.py. CUDA has no integer matmul in
torch, so both stages run as float64 matmuls: every operand is an integer
and every partial sum stays far below 2^53 (a 32x32 stage-2 partial sum
reaches ~1.3e8), so the products and sums are exact in any order. float32
(or TF32) would not be: 1.3e8 > 2^24.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import tables
from ..device import const


@functools.lru_cache(maxsize=None)
def _t_np(n: int, is_dst: bool) -> np.ndarray:
    m = tables.DST4 if is_dst else tables.dct_matrix(n)
    return np.asarray(m, dtype=np.float64)


def _t(n: int, is_dst: bool, device) -> torch.Tensor:
    return const(_t_np(n, is_dst), device)


def _round_shift(v: torch.Tensor, s: int) -> torch.Tensor:
    return (v + (1 << (s - 1))) >> s


def forward_transform(residual: torch.Tensor, *, is_dst: bool = False,
                      bit_depth: int = 8) -> torch.Tensor:
    """Forward transform of (..., N, N) integer residual blocks -> int32."""
    n = residual.shape[-1]
    log2 = n.bit_length() - 1
    t = _t(n, is_dst, residual.device)
    s1, s2 = tables.fwd_transform_shifts(log2, bit_depth)
    x = residual.to(torch.float64)
    # stage 1 (rows): tmp[..., k, j] = sum_i t[k, i] x[..., j, i]
    tmp = _round_shift(torch.matmul(t, x.transpose(-1, -2)).to(torch.int64),
                       s1)
    # stage 2 (columns): out[..., k, h] = sum_j t[k, j] tmp[..., h, j]
    out = torch.matmul(t, tmp.to(torch.float64).transpose(-1, -2))
    return _round_shift(out.to(torch.int64), s2).to(torch.int32)


def inverse_transform(coeff: torch.Tensor, *, is_dst: bool = False,
                      bit_depth: int = 8) -> torch.Tensor:
    """Inverse transform with normative 16-bit intermediate clipping."""
    n = coeff.shape[-1]
    t = _t(n, is_dst, coeff.device)
    s1, s2 = tables.inv_transform_shifts(bit_depth)
    c = coeff.to(torch.float64)
    # tmp[..., i, h] = sum_v t[v, i] c[..., v, h]
    tmp = _round_shift(torch.matmul(t.T, c).to(torch.int64), s1)
    tmp = tmp.clamp(-32768, 32767)
    # out[..., i, j] = sum_h t[h, j] tmp[..., i, h]
    out = torch.matmul(tmp.to(torch.float64), t).to(torch.int64)
    return _round_shift(out, s2).clamp(-32768, 32767).to(torch.int32)
