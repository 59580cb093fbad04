"""Quantisation, dequantisation and sign-bit hiding (HM forward; spec 8.6.3
inverse). Port of homerhevc_tpu/ops/quant.py: int32 arithmetic throughout,
exactly as the JAX reference computes with x64 off. `qp` may be a python
int, a 0-d tensor (the per-frame QP kept on the device) or a per-block
tensor whose shape is a prefix of the blocks' shape."""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import tables
from ..device import const, shl, take

I32 = torch.int32


def _qp(qp, x: torch.Tensor) -> torch.Tensor:
    """qp as an int32 tensor broadcastable against x (leading block axes)."""
    if isinstance(qp, int):
        return torch.full((), qp, dtype=I32, device=x.device)
    q = qp.to(I32)
    if q.dim() == 0:
        return q
    return q.reshape(q.shape + (1,) * (x.dim() - q.dim()))


def quantize(coeff: torch.Tensor, qp, log2_size: int, *, is_intra: bool,
             bit_depth: int = 8) -> torch.Tensor:
    q = _qp(qp, coeff)
    tshift = tables.MAX_TR_DYNAMIC_RANGE - bit_depth - log2_size
    qbits = tables.QUANT_SHIFT + q // 6 + tshift
    scale = take(const(tables.QUANT_SCALES, coeff.device), q % 6)
    add = shl(171 if is_intra else 85, qbits - 9)
    c = coeff.to(I32)
    level = ((c.abs() * scale + add) >> qbits).clamp(0, 32767)
    return (torch.sign(c) * level).to(I32)


def dequantize(level: torch.Tensor, qp, log2_size: int,
               bit_depth: int = 8) -> torch.Tensor:
    """The 2^(qp//6) factor is folded into the final shift, as in the
    reference, so every intermediate fits int32."""
    q = _qp(qp, level)
    bd_shift = bit_depth + log2_size - 5
    k = q // 6
    scale = const(tables.INV_QUANT_SCALES, level.device)
    t = level.to(I32) * (take(scale, q % 6) * 16)
    k_c = torch.clamp(k, max=bd_shift - 1)
    lo = (t + shl(1, bd_shift - 1 - k_c)) >> (bd_shift - k_c)
    hi = t << torch.clamp(k - bd_shift, min=0)
    c = torch.where(k < bd_shift, lo, hi)
    return c.clamp(-32768, 32767).to(I32)


@functools.lru_cache(maxsize=None)
def _scan_perm(log2_size: int, scans: tuple):
    """(scan, inverse scan) int64 position permutations of one TB, one row
    per scan index of `scans`: (K, n*n) each."""
    scan = np.stack([np.asarray(tables.coeff_scan(log2_size, s), np.int64)
                     for s in scans])
    inv = np.zeros_like(scan)
    for k in range(len(scans)):
        inv[k, scan[k]] = np.arange(scan.shape[1])
    return scan, inv


def sign_bit_hiding(levels: torch.Tensor, coeffs: torch.Tensor, qp,
                    log2_size: int, bit_depth: int = 8,
                    scan_idx=0) -> torch.Tensor:
    """Batched sign-bit hiding for (..., N, N) blocks, in the TB's scan
    order `scan_idx` (0 diag / 1 hor / 2 ver). Same candidate order (j
    ascending, +1 before -1) and strict-less selection as the reference;
    the layout here is (blocks, groups, 16) with reductions on the last
    axis. A tuple of K scan indices gives the K results in one pass,
    stacked on a new leading axis: (K, ..., N, N)."""
    n = levels.shape[-1]
    assert n.bit_length() - 1 == log2_size
    dev = levels.device
    scans = (scan_idx,) if isinstance(scan_idx, int) else tuple(scan_idx)
    K = len(scans)
    scan, inv = (const(a, dev) for a in _scan_perm(log2_size, scans))

    tshift = tables.MAX_TR_DYNAMIC_RANGE - bit_depth - log2_size
    lead = levels.shape[:-2]
    L = int(math.prod(lead)) if lead else 1
    G = (n * n) // 16
    q = (torch.full((), qp, dtype=I32, device=dev) if isinstance(qp, int)
         else qp.to(I32))
    if q.dim():                          # per block: one QP per lead index
        q = torch.broadcast_to(q.reshape(q.shape + (1,) * (len(lead)
                                                           - q.dim())),
                               lead).reshape(L, 1, 1)
        q = q.repeat_interleave(K, 0)
    qbits = tables.QUANT_SHIFT + q // 6 + tshift
    scale = take(const(tables.QUANT_SCALES, dev), q % 6)

    # (L, K, n*n) in scan order -> L*K blocks of G groups
    ls = levels.to(I32).reshape(L, n * n)[:, scan].reshape(L * K, G, 16)
    cs = coeffs.to(I32).reshape(L, n * n)[:, scan].reshape(L * K, G, 16)
    mag = ls.abs()
    nz = ls != 0
    idx = torch.arange(16, dtype=I32, device=dev)
    first = torch.where(nz, idx, 99).amin(-1)                    # (L, G)
    last = torch.where(nz, idx, -1).amax(-1)
    has = nz.any(-1)
    first_oh = idx == first.clamp(0, 15)[..., None]
    sign_flag = torch.where(first_oh, ls, 0).sum(-1) < 0
    parity = mag.sum(-1) & 1
    need = has & (last - first > 3) & (parity != sign_flag.to(parity.dtype))

    exact9 = (cs.abs() * scale) >> (qbits - 9)                   # (L, G, 16)
    BIG = 1 << 30
    is_zero = mag == 0
    errs = []                               # [+1, -1] candidate planes
    for d in (1, -1):
        new_mag = mag + d
        invalid = (new_mag < 0) | (new_mag > 32767)
        invalid |= (idx == first[..., None]) & (new_mag == 0)
        if d < 0:
            invalid |= is_zero
        else:
            invalid |= is_zero & (idx < first[..., None])
        penalty = torch.where(is_zero & (idx > last[..., None]) & (d > 0),
                              1 << 26, 0)
        err = ((new_mag << 9) - exact9).abs() + penalty
        errs.append(torch.where(invalid, BIG, err))
    err_p, err_m = errs
    # first minimum in (j asc, +1 before -1) order: order = 2j (+1), 2j+1
    m = torch.minimum(err_p.amin(-1), err_m.amin(-1))
    ord_p = torch.where(err_p == m[..., None], 2 * idx, 99)
    ord_m = torch.where(err_m == m[..., None], 2 * idx + 1, 99)
    k_ord = torch.minimum(ord_p.amin(-1), ord_m.amin(-1))
    bj = k_ord >> 1
    valid = m < BIG
    bj_oh = idx == bj[..., None]
    sel_p = bj_oh & ((k_ord & 1) == 0)[..., None]
    sel_m = bj_oh & ((k_ord & 1) == 1)[..., None]
    new_mag_sel = (torch.where(sel_p, mag + 1, 0).sum(-1)
                   + torch.where(sel_m, mag - 1, 0).sum(-1))
    orig_sel = torch.where(bj_oh, ls, 0).sum(-1)
    csel = torch.where(bj_oh, cs, 0).sum(-1)
    s = torch.where(orig_sel != 0, torch.where(orig_sel < 0, -1, 1),
                    torch.where(csel < 0, -1, 1))
    newval = (s * new_mag_sel).to(I32)
    apply = (need & valid)[..., None] & bj_oh
    out_scan = torch.where(apply, newval[..., None], ls)
    flat = torch.gather(out_scan.reshape(L, K, n * n), 2,
                        inv[None].expand(L, -1, -1)).to(I32)
    if isinstance(scan_idx, int):
        return flat.reshape(levels.shape)
    return flat.permute(1, 0, 2).reshape((K,) + levels.shape)
