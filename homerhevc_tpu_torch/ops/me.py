"""Integer-pel motion search: for every B x B block, the best (cost, offset)
over the (2S+1)^2 window, cost = SAD + mvcost[offset], offsets in dy-major
raster order, first minimum on ties.

`integer_me` launches the CUDA kernel kernels/me_sad.cu for a CUDA tensor
(replacing the TPU kernel homerhevc_tpu/ops/me_pallas.py) and runs the plain
version `integer_me_plain` for a CPU tensor, or on CUDA when the session was
built with kernels=False. Exact integer arithmetic: no tolerance.
"""

from __future__ import annotations

import ctypes

import torch

from ..device import first_argmin
from ..kernels.build import CudaKernel

_P = ctypes.c_void_p
_I = ctypes.c_int
ME_SAD = CudaKernel("me_sad", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _P])


def sad_grids(cur: torch.Tensor, ref_pad: torch.Tensor, *, S: int,
              search: int, pad: int) -> torch.Tensor:
    """Full SAD grid per S-block: (n*n, H//S, W//S) int32, dy-major offset
    order (port of p_jax._sad_grids; exact integer block sums)."""
    H, W = cur.shape
    n = 2 * search + 1
    c = cur.to(torch.int32)
    rows = []
    for dyi in range(n):
        y0 = pad - search + dyi
        band = ref_pad[y0:y0 + H].to(torch.int32)
        shifted = torch.stack([band[:, pad - search + dxi:
                                    pad - search + dxi + W]
                               for dxi in range(n)])           # (n, H, W)
        diff = (c - shifted).abs()
        rows.append(diff.reshape(n, H // S, S, W // S, S).sum(dim=(2, 4)))
    return torch.stack(rows).reshape(n * n, H // S, W // S).to(torch.int32)


def integer_me_plain(cur, ref_pad, mvcost, *, B: int, search: int,
                     pad: int):
    """Plain PyTorch version of the kernel: (cost, idx) each (nby, nbx)
    int32."""
    cost = sad_grids(cur, ref_pad, S=B, search=search, pad=pad)
    cost = cost + mvcost.to(torch.int32)[:, None, None]
    idx = first_argmin(cost, 0).to(torch.int32)
    return cost.min(dim=0).values, idx


def integer_me_cuda(cur, ref_pad, mvcost, *, B: int, search: int,
                    pad: int):
    """Launch kernels/me_sad.cu. cur (H, W) int16, ref_pad (H+2pad,
    W+2pad) int16, mvcost ((2S+1)^2,) int32, all contiguous on one CUDA
    device."""
    H, W = cur.shape
    n = 2 * search + 1
    if not (cur.is_cuda and ref_pad.device == cur.device
            and mvcost.device == cur.device):
        raise ValueError("integer_me_cuda: all tensors must be on one CUDA "
                         "device")
    if cur.dtype != torch.int16 or ref_pad.dtype != torch.int16 \
            or mvcost.dtype != torch.int32:
        raise TypeError("integer_me_cuda: cur/ref_pad int16, mvcost int32")
    if ref_pad.shape != (H + 2 * pad, W + 2 * pad) or H % B or W % B \
            or mvcost.shape != (n * n,) or search > pad:
        raise ValueError("integer_me_cuda: bad shapes "
                         f"{tuple(cur.shape)} {tuple(ref_pad.shape)} "
                         f"{tuple(mvcost.shape)} B={B} S={search} pad={pad}")
    cur = cur.contiguous()
    ref_pad = ref_pad.contiguous()
    mvcost = mvcost.contiguous()
    cost = torch.empty((H // B, W // B), dtype=torch.int32, device=cur.device)
    idx = torch.empty_like(cost)
    stream = torch.cuda.current_stream(cur.device).cuda_stream
    ME_SAD.launch(cur.data_ptr(), ref_pad.data_ptr(), mvcost.data_ptr(),
                  cost.data_ptr(), idx.data_ptr(), H, W, ref_pad.shape[1],
                  B, search, pad, stream)
    return cost, idx


def integer_me(cur, ref_pad, mvcost, *, B: int, search: int, pad: int,
               kernels: bool = True):
    """The kernel on a CUDA tensor, the plain version on a CPU tensor (or
    on CUDA when kernels=False)."""
    if cur.is_cuda and kernels:
        return integer_me_cuda(cur.to(torch.int16), ref_pad.to(torch.int16),
                               mvcost.to(torch.int32), B=B, search=search,
                               pad=pad)
    return integer_me_plain(cur, ref_pad, mvcost, B=B, search=search,
                            pad=pad)
