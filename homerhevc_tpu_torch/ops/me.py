"""Integer-pel motion search: for every B x B block, the best (cost, offset)
over the (2S+1)^2 window, cost = SAD + mvcost[offset], offsets in dy-major
raster order, first minimum on ties.

`integer_me` launches the CUDA kernel kernels/me_sad.cu for a CUDA tensor
(replacing the TPU kernel homerhevc_tpu/ops/me_pallas.py) and runs the plain
version `integer_me_plain` for a CPU tensor, or on CUDA when the session was
built with kernels=False. Exact integer arithmetic: no tolerance.

The planes hold 8-bit samples, as uint8 or int16: the kernel packs them to
bytes, so a value outside 0..255 in an int16 plane is outside the contract
(the session refuses other bit depths, and the reference plane is a clipped
reconstruction).
"""

from __future__ import annotations

import ctypes

import torch

from ..device import first_argmin
from ..kernels.build import CudaKernel

_P = ctypes.c_void_p
_I = ctypes.c_int
ME_SAD = CudaKernel(
    "me_sad", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    floor_argtypes=[_I, _I, _I, _I, _P])
_SAMPLE_DTYPES = (torch.uint8, torch.int16)


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
    int32. cur and ref_pad of any integer dtype, samples in 0..255."""
    cost = sad_grids(cur, ref_pad, S=B, search=search, pad=pad)
    cost = cost + mvcost.to(torch.int32)[:, None, None]
    idx = first_argmin(cost, 0).to(torch.int32)
    return cost.min(dim=0).values, idx


def integer_me_cuda(cur, ref_pad, mvcost, *, B: int, search: int,
                    pad: int):
    """Launch kernels/me_sad.cu. cur (H, W) and ref_pad (H+2pad, W+2pad)
    uint8 or int16 with samples in 0..255, mvcost ((2S+1)^2,) int32, all on
    one CUDA device; B a multiple of 4."""
    H, W = cur.shape
    n = 2 * search + 1
    if not (cur.is_cuda and ref_pad.device == cur.device
            and mvcost.device == cur.device):
        raise ValueError("integer_me_cuda: all tensors must be on one CUDA "
                         "device")
    if cur.dtype not in _SAMPLE_DTYPES or ref_pad.dtype not in _SAMPLE_DTYPES \
            or mvcost.dtype != torch.int32:
        raise TypeError("integer_me_cuda: cur/ref_pad uint8 or int16, "
                        "mvcost int32")
    if ref_pad.shape != (H + 2 * pad, W + 2 * pad) or B % 4 or H % B \
            or W % B or mvcost.shape != (n * n,) or search > pad:
        raise ValueError("integer_me_cuda: bad shapes "
                         f"{tuple(cur.shape)} {tuple(ref_pad.shape)} "
                         f"{tuple(mvcost.shape)} B={B} S={search} pad={pad}")
    cur = cur.contiguous()
    ref_pad = ref_pad.contiguous()
    mvcost = mvcost.contiguous()
    cost = torch.empty((H // B, W // B), dtype=torch.int32, device=cur.device)
    idx = torch.empty_like(cost)
    ME_SAD.launch_on(cur.device, cur.data_ptr(), ref_pad.data_ptr(),
                     mvcost.data_ptr(), cost.data_ptr(), idx.data_ptr(), H,
                     W, ref_pad.shape[1], B, search, pad,
                     int(cur.dtype == torch.uint8),
                     int(ref_pad.dtype == torch.uint8))
    return cost, idx


def _samples(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype in _SAMPLE_DTYPES else t.to(torch.int16)


def integer_me(cur, ref_pad, mvcost, *, B: int, search: int, pad: int,
               kernels: bool = True):
    """The kernel on a CUDA tensor, the plain version on a CPU tensor (or
    on CUDA when kernels=False). uint8 and int16 planes go to the kernel as
    they are; any other integer dtype is converted to int16 first."""
    if cur.is_cuda and kernels:
        return integer_me_cuda(_samples(cur), _samples(ref_pad),
                               mvcost.to(torch.int32), B=B, search=search,
                               pad=pad)
    return integer_me_plain(cur, ref_pad, mvcost, B=B, search=search,
                            pad=pad)
