"""Batched per-block window gather: for each block b, the (G, G) window of
a padded plane at absolute top-left (by[b], bx[b]) -> (nb, G, G).

Starts follow lax.dynamic_slice: a negative start counts from the end, then
the start is clamped to [0, Hp - G] x [0, Wp - G]. `gather_windows`
launches kernels/gather_win.cu for a CUDA tensor (the job of the TPU kernel
homerhevc_tpu/ops/gather_pallas.py) and runs the plain version
`gather_windows_plain` for a CPU tensor, or on CUDA when the session was
built with kernels=False. Pure data movement: exact.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels.build import CudaKernel

_P = ctypes.c_void_p
_I = ctypes.c_int
GATHER_WIN = CudaKernel("gather_win", [_P, _P, _P, _P, _I, _I, _I, _I, _P])


def gather_windows_plain(plane: torch.Tensor, by: torch.Tensor,
                         bx: torch.Tensor, G: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel (advanced indexing)."""
    Hp, Wp = plane.shape
    y0 = torch.where(by < 0, by + Hp, by).clamp(0, Hp - G)
    x0 = torch.where(bx < 0, bx + Wp, bx).clamp(0, Wp - G)
    ar = torch.arange(G, device=plane.device)
    rows = y0[:, None] + ar                                   # (nb, G)
    cols = x0[:, None] + ar
    return plane[rows[:, :, None], cols[:, None, :]]


def gather_windows_cuda(plane: torch.Tensor, by: torch.Tensor,
                        bx: torch.Tensor, G: int) -> torch.Tensor:
    """Launch kernels/gather_win.cu. plane (Hp, Wp) int16, by/bx (nb,)
    int32, on one CUDA device. Returns (nb, G, G) int16."""
    Hp, Wp = plane.shape
    nb = by.shape[0]
    if not (plane.is_cuda and by.device == plane.device
            and bx.device == plane.device):
        raise ValueError("gather_windows_cuda: all tensors must be on one "
                         "CUDA device")
    if plane.dtype != torch.int16 or by.dtype != torch.int32 \
            or bx.dtype != torch.int32:
        raise TypeError("gather_windows_cuda: plane int16, by/bx int32")
    if by.shape != (nb,) or bx.shape != (nb,) or G > Hp or G > Wp:
        raise ValueError("gather_windows_cuda: bad shapes "
                         f"{tuple(plane.shape)} {tuple(by.shape)} "
                         f"{tuple(bx.shape)} G={G}")
    plane = plane.contiguous()
    by = by.contiguous()
    bx = bx.contiguous()
    out = torch.empty((nb, G, G), dtype=torch.int16, device=plane.device)
    stream = torch.cuda.current_stream(plane.device).cuda_stream
    GATHER_WIN.launch(plane.data_ptr(), by.data_ptr(), bx.data_ptr(),
                      out.data_ptr(), nb, Hp, Wp, G, stream)
    return out


def gather_windows(plane: torch.Tensor, by: torch.Tensor, bx: torch.Tensor,
                   G: int, *, kernels: bool = True) -> torch.Tensor:
    """The kernel on a CUDA tensor, the plain version on a CPU tensor (or
    on CUDA when kernels=False). Returns (nb, G, G) int16."""
    if plane.is_cuda and kernels:
        return gather_windows_cuda(plane.to(torch.int16), by.to(torch.int32),
                                   bx.to(torch.int32), G)
    return gather_windows_plain(plane.to(torch.int16), by, bx, G)
