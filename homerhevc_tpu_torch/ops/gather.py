"""Batched per-block window gather: for each block b, the (G, G) window of
a padded plane at absolute top-left (by[b], bx[b]) -> (nb, G, G); for a
tuple of P planes of one shape, the same windows of each -> (P, nb, G, G).

Starts follow lax.dynamic_slice: a negative start counts from the end, then
the start is clamped to [0, Hp - G] x [0, Wp - G]. `gather_windows`
launches kernels/gather_win.cu for a CUDA tensor (the job of the TPU kernel
homerhevc_tpu/ops/gather_pallas.py), once for all planes, and runs the
plain version `gather_windows_plain` for a CPU tensor, or on CUDA when the
session was built with kernels=False. Pure data movement: exact.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels.build import CudaKernel

_P = ctypes.c_void_p
_I = ctypes.c_int
MAX_PLANES = 4
GATHER_WIN = CudaKernel(
    "gather_win", [_P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _P],
    floor_argtypes=[_I, _I, _I, _I, _P])


def gather_windows_plain(plane, by: torch.Tensor, bx: torch.Tensor,
                         G: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel (advanced indexing); a tuple of
    planes gives the stack of their gathers."""
    if isinstance(plane, (tuple, list)):
        return torch.stack([gather_windows_plain(p, by, bx, G)
                            for p in plane])
    Hp, Wp = plane.shape
    y0 = torch.where(by < 0, by + Hp, by).clamp(0, Hp - G)
    x0 = torch.where(bx < 0, bx + Wp, bx).clamp(0, Wp - G)
    ar = torch.arange(G, device=plane.device)
    rows = y0[:, None] + ar                                   # (nb, G)
    cols = x0[:, None] + ar
    return plane[rows[:, :, None], cols[:, None, :]]


def gather_windows_cuda(plane, by: torch.Tensor, bx: torch.Tensor,
                        G: int) -> torch.Tensor:
    """Launch kernels/gather_win.cu once. plane (Hp, Wp) int16, or a tuple
    of up to 4 such planes of one shape; by/bx (nb,) int32, on one CUDA
    device. Returns (nb, G, G) int16, or (P, nb, G, G) for a tuple. The
    planes' pointers go to the launcher as they are: nothing is stacked."""
    single = not isinstance(plane, (tuple, list))
    planes = (plane,) if single else tuple(plane)
    if not 1 <= len(planes) <= MAX_PLANES:
        raise ValueError(f"gather_windows_cuda: 1..{MAX_PLANES} planes, got "
                         f"{len(planes)}")
    first = planes[0]
    Hp, Wp = first.shape
    nb = by.shape[0]
    if not (all(p.is_cuda and p.device == first.device for p in planes)
            and by.device == first.device and bx.device == first.device):
        raise ValueError("gather_windows_cuda: all tensors must be on one "
                         "CUDA device")
    if any(p.dtype != torch.int16 for p in planes) \
            or by.dtype != torch.int32 or bx.dtype != torch.int32:
        raise TypeError("gather_windows_cuda: planes int16, by/bx int32")
    if any(p.shape != (Hp, Wp) for p in planes) or by.shape != (nb,) \
            or bx.shape != (nb,) or G > Hp or G > Wp:
        raise ValueError("gather_windows_cuda: bad shapes "
                         f"{[tuple(p.shape) for p in planes]} "
                         f"{tuple(by.shape)} {tuple(bx.shape)} G={G}")
    planes = tuple(p.contiguous() for p in planes)
    by = by.contiguous()
    bx = bx.contiguous()
    out = torch.empty((len(planes), nb, G, G), dtype=torch.int16,
                      device=first.device)
    ptrs = [p.data_ptr() for p in planes] + [None] * (MAX_PLANES
                                                     - len(planes))
    GATHER_WIN.launch_on(first.device, *ptrs, len(planes), by.data_ptr(),
                         bx.data_ptr(), out.data_ptr(), nb, Hp, Wp, G)
    return out[0] if single else out


def gather_windows(plane, by: torch.Tensor, bx: torch.Tensor, G: int, *,
                   kernels: bool = True) -> torch.Tensor:
    """The kernel on a CUDA tensor, the plain version on a CPU tensor (or
    on CUDA when kernels=False). `plane` is one (Hp, Wp) plane or a tuple
    of planes of one shape; returns (nb, G, G) or (P, nb, G, G) int16."""
    single = not isinstance(plane, (tuple, list))
    planes = tuple(p.to(torch.int16) for p in ((plane,) if single
                                               else plane))
    arg = planes[0] if single else planes
    if planes[0].is_cuda and kernels:
        return gather_windows_cuda(arg, by.to(torch.int32),
                                   bx.to(torch.int32), G)
    return gather_windows_plain(arg, by, bx, G)
