"""Device checks and the int32 helpers the port needs to reproduce the JAX
reference's integer semantics (x64 off: int32 arithmetic, floor `//`,
arithmetic `>>`, and argmin taking the FIRST minimum).

torch's own `//` on integer tensors is floor division and its `>>` on signed
tensors is arithmetic, as jnp's are, so those need no helper; a shift by a
tensor amount and a backend-independent first-minimum argmin do."""

from __future__ import annotations

import torch

I32 = torch.int32


def require_cuda() -> torch.device:
    """The CUDA device, or RuntimeError when there is none (no CPU
    fallback on a path that is meant for the card)."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA device required: torch.cuda.is_available() "
                           "is False")
    return torch.device("cuda", torch.cuda.current_device())


def shl(a, s: torch.Tensor) -> torch.Tensor:
    """Left shift where the shift amount is a tensor (a may be an int)."""
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(s, a)
    return torch.bitwise_left_shift(a, s)


def first_argmin(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the FIRST minimum along `dim` (int64), independent of the
    backend's argmin tie-breaking: ties go to the lowest index, exactly as
    jnp.argmin / np.argmin."""
    m = x.min(dim=dim, keepdim=True).values
    n = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = n
    ar = torch.arange(n, device=x.device).reshape(shape)
    return torch.where(x == m, ar, n).min(dim=dim).values


def edge_pad(plane: torch.Tensor, pad: int,
             pad_cols: int | None = None) -> torch.Tensor:
    """Edge-replicate padding of a 2-D plane (np.pad mode='edge') by
    clamped indexing, for any integer dtype: `pad` rows above and below,
    `pad_cols` columns left and right (`pad` when not given)."""
    H, W = plane.shape
    dev = plane.device
    pc = pad if pad_cols is None else pad_cols
    ys = torch.arange(-pad, H + pad, device=dev).clamp(0, H - 1)
    xs = torch.arange(-pc, W + pc, device=dev).clamp(0, W - 1)
    return plane[ys][:, xs]


def take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] for a 1-D table and an integer index tensor of any shape,
    gathered on the device in one launch: PyTorch's indexing reads a 0-d
    index tensor on the host (a wait for the device, which a CUDA graph's
    capture refuses), and casts an int32 index to int64 first."""
    return table.index_select(0, idx.reshape(-1)).reshape(idx.shape)


_CONST: dict = {}


def const(arr, device) -> torch.Tensor:
    """A constant numpy table as a tensor on `device`, uploaded once.

    Uploading a host array inside the frame loops would make the host wait
    for the device queue at every call; this caches one device copy per
    (array object, device). `arr` must be a long-lived constant (a module
    table or an lru_cached array) that nothing mutates."""
    key = (id(arr), str(device))
    hit = _CONST.get(key)
    if hit is None or hit[0] is not arr:
        hit = (arr, torch.as_tensor(arr, device=device))
        _CONST[key] = hit
    return hit[1]
