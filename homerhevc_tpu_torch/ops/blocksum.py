"""Per-block sums of whole-frame integer planes.

Port of homerhevc_tpu/ops/blocksum.py. The reference sums through one-hot
float32 matrix products (a TPU device for its matrix unit) and is exact only
while every sum stays below 2**24; a strided integer reduction gives the
same integers on any plane, so that is what runs here.
"""

from __future__ import annotations

import torch


def block_sum(x: torch.Tensor, by: int, bx: int) -> torch.Tensor:
    """Exact int32 per-(by, bx)-block sums of x (..., H, W) -> (..., H//by,
    W//bx)."""
    h, w = x.shape[-2:]
    lead = x.shape[:-2]
    return (x.reshape(lead + (h // by, by, w // bx, bx))
            .sum(dim=(-3, -1), dtype=torch.int32))
