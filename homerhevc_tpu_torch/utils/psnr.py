"""PSNR metrics; the port's own copy of homerhevc_tpu/utils/psnr.py (role
of the reference's hmr_metics.c:53-105)."""

from __future__ import annotations

import math

import numpy as np


def psnr(ref: np.ndarray, rec: np.ndarray, max_val: int = 255) -> float:
    diff = ref.astype(np.int64) - rec.astype(np.int64)
    mse = float(np.mean(diff * diff))
    if mse == 0:
        return 100.0
    return 10.0 * math.log10(max_val * max_val / mse)


def yuv_psnr(ref_yuv, rec_yuv) -> tuple[float, float, float]:
    return tuple(psnr(r, d) for r, d in zip(ref_yuv, rec_yuv))
