"""Planar YUV420 8-bit file I/O; the port's own copy of
homerhevc_tpu/utils/yuv.py.

Role of the reference CLI's frame reader and writer (homer_app.c:413-446,
503-516).
"""

from __future__ import annotations

import numpy as np


def frame_size_bytes(width: int, height: int) -> int:
    return width * height * 3 // 2


def read_yuv_frame(f, width: int, height: int):
    """Read one frame; returns (y, u, v) uint8 arrays or None at EOF."""
    ysz = width * height
    csz = ysz // 4
    buf = f.read(ysz + 2 * csz)
    if len(buf) < ysz + 2 * csz:
        return None
    y = np.frombuffer(buf, dtype=np.uint8, count=ysz).reshape(height, width)
    u = np.frombuffer(buf, dtype=np.uint8, count=csz, offset=ysz).reshape(height // 2, width // 2)
    v = np.frombuffer(buf, dtype=np.uint8, count=csz, offset=ysz + csz).reshape(height // 2, width // 2)
    return y, u, v


def write_yuv_frame(f, y: np.ndarray, u: np.ndarray, v: np.ndarray) -> None:
    f.write(np.ascontiguousarray(y, dtype=np.uint8).tobytes())
    f.write(np.ascontiguousarray(u, dtype=np.uint8).tobytes())
    f.write(np.ascontiguousarray(v, dtype=np.uint8).tobytes())


def pad_to_ctu(plane: np.ndarray, padded_h: int, padded_w: int) -> np.ndarray:
    """Edge-pad a plane to CTU-aligned dimensions (replicate borders)."""
    h, w = plane.shape
    if h == padded_h and w == padded_w:
        return plane
    return np.pad(plane, ((0, padded_h - h), (0, padded_w - w)), mode="edge")
