"""Deterministic synthetic YUV420 test clips (smoke run + tests); the
port's own copy of homerhevc_tpu/utils/synth.py.

Role of the reference's small debug YUVs (homer_app.c:43-51): reproducible
content with gradients, texture and motion so intra and inter coding both
have realistic work to do.
"""

from __future__ import annotations

import numpy as np


def synth_clip(width: int, height: int, n_frames: int, seed: int = 0):
    """Yield (y, u, v) uint8 planes for a moving-texture clip."""
    rng = np.random.default_rng(seed)
    # Static texture field, larger than the frame so motion = cheap slicing.
    pad = 128
    texw, texh = width + 2 * pad, height + 2 * pad
    yy, xx = np.mgrid[0:texh, 0:texw]
    base = ((xx * 2 + yy * 3 + (xx * yy) // 97) % 256).astype(np.int16)
    base += rng.integers(-12, 13, size=base.shape, dtype=np.int16)
    base = np.clip(base, 0, 255)
    for t in range(n_frames):
        # Global pan: a few pels per frame, non-integer-ish pattern.
        dx = pad + (3 * t) % pad
        dy = pad + (2 * t) % pad
        y = base[dy:dy + height, dx:dx + width].astype(np.int16)
        # A moving bright square (local motion + occlusion).
        bx = (37 * t) % max(width - 64, 1)
        by = (23 * t) % max(height - 64, 1)
        y[by:by + 64, bx:bx + 64] = np.clip(y[by:by + 64, bx:bx + 64] + 80, 0, 255)
        y = y.astype(np.uint8)
        u = np.clip(128 + (xx[dy:dy + height:2, dx:dx + width:2] - yy[dy:dy + height:2, dx:dx + width:2]) // 8, 0, 255).astype(np.uint8)
        v = np.clip(128 - xx[dy:dy + height:2, dx:dx + width:2] // 8 + yy[dy:dy + height:2, dx:dx + width:2] // 16, 0, 255).astype(np.uint8)
        yield y, u, v


def write_yuv(path: str, width: int, height: int, n_frames: int,
              seed: int = 0) -> None:
    with open(path, "wb") as f:
        for y, u, v in synth_clip(width, height, n_frames, seed):
            f.write(y.tobytes())
            f.write(u.tobytes())
            f.write(v.tobytes())
