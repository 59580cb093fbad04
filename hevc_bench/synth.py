"""Synthetic YUV 4:2:0 clips for the benchmark, made from a seed in host
memory.

A frozen copy of `homerhevc_tpu_torch/utils/synth.py`'s `synth_clip` (a
textured field that pans, a bright square that moves across it, seeded
noise in the texture), extended for the benchmark:

- the pan goes back and forth over the texture (a triangle wave), so it
  never jumps: a jump would look like a scene cut to the encoder;
- film grain: a few fields of seeded temporal noise, one added to each
  frame in turn;
- shots: with `shot_frames` > 0 the clip is cut every `shot_frames` frames
  from frame `cut_phase` on, and each shot shows a texture pattern of its
  own. The patterns come from one fixed list, in an order drawn from the
  seed, so every seed codes the same set of contents.

Everything a frame holds is a function of (seed, frame index): two runs
with one seed get the same frames. A clip of N frames plays back and
forth (`play`): 0, 1, .., N-1, N-2, .., 1, 0, 1, .., so a run of any length
needs only the N frames made in set-up and never jumps.
"""

from __future__ import annotations

import numpy as np

# (a, b, c, inverted) of the texture a*x + b*y + (x*y)//c (mod 256),
# inverted as 255 - texture; pattern 0 is synth_clip's own. A shot of an
# inverted pattern always follows one of a plain pattern and the other way
# round, so that every cut changes the picture as a hard cut does
PATTERNS = ((2, 3, 97, 0), (3, 1, 89, 1), (1, 2, 71, 0), (3, 2, 113, 1),
            (2, 1, 61, 0), (1, 3, 83, 1), (3, 3, 101, 0), (2, 2, 79, 1))


def play(p: int, n: int) -> int:
    """Frame of an n-frame clip shown at playback position p (back and
    forth)."""
    p %= 2 * n - 2
    return p if p < n else 2 * n - 2 - p


def triangle(s: int, span: int) -> int:
    """Position after travelling `s` samples back and forth over `span`."""
    s %= 2 * span
    return s if s <= span else 2 * span - s


class Clip:
    """A seeded clip of `width` x `height`; `frames(start, n)` makes frames
    start .. start + n - 1 as (y, u, v) uint8 arrays."""

    def __init__(self, width: int, height: int, *, seed: int,
                 pan=(3, 2), travel: int = 256, noise: int = 12,
                 grain: int = 2, grain_fields: int = 8, square: int = 64,
                 square_step=(37, 23), square_gain: int = 80,
                 patterns=(0,), shot_frames: int = 0, cut_phase: int = 0):
        if width % 2 or height % 2:
            raise ValueError("width and height must be even")
        self.w, self.h = width, height
        self.pan = tuple(pan)
        self.travel = travel
        self.square = square
        self.square_step = tuple(square_step)
        self.square_gain = square_gain
        self.shot_frames = shot_frames
        self.cut_phase = cut_phase
        rng = np.random.default_rng(seed)
        plain = [p for p in patterns if not PATTERNS[p][3]]
        inverted = [p for p in patterns if PATTERNS[p][3]]
        plain = [int(p) for p in rng.permutation(plain)]
        inverted = [int(p) for p in rng.permutation(inverted)]
        self.order = [p for pair in zip(plain, inverted) for p in pair] \
            + plain[len(inverted):] + inverted[len(plain):]
        th, tw = height + travel, width + travel
        yy, xx = np.mgrid[0:th, 0:tw]
        self.tex = {}
        for p in sorted(set(self.order)):
            a, b, c, inv = PATTERNS[p]
            base = ((a * xx + b * yy + (xx * yy) // c) % 256).astype(np.int16)
            if inv:
                base = 255 - base
            base += rng.integers(-noise, noise + 1, size=base.shape,
                                 dtype=np.int16)
            y = np.clip(base, 0, 255).astype(np.uint8)
            u = np.clip(128 + ((xx - yy) * a) // 16, 0, 255).astype(np.uint8)
            v = np.clip(128 - (xx * b) // 16 + yy // 16, 0,
                        255).astype(np.uint8)
            self.tex[p] = (y, u, v)
        self.grain = rng.integers(-grain, grain + 1,
                                  size=(grain_fields, height, width),
                                  dtype=np.int16)

    def shot(self, t: int) -> int:
        """Index of the shot that frame t belongs to (0 without cuts)."""
        if self.shot_frames <= 0 or t < self.cut_phase:
            return 0
        return 1 + (t - self.cut_phase) // self.shot_frames

    def is_cut(self, t: int) -> bool:
        """Frame t is the first of a shot after a hard cut."""
        return t > 0 and self.shot(t) != self.shot(t - 1)

    def offset(self, t: int) -> tuple:
        """(dx, dy): where frame t's window lies on its texture."""
        return (triangle(self.pan[0] * t, self.travel),
                triangle(self.pan[1] * t, self.travel))

    def motion(self, t: int, t_ref: int):
        """The true motion of frame t's texture from frame t_ref's, in
        whole luma samples: (mvx, mvy) such that the texture at (x, y) of
        frame t lies at (x + mvx, y + mvy) of frame t_ref. None where the
        two frames belong to different shots. The square and the grain
        move otherwise."""
        if self.shot(t) != self.shot(t_ref):
            return None
        (x, y), (xr, yr) = self.offset(t), self.offset(t_ref)
        return x - xr, y - yr

    def frame(self, t: int):
        y_t, u_t, v_t = self.tex[self.order[self.shot(t) % len(self.order)]]
        w, h = self.w, self.h
        dx, dy = self.offset(t)
        y = y_t[dy:dy + h, dx:dx + w].astype(np.int16)
        s = self.square
        bx = (self.square_step[0] * t) % max(w - s, 1)
        by = (self.square_step[1] * t) % max(h - s, 1)
        y[by:by + s, bx:bx + s] += self.square_gain
        y += self.grain[t % len(self.grain)]
        np.clip(y, 0, 255, out=y)
        return (y.astype(np.uint8), u_t[dy:dy + h:2, dx:dx + w:2],
                v_t[dy:dy + h:2, dx:dx + w:2])

    def frames(self, start: int, n: int) -> list:
        return [self.frame(t) for t in range(start, start + n)]


def padded(planes, height: int, width: int):
    """Planes edge-padded to a coded size (height x width luma)."""
    out = []
    for p, (h, w) in zip(planes, ((height, width),
                                  (height // 2, width // 2),
                                  (height // 2, width // 2))):
        out.append(np.pad(p, ((0, h - p.shape[0]), (0, w - p.shape[1])),
                          mode="edge"))
    return tuple(out)
