"""Seeded smooth-texture pans: the benchmark's frames.

The texture is ``chip_smoke.py``'s (uniform noise, a 9x9 box blur twice,
stretched to [0, 255]), made periodic so that a clip of any length is cut
from one canvas without copying it: the blur wraps around, and the canvas
repeats its first rows and columns so that every frame is a plain slice.
A clip starts at an offset drawn from the seed and moves by exactly its
step a frame, so its backward flow is the step everywhere.
"""

from __future__ import annotations

import numpy as np

PERIOD = 2048          # texture period in both axes; larger than any frame side


def _box_wrap(a, k: int):
    """k x k box mean of a (P, P, C) array with wrap-around borders."""
    r = k // 2
    p = np.pad(a, ((r, r), (r, r), (0, 0)), mode="wrap")
    c = np.pad(np.cumsum(np.cumsum(p, 0, dtype=np.float64), 1), ((1, 0), (1, 0), (0, 0)))
    return ((c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]) / (k * k)).astype(np.float32)


def texture(seed: int, period: int = PERIOD) -> np.ndarray:
    """(period, period, 3) uint8, periodic in both axes."""
    rng = np.random.default_rng(seed)
    canvas = rng.random((period, period, 3), dtype=np.float32)
    for _ in range(2):
        canvas = _box_wrap(canvas, 9)
    canvas = (canvas - canvas.min()) / (canvas.max() - canvas.min())
    return np.round(canvas * 255).astype(np.uint8)


class Pan:
    """Frames of one clip: ``frame(t)`` is the (h, w, 3) uint8 view at
    offset + t * step (wrapping on the period). The canvas is shared."""

    def __init__(self, canvas: np.ndarray, period: int, h: int, w: int, step, offset):
        self.h, self.w = h, w
        self.period = period
        self.canvas = canvas
        self.step = (int(step[0]), int(step[1]))           # (dx, dy)
        self.offset = (int(offset[0]) % self.period, int(offset[1]) % self.period)

    def frame(self, t: int) -> np.ndarray:
        x = (self.offset[0] + t * self.step[0]) % self.period
        y = (self.offset[1] + t * self.step[1]) % self.period
        return self.canvas[y:y + self.h, x:x + self.w]


class Source:
    """The texture of one seed and the clips cut from it: ``pans(n, h, w,
    step)`` gives n clips at offsets drawn from the seed, the first of each
    at frame 0."""

    def __init__(self, seed: int, max_side: int, period: int = PERIOD):
        if max_side > period:
            raise ValueError(f"frames of {max_side} px exceed the texture period {period}")
        tex = texture(seed, period)
        self.canvas = np.pad(tex, ((0, max_side), (0, max_side), (0, 0)), mode="wrap")
        self.rng = np.random.default_rng([seed, 1])
        self.period = period

    def pans(self, n: int, h: int, w: int, step):
        offs = self.rng.integers(0, self.period, size=(n, 2))
        return [Pan(self.canvas, self.period, h, w, step, o) for o in offs]
