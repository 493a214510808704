"""The static geometry of the cube faces: the reference's border maps and
seam masks (fast-artistic-videos ``vr_helper.lua:3-92`` and
``utils.lua:179-213``), evaluated in float64 with the reference's 1-based
coordinates and stored as float32 absolute offsets (dx, dy); pixels the
map does not reach carry a sentinel offset that samples zero.
"""

from __future__ import annotations

import numpy as np
import torch

SENTINEL = 99999.0


def _strip_width(size: int, oversize: float) -> float:
    width = size / 2 / ((2 * oversize + size) / size)
    max_resize = (width + oversize) / width
    return width - (max_resize - 1) / max_resize * oversize


def _left(h: int, crop: int, w: int) -> np.ndarray:
    over = crop / 2
    width = _strip_width(h, over)
    flow = np.full((h, w, 2), SENTINEL, np.float32)
    k = np.arange(1, crop + 1, dtype=np.float64)
    x = (width - crop) + k
    rf = (x + over) / width
    y = np.arange(1, h + 1, dtype=np.float64)[:, None]
    cols = (k + w - crop - 1).astype(np.int64)
    flow[:, cols, 1] = (h / 2 - y) * (-1 / rf + 1)
    flow[:, cols, 0] = ((width - x - over) * (rf - 1) / rf - w + crop)[None, :]
    return flow


def _right(h: int, crop: int, w: int) -> np.ndarray:
    over = crop / 2
    width = _strip_width(h, over)
    flow = np.full((h, w, 2), SENTINEL, np.float32)
    x = np.arange(1, crop + 1, dtype=np.float64)
    rf = (width - x + over) / width
    y = np.arange(1, h + 1, dtype=np.float64)[:, None]
    flow[:, :crop, 1] = (h / 2 - y) * (-1 / rf + 1)
    flow[:, :crop, 0] = (-(x - over) * (rf - 1) / rf + w - crop)[None, :]
    return flow


def _top(w: int, crop: int, h: int) -> np.ndarray:
    over = crop / 2
    height = _strip_width(w, over)
    flow = np.full((h, w, 2), SENTINEL, np.float32)
    k = np.arange(1, crop + 1, dtype=np.float64)
    y = (height - crop) + k
    rf = (y + over) / height
    x = np.arange(1, w + 1, dtype=np.float64)[None, :]
    rows = (k + h - crop - 1).astype(np.int64)
    flow[rows, :, 1] = ((height - y - over) * (rf - 1) / rf - h + crop)[:, None]
    flow[rows, :, 0] = (w / 2 - x) * (-1 / rf[:, None] + 1)
    return flow


def _bottom(w: int, crop: int, h: int) -> np.ndarray:
    over = crop / 2
    height = _strip_width(w, over)
    flow = np.full((h, w, 2), SENTINEL, np.float32)
    y = np.arange(1, crop + 1, dtype=np.float64)
    rf = (height - y + over) / height
    x = np.arange(1, w + 1, dtype=np.float64)[None, :]
    flow[:crop, :, 1] = (-(y - over) * (rf - 1) / rf + h - crop)[:, None]
    flow[:crop, :, 0] = (w / 2 - x) * (-1 / rf[:, None] + 1)
    return flow


def border_maps(face: int, overlap: int):
    """(left, right, top, bottom) maps of a square face."""
    return (_left(face, overlap, face), _right(face, overlap, face),
            _top(face, overlap, face), _bottom(face, overlap, face))


def _ramp(n: int, increasing: bool):
    r = torch.arange(1, n + 1, dtype=torch.float32) if increasing else \
        torch.arange(n, 0, -1, dtype=torch.float32)
    return r / (n + 1)


def gradient_masks(face: int, overlap: int):
    """(left, right, top, bottom) seam ramps, 10 px inside the overlap."""
    g = max(1, overlap - 10)
    z = torch.zeros((face, face - g))
    left = torch.cat([_ramp(g, False)[None, :].expand(face, g), z], dim=1)
    right = torch.cat([z, _ramp(g, True)[None, :].expand(face, g)], dim=1)
    top = torch.cat([_ramp(g, False)[:, None].expand(g, face), z.T], dim=0)
    bottom = torch.cat([z.T, _ramp(g, True)[:, None].expand(g, face)], dim=0)
    return left, right, top, bottom
