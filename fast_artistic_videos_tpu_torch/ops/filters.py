"""Spatial filters — counterpart of ``fast_artistic_videos_tpu/ops/filters.py``
(``min_filter`` only: the occlusion erosion of the streaming path).

``min_filter`` is grayscale erosion with border-clipped windows
(utils.lua:161-169): a separable pair of 1-D min passes whose +inf padding
reproduces the clipped windows.
"""

from __future__ import annotations

import torch


def _min_pass(x, size: int, axis: int):
    pad = size // 2
    n = x.shape[axis]
    shape = list(x.shape)
    shape[axis] = pad
    inf = torch.full(shape, float("inf"), dtype=x.dtype, device=x.device)
    xp = torch.cat([inf, x, inf], dim=axis)
    out = xp.narrow(axis, 0, n)
    for d in range(1, size):
        out = torch.minimum(out, xp.narrow(axis, d, n))
    return out


def min_filter(x, size: int):
    """Erosion with an odd ``size`` x ``size`` window, border-clipped.

    x: (..., H, W) or (..., H, W, C); filtering is over the two axes before
    the channel axis if x.ndim >= 3 else the last two."""
    if size <= 1:
        return x
    if size % 2 == 0:
        raise ValueError(f"min_filter window must be odd (got {size})")
    h_ax = x.ndim - 3 if x.ndim >= 3 else x.ndim - 2
    return _min_pass(_min_pass(x, size, h_ax), size, h_ax + 1)
