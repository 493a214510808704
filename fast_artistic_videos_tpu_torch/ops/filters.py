"""Spatial filters — counterpart of ``fast_artistic_videos_tpu/ops/filters.py``:
``min_filter`` (the occlusion erosion), ``median_filter``,
``flow_magnitude_mask`` and the gradient masks of the VR seam blend.

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


def median_filter(x, size: int):
    """Median over valid ``size`` x ``size`` windows; the output is
    (..., H-size+1, W-size+1, C) (utils.lua:151-159), with the Torch median
    convention: the (n-1)//2-th smallest (0-indexed) of n = size**2.

    x: (..., H, W, C), or (H, W) which is filtered as one channel. Size 3
    takes Paeth's median-of-9 exchange network (19 min/max pairs, exact);
    other sizes sort the stacked window."""
    if size <= 1:
        return x
    squeeze = x.ndim < 3
    if squeeze:
        x = x[..., None]
    h_ax, w_ax = x.ndim - 3, x.ndim - 2
    hh = x.shape[h_ax] - size + 1
    ww = x.shape[w_ax] - size + 1
    p = [x.narrow(h_ax, dy, hh).narrow(w_ax, dx, ww)
         for dy in range(size) for dx in range(size)]
    if size == 3:
        def ex(i, j):
            p[i], p[j] = torch.minimum(p[i], p[j]), torch.maximum(p[i], p[j])

        ex(1, 2); ex(4, 5); ex(7, 8); ex(0, 1); ex(3, 4); ex(6, 7)  # noqa: E702
        ex(1, 2); ex(4, 5); ex(7, 8); ex(0, 3); ex(5, 8); ex(4, 7)  # noqa: E702
        ex(3, 6); ex(1, 4); ex(2, 5); ex(4, 7); ex(4, 2); ex(6, 4)  # noqa: E702
        ex(4, 2)
        med = p[4]
    else:
        k = (size * size - 1) // 2
        med = torch.sort(torch.stack(p, dim=-1), dim=-1).values[..., k]
    return med[..., 0] if squeeze else med


def flow_magnitude_mask(flow, max_magn: float):
    """1 where the flow is static, ramping to 0 at |flow| >= max_magn.

    flow: (..., H, W, 2) with (dx, dy) channels; 1 - min(|flow| / max_magn,
    1) (utils.lua:171-177)."""
    mag = torch.sqrt(torch.sum(flow * flow, dim=-1))
    return 1.0 - torch.clamp(mag / max_magn, max=1.0)


# Linear gradient masks for VR seam blending (utils.lua:179-213): (H, W)
# float32 ramps of i / (n + 1), values in (0, 1).

def gradient_mask_h_inc(h: int, w: int):
    ramp = torch.arange(1, h + 1, dtype=torch.float32) / (h + 1)
    return ramp[:, None].expand(h, w)


def gradient_mask_h_dec(h: int, w: int):
    ramp = torch.arange(h, 0, -1, dtype=torch.float32) / (h + 1)
    return ramp[:, None].expand(h, w)


def gradient_mask_w_inc(h: int, w: int):
    ramp = torch.arange(1, w + 1, dtype=torch.float32) / (w + 1)
    return ramp[None, :].expand(h, w)


def gradient_mask_w_dec(h: int, w: int):
    ramp = torch.arange(w, 0, -1, dtype=torch.float32) / (w + 1)
    return ramp[None, :].expand(h, w)
