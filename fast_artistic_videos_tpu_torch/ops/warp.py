"""Bilinear flow warp — counterpart of ``fast_artistic_videos_tpu/ops/warp.py``.

    out[y, x] = bilinear_sample(img, y + dy[y, x], x + dx[y, x])

with absolute pixel offsets, floor-based corners and zero for every tap
outside the image (stnbdhw/BilinearSamplerBDHW.cu:48-109). Layout: NHWC
images, flow (..., H, W, 2) with channel 0 = dx, 1 = dy.

``band=None`` is the exact gather (``_warp_single``); an integer band takes
the banded two-pass form (``_warp_banded_single``, kernel K1 on CUDA), which
is exact where dy is locally constant and reads zero beyond the band.
K1 has no backward: a caller that differentiates through the banded form
asks for its plain PyTorch version with ``differentiable=True``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import warp_kernel


def _warp_single(img, flow):
    """img (N, H, W, C); flow (N, Ho, Wo, 2). Exact reference gather in the
    promoted (at least float32) dtype."""
    n, h, w, c = img.shape
    ho, wo = flow.shape[1], flow.shape[2]
    cdt = torch.promote_types(img.dtype, torch.float32)
    ys = torch.arange(ho, device=img.device, dtype=cdt).view(1, ho, 1)
    xs = torch.arange(wo, device=img.device, dtype=cdt).view(1, 1, wo)
    xf = xs + flow[..., 0].to(cdt)
    yf = ys + flow[..., 1].to(cdt)
    x0 = torch.floor(xf)
    y0 = torch.floor(yf)
    wx0 = 1.0 - (xf - x0)
    wy0 = 1.0 - (yf - y0)
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    flat = img.reshape(n, h * w, c)

    def tap(yi, xi, weight):
        valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(n, -1, 1)
        vals = torch.gather(flat, 1, idx.expand(n, ho * wo, c)).reshape(n, ho, wo, c)
        return vals.to(cdt) * (weight * valid)[..., None]

    out = (tap(y0i, x0i, wy0 * wx0)
           + tap(y0i, x0i + 1, wy0 * (1.0 - wx0))
           + tap(y0i + 1, x0i, (1.0 - wy0) * wx0)
           + tap(y0i + 1, x0i + 1, (1.0 - wy0) * (1.0 - wx0)))
    return out.to(img.dtype)


def _warp_banded_single(img, flow, band: int, differentiable: bool = False):
    """Banded warp of img (N, H, W, C) by flow (N, H, W, 2): kernel K1 on a
    CUDA tensor, its plain version on a CPU tensor or with differentiable
    (autograd through torch ops, on any device)."""
    if differentiable:
        return warp_kernel.warp_banded_plain(img, flow, band)
    return warp_kernel.warp_banded(img.contiguous(), flow.float().contiguous(), band)


def bilinear_warp(img, flow, band: int | None = None, differentiable: bool = False):
    """Warp ``img`` by absolute-offset ``flow`` with zero out-of-bounds taps.

    img:  (H, W, C) or (N, H, W, C)
    flow: (H, W, 2) or (N, H, W, 2), channels (dx, dy)
    band: bound on |flow| selecting the banded path (kernel K1 on CUDA);
          None uses the exact gather.
    differentiable: with a band, the banded form's plain PyTorch version on
          every device (the flow estimator's training pass; K1 has no
          backward). The exact gather is differentiable as it is.
    """
    if img.ndim not in (3, 4):
        raise ValueError(f"img must be HWC or NHWC, got shape {tuple(img.shape)}")
    single = img.ndim == 3
    x = img[None] if single else img
    f = flow[None] if flow.ndim == 3 else flow
    if f.shape[0] != x.shape[0]:
        f = f.expand(x.shape[0], *f.shape[1:])
    out = (_warp_single(x, f) if band is None
           else _warp_banded_single(x, f, band, differentiable))
    return out[0] if single else out


def make_static_warp(map_np, sentinel: float = 9999.0):
    """``bilinear_warp`` specialized for a precomputed host offset map that
    maps only a sub-rectangle of the output (the VR border maps: sentinel
    offsets everywhere but an overlap-wide strip; vr_helper.lua:3-92).

    Once, on the host: the output bounding box of the mapped pixels and the
    source bounding box their four taps can touch. The returned
    ``warp(img)`` crops the source to that box, runs the exact gather for
    the strip only and zero-pads back to the full frame: the same result as
    ``bilinear_warp(img, map)`` (taps outside the image read zero). img is
    (H, W, C) or (N, H, W, C); a batch shares the map."""
    map_np = np.asarray(map_np, np.float32)
    ho, wo = map_np.shape[:2]
    mapped = np.all(np.abs(map_np) < sentinel / 2, axis=-1)
    if not mapped.any():
        def warp_none(img):
            return img.new_zeros(tuple(img.shape[:-3]) + (ho, wo, img.shape[-1]))
        return warp_none
    rows = np.where(mapped.any(axis=1))[0]
    cols = np.where(mapped.any(axis=0))[0]
    y0, y1 = int(rows[0]), int(rows[-1]) + 1
    x0, x1 = int(cols[0]), int(cols[-1]) + 1
    sub = map_np[y0:y1, x0:x1]
    sub_mapped = mapped[y0:y1, x0:x1]
    # absolute source coordinates of the mapped pixels' top-left taps
    gy = (np.arange(y0, y1, dtype=np.float64)[:, None] + sub[..., 1])[sub_mapped]
    gx = (np.arange(x0, x1, dtype=np.float64)[None, :] + sub[..., 0])[sub_mapped]
    sy0, sy1 = int(np.floor(gy.min())), int(np.floor(gy.max())) + 2
    sx0, sx1 = int(np.floor(gx.min())), int(np.floor(gx.max())) + 2
    # offsets relative to the cropped source and the cropped output
    adj = sub.copy()
    adj[..., 0] += (x0 - sx0)
    adj[..., 1] += (y0 - sy0)
    adj_t = torch.from_numpy(adj)

    def warp(img):
        single = img.ndim == 3
        x = img[None] if single else img
        h, w = x.shape[1], x.shape[2]
        # clip the crop to the image (sentinel taps stay far out of bounds
        # after the shift and keep reading zero)
        ya, yb = max(sy0, 0), min(sy1, h)
        xa, xb = max(sx0, 0), min(sx1, w)
        m = adj_t.to(x.device)
        if (ya, xa) != (sy0, sx0):
            m = m + torch.tensor([sx0 - xa, sy0 - ya], dtype=m.dtype, device=m.device)
        src = x[:, ya:yb, xa:xb]
        strip = _warp_single(src, m[None].expand(x.shape[0], *m.shape))
        out = strip.new_zeros((x.shape[0], ho, wo, x.shape[3]))
        out[:, y0:y1, x0:x1] = strip
        return out[0] if single else out

    return warp


def flow_band(max_abs_flow: float, minimum: int = 8) -> int:
    """Band bucket covering `max_abs_flow`: multiples of 8 up to 64, then
    powers of two (the JAX package's buckets, so both pick the same band)."""
    b = minimum
    while b < max_abs_flow:
        b = b + 8 if b < 64 else b * 2
    return b


def warp_weight_map(flow, h: int, w: int):
    """Total bilinear tap weight landing in-bounds for each output pixel:
    the exact warp of an all-ones (h, w) image by `flow` (..., h, w, 2).
    ``fix_occlusions`` (fast_artistic_video.lua:79-86) thresholds it to
    find the unmapped regions."""
    ones = torch.ones(tuple(flow.shape[:-1]) + (1,), dtype=flow.dtype,
                      device=flow.device)
    return bilinear_warp(ones, flow)[..., 0]
