"""Bilinear flow warp — counterpart of ``fast_artistic_videos_tpu/ops/warp.py``.

    out[y, x] = bilinear_sample(img, y + dy[y, x], x + dx[y, x])

with absolute pixel offsets, floor-based corners and zero for every tap
outside the image (stnbdhw/BilinearSamplerBDHW.cu:48-109). Layout: NHWC
images, flow (..., H, W, 2) with channel 0 = dx, 1 = dy.

``band=None`` is the exact gather (``_warp_single``); an integer band takes
the banded two-pass form (``_warp_banded_single``, kernel K1 on CUDA), which
is exact where dy is locally constant and reads zero beyond the band.
"""

from __future__ import annotations

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


def _warp_banded_single(img, flow, band: int):
    """Banded warp of img (N, H, W, C) by flow (N, H, W, 2): kernel K1 on a
    CUDA tensor, its plain version on a CPU tensor."""
    return warp_kernel.warp_banded(img.contiguous(), flow.float().contiguous(), band)


def bilinear_warp(img, flow, band: int | None = None):
    """Warp ``img`` by absolute-offset ``flow`` with zero out-of-bounds taps.

    img:  (H, W, C) or (N, H, W, C)
    flow: (H, W, 2) or (N, H, W, 2), channels (dx, dy)
    band: bound on |flow| selecting the banded path (kernel K1 on CUDA);
          None uses the exact gather.
    """
    if img.ndim not in (3, 4):
        raise ValueError(f"img must be HWC or NHWC, got shape {tuple(img.shape)}")
    single = img.ndim == 3
    x = img[None] if single else img
    f = flow[None] if flow.ndim == 3 else flow
    if f.shape[0] != x.shape[0]:
        f = f.expand(x.shape[0], *f.shape[1:])
    out = _warp_single(x, f) if band is None else _warp_banded_single(x, f, band)
    return out[0] if single else out


def flow_band(max_abs_flow: float, minimum: int = 8) -> int:
    """Band bucket covering `max_abs_flow`: multiples of 8 up to 64, then
    powers of two (the JAX package's buckets, so both pick the same band)."""
    b = minimum
    while b < max_abs_flow:
        b = b + 8 if b < 64 else b * 2
    return b
