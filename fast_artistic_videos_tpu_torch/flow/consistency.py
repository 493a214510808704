"""Forward/backward flow consistency check — counterpart of
``fast_artistic_videos_tpu/flow/consistency.py`` (``consistency_mask``,
``consistency_mask_streaming`` and its batch form).

Decision rules (consistencyChecker.cpp:80-134):

  reliable(x) = 0    if any bilinear corner of x + f1(x) is out of bounds
  reliable(x) = 0    if |x + f1(x) + f2(x + f1(x)) - x|^2
                        >= 0.01*(|f1(x)|^2 + |f2_w(x)|^2) + structure_term + 0.5
  reliable(x) = 255  if |grad f1(x)|^2 > 0.01*|f1(x)|^2 + 0.002 (motion boundary)
  reliable(x) = 255  otherwise

with central differences under symmetric boundaries and the structure term
from the smallest eigenvalue of the FIR-Gaussian-smoothed structure tensor.
With a band, the sample of f2 at x + f1(x) is the banded warp (kernel K1
on CUDA). Flow is (H, W, 2) float32 (dx, dy).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops import warp as warp_ops

MOTION_BOUNDARY_VALUE = 255.0


def _symmetric_pad(x, r: int, axis: int):
    """numpy's "symmetric" padding (edge sample repeated) by r on one axis."""
    n = x.shape[axis]
    lo = x.narrow(axis, 0, r).flip(axis)
    hi = x.narrow(axis, n - r, r).flip(axis)
    return torch.cat([lo, x, hi], dim=axis)


def central_diff(x, axis: int):
    """[-1/2, 0, 1/2] derivative with symmetric (half-sample) boundary."""
    xp = _symmetric_pad(x, 1, axis)
    n = x.shape[axis]
    return 0.5 * (xp.narrow(axis, 2, n) - xp.narrow(axis, 0, n))


def gaussian_kernel(sigma: float, device="cpu"):
    radius = max(1, int(3.0 * sigma + 0.5))
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def gaussian_smooth(img, sigma: float):
    """Separable FIR Gaussian with symmetric boundary; img (H, W)."""
    k = gaussian_kernel(sigma, device=img.device)
    r = (k.shape[0] - 1) // 2
    out = img
    for axis in (0, 1):
        xp = _symmetric_pad(out, r, axis)
        acc = torch.zeros_like(img)
        for i in range(2 * r + 1):
            acc = acc + k[i] * xp.narrow(axis, i, img.shape[axis])
        out = acc
    return out


def structure_smallest_eigenvalue(image, rho: float = 3.0):
    """Smallest eigenvalue of the smoothed structure tensor, normalized to
    [0, 1]. image: (H, W, C) in the 0-255 scale."""
    dx = central_diff(image, 1)
    dy = central_diff(image, 0)
    dxx = gaussian_smooth((dx * dx).sum(-1), rho)
    dyy = gaussian_smooth((dy * dy).sum(-1), rho)
    dxy = gaussian_smooth((dx * dy).sum(-1), rho)
    half_trace = 0.5 * (dxx + dyy)
    disc = half_trace * half_trace + dxy * dxy - dxx * dyy
    ev = torch.where(disc < 0, torch.zeros_like(disc),
                     half_trace - torch.sqrt(torch.clamp(disc, min=0.0)))
    lo, hi = ev.min(), ev.max()
    return (ev - lo) / torch.clamp(hi - lo, min=1e-12)


def _sample_flow_strict(flow2, bx, by):
    """Bilinear sample of flow2 at (bx, by) and whether all four corners lie
    inside the image."""
    h, w = flow2.shape[0], flow2.shape[1]
    x1 = torch.floor(bx)
    y1 = torch.floor(by)
    in_bounds = (x1 >= 0) & (x1 + 1 <= w - 1) & (y1 >= 0) & (y1 + 1 <= h - 1)
    ax = (bx - x1)[..., None]
    ay = (by - y1)[..., None]
    x1i = x1.to(torch.int64).clamp(0, w - 2)
    y1i = y1.to(torch.int64).clamp(0, h - 2)
    flat = flow2.reshape(h * w, 2)
    idx = y1i * w + x1i

    def take(offset):
        return flat[(idx + offset).reshape(-1)].reshape(idx.shape + (2,))

    top = take(0) * (1 - ax) + take(1) * ax
    bot = take(w) * (1 - ax) + take(w + 1) * ax
    return top * (1 - ay) + bot * ay, in_bounds


def _consistency_impl(flow1, flow2, image, use_structure: bool, band=None,
                      rho: float = 3.0, warp_limit=None, with_rel_maxabs: bool = False):
    """The check on (H, W, 2) flows; returns the 0-255 mask, and with
    with_rel_maxabs also the band-sizing signal (0-d tensor)."""
    h, w = flow1.shape[0], flow1.shape[1]
    dev = flow1.device
    xs = torch.arange(w, dtype=torch.float32, device=dev).view(1, w).expand(h, w)
    ys = torch.arange(h, dtype=torch.float32, device=dev).view(h, 1).expand(h, w)
    bx = xs + flow1[..., 0]
    by = ys + flow1[..., 1]
    if band is None:
        uv, in_bounds = _sample_flow_strict(flow2, bx, by)
    else:
        x1 = torch.floor(bx)
        y1 = torch.floor(by)
        in_bounds = (x1 >= 0) & (x1 + 1 <= w - 1) & (y1 >= 0) & (y1 + 1 <= h - 1)
        uv = warp_ops.bilinear_warp(flow2, flow1, band=band)
    cx = bx + uv[..., 0]
    cy = by + uv[..., 1]
    roundtrip = (cx - xs) ** 2 + (cy - ys) ** 2
    mag = (flow1 * flow1).sum(-1) + (uv * uv).sum(-1)
    if use_structure:
        structure = structure_smallest_eigenvalue(image * 255.0, rho)
        avg = structure.mean()
        structure_term = 4.0 / avg * torch.clamp(avg / 2.0 - structure, min=0.0)
    else:
        structure_term = torch.zeros((h, w), device=dev)
    inconsistent = roundtrip >= 0.01 * mag + structure_term + 0.5

    dx = central_diff(flow1, 1)
    dy = central_diff(flow1, 0)
    motion_edge = (dx * dx).sum(-1) + (dy * dy).sum(-1)
    is_boundary = motion_edge > 0.01 * (flow1 * flow1).sum(-1) + 0.002

    reliable = torch.full((h, w), 255.0, device=dev)
    reliable = torch.where(is_boundary, torch.full_like(reliable, MOTION_BOUNDARY_VALUE),
                           reliable)
    zero = torch.zeros_like(reliable)
    reliable = torch.where(inconsistent, zero, reliable)
    reliable = torch.where(in_bounds, reliable, zero)
    rel_max = None
    absf = torch.maximum(flow1[..., 0].abs(), flow1[..., 1].abs())
    if with_rel_maxabs:
        # max |flow1| over the pixels that pass the check, before the
        # warp_limit backstop; the raw max when under 5 % pass
        ok = (reliable > 0.0).float()
        rel_max = torch.where(ok.mean() < 0.05, absf.max(), (absf * ok).max())
    if warp_limit is not None:
        reliable = torch.where(absf > warp_limit, zero, reliable)
    out = torch.clamp(reliable, 0.0, 255.0)
    if with_rel_maxabs:
        return out, rel_max
    return out


def _minpool_axis(x, lo: int, hi: int, axis: int):
    """min over the window [i + lo, i + hi] with border clamping."""
    n = x.shape[axis]
    idx = torch.arange(n, device=x.device)
    out = None
    for d in range(lo, hi + 1):
        t = x.index_select(axis, (idx + d).clamp(0, n - 1))
        out = t if out is None else torch.minimum(out, t)
    return out


def _eroded_nearest_up(mask, fh: int, fw: int, window: int):
    """Exactly min_filter(nearest_upsample(mask, (fh, fw)), window),
    computed at low resolution: full-res row fh*i + v sees the low rows
    [(v-k)//fh, (v+k)//fh] around i, so there are fh (fw) distinct row
    (column) erosions, interleaved by output parity."""
    k = window // 2
    hs, ws = mask.shape
    rows = []
    for vr in range(fh):
        r0, r1 = (vr - k) // fh, (vr + k) // fh
        mr = _minpool_axis(mask, r0, r1, 0)
        cols = [_minpool_axis(mr, (vc - k) // fw, (vc + k) // fw, 1) for vc in range(fw)]
        rows.append(torch.stack(cols, dim=-1).reshape(hs, ws * fw))
    return torch.stack(rows, dim=1).reshape(hs * fh, ws * fw)


def _streaming_impl(flow1, flow2, image, out_hw, use_structure, band, rho,
                    erode_window=None, warp_limit=None, with_rel_maxabs=False):
    hs, ws = flow1.shape[0], flow1.shape[1]
    h, w = out_hw
    if image.dtype == torch.uint8:
        image = image.float() / 255.0
    image = image.float()
    if use_structure and tuple(image.shape[:2]) != (hs, ws):
        from .estimator import resize_bilinear

        image = resize_bilinear(image, (hs, ws))
    out = _consistency_impl(flow1, flow2, image, use_structure, band, rho,
                            with_rel_maxabs=with_rel_maxabs)
    mask, rel_max = out if with_rel_maxabs else (out, None)
    if warp_limit is not None:
        # backstop at flow resolution, violations dilated by one pixel: the
        # engine's full-res flow is a bilinear upsample of flow1
        ok = (torch.maximum(flow1[..., 0].abs(), flow1[..., 1].abs())
              <= warp_limit).float()
        mask = mask * _minpool_axis(_minpool_axis(ok, -1, 1, 0), -1, 1, 1)
    if (hs, ws) != (h, w):
        fh, fw = h // hs, w // ws
        if (fh * hs, fw * ws) == (h, w):
            if erode_window:
                mask = _eroded_nearest_up(mask, fh, fw, erode_window)
            else:
                mask = mask.repeat_interleave(fh, 0).repeat_interleave(fw, 1)
        else:
            mask = F.interpolate(mask[None, None], size=(h, w), mode="nearest-exact")[0, 0]
            if erode_window:
                k = erode_window // 2
                mask = _minpool_axis(_minpool_axis(mask, -k, k, 0), -k, k, 1)
    elif erode_window:
        k = erode_window // 2
        mask = _minpool_axis(_minpool_axis(mask, -k, k, 0), -k, k, 1)
    return mask, rel_max


@torch.no_grad()
def consistency_mask_streaming(flow1, flow2, image=None, out_hw=None, rho: float = 3.0,
                               band=None, erode_window=None, warp_limit=None,
                               with_rel_maxabs: bool = False):
    """Consistency check at the flow's own resolution, the mask upsampled
    (nearest) to out_hw and optionally eroded there (erode_window, exact,
    computed at flow resolution). image: the full-res (H, W, 3) frame,
    uint8 or [0, 1], resized to the flow's grid for the structure term.
    warp_limit: engine warp band in flow1's pixel units; pixels beyond it
    (dilated by one flow pixel) are unreliable. Returns the [0, 1] mask,
    and with with_rel_maxabs the band-sizing signal."""
    out_hw = tuple(out_hw) if out_hw is not None else tuple(flow1.shape[:2])
    use_structure = image is not None
    if image is None:
        image = torch.zeros(tuple(flow1.shape[:2]) + (1,), device=flow1.device)
    if warp_limit is not None:
        warp_limit = float(warp_limit)
    mask, rel_max = _streaming_impl(flow1, flow2, image, out_hw, use_structure, band,
                                    float(rho), erode_window, warp_limit,
                                    with_rel_maxabs)
    if with_rel_maxabs:
        return mask / 255.0, rel_max
    return mask / 255.0


@torch.no_grad()
def consistency_mask_streaming_batch(flow1, flow2, images=None, out_hw=None,
                                     rho: float = 3.0, band=None, warp_limit=None,
                                     with_rel_maxabs: bool = False):
    """:func:`consistency_mask_streaming` over N independent pairs: flow1 /
    flow2 (N, H, W, 2), images (N, H, W, C) or None. Returns the (N, H', W')
    masks, each item exactly as its own call (per-item structure
    normalization), and with with_rel_maxabs one band-sizing signal: the
    maximum over the whole batch."""
    n = flow1.shape[0]
    outs = [consistency_mask_streaming(
        flow1[i], flow2[i], None if images is None else images[i], out_hw=out_hw,
        rho=rho, band=band, warp_limit=warp_limit, with_rel_maxabs=with_rel_maxabs)
        for i in range(n)]
    if not with_rel_maxabs:
        return torch.stack(outs)
    return (torch.stack([m for m, _ in outs]),
            torch.stack([r for _, r in outs]).max())


@torch.no_grad()
def consistency_mask(flow1, flow2, image=None, rho: float = 3.0, band=None,
                     warp_limit=None, with_rel_maxabs: bool = False):
    """Reliability of flow1 cross-checked against flow2, (H, W) in [0, 1].
    image: optional (H, W, C) in [0, 1]. band: the banded sample (None: the
    exact gather). warp_limit and with_rel_maxabs as in
    :func:`consistency_mask_streaming`."""
    use_structure = image is not None
    if image is None:
        image = torch.zeros(tuple(flow1.shape[:2]) + (1,), device=flow1.device)
    out = _consistency_impl(flow1, flow2, image.float(), use_structure, band, float(rho),
                            warp_limit=None if warp_limit is None else float(warp_limit),
                            with_rel_maxabs=with_rel_maxabs)
    if with_rel_maxabs:
        return out[0] / 255.0, out[1]
    return out / 255.0
