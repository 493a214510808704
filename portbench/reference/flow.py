"""Streaming optical flow and its consistency check in plain float32
PyTorch: the benchmark's reference.

A frozen copy of the arithmetic of the compact PWC-style estimator
(four-level feature pyramid, radius-3 cost volume, coarse-to-fine
refinement with the banded two-pass feature warp, the dilated context
head), of the forward/backward consistency check of fast-artistic-videos'
``consistencyChecker.cpp`` (round trip, motion boundaries, structure term,
strict bounds), and of the streaming provider around them (flow at a
reduced scale, the warp band from the previous pair's signal, the mask
upsampled by nearest neighbour and optionally eroded). The provider takes
its estimator as a flow family (``reference/flow_<model>.py``; PWC-lite's,
``flow_pwclite.py``, reads the bundled ``flow_pwclite.npz``, HWIO kernels,
with numpy). It imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

PYRAMID_CHANNELS = (16, 32, 64, 96)
COST_RADIUS = 3
ESTIMATOR_LAYERS = 3
CONTEXT_DILATIONS = (1, 2, 4)
WARP_BAND = 8
STRIDE = 16
MOTION_BOUNDARY_VALUE = 255.0


def load_weights(path: str, device):
    """{name: {"w": OIHW, "b": (C,)}} float32 on `device` from the npz."""
    tree = {}
    with np.load(path) as z:
        for key in z.files:
            name, leaf = key.rsplit("/", 1)
            a = np.asarray(z[key], np.float32)
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            tree.setdefault(name, {})[leaf] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return tree


def flow_band(max_abs: float, minimum: int = 8) -> int:
    """Multiples of 8 up to 64, then powers of two, covering max_abs."""
    b = minimum
    while b < max_abs:
        b = b + 8 if b < 64 else b * 2
    return b


# ---------------------------------------------------------------------------
# the banded warp: a vertical two-tap pass by dy, then a horizontal one by
# dx over its result; a tap reads zero when its shift lies outside
# [-band, band + 1] or its source outside the image
# ---------------------------------------------------------------------------

def _banded_pass(x, off, band: int, dim: int):
    n = x.shape[dim]
    base = torch.floor(off)
    w0 = 1.0 - (off - base)
    s0 = base.to(torch.int64)
    shape = [1, 1, 1]
    shape[dim] = n
    pos = torch.arange(n, device=x.device).view(shape)
    out = torch.zeros_like(x)
    for j, wj in ((0, w0), (1, 1.0 - w0)):
        s = s0 + j
        src = pos + s
        ok = (s >= -band) & (s <= band + 1) & (src >= 0) & (src < n)
        idx = src.clamp(0, n - 1).unsqueeze(-1).expand(x.shape)
        out = out + torch.gather(x, dim, idx) * (wj * ok)[..., None]
    return out


def banded_warp(img, flow, band: int):
    """img (N, H, W, C), flow (N, H, W, 2) (dx, dy), float32."""
    v = _banded_pass(img.float(), flow[..., 1].float(), band, 1)
    return _banded_pass(v, flow[..., 0].float(), band, 2)


# ---------------------------------------------------------------------------
# the estimator
# ---------------------------------------------------------------------------

def _same_pads(n: int, k: int, stride: int, dilation: int = 1):
    out = -(-n // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - n, 0)
    return total // 2, total - total // 2


def _conv(params, name, x, stride=1, relu=True, dilation=1):
    """XLA-style SAME padding, the conv, then the bias (in that order)."""
    p = params[name]
    k = p["w"].shape[2]
    ph = _same_pads(x.shape[1], k, stride, dilation)
    pw = _same_pads(x.shape[2], k, stride, dilation)
    xc = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(xc, p["w"], None, stride, 0, dilation).permute(0, 2, 3, 1) + p["b"]
    return F.leaky_relu(y, 0.1) if relu else y


def pyramid(params, img):
    """Feature pyramid, finest first, of (N, H, W, 3) RGB [0, 1]."""
    feats, x = [], img - 0.45
    for lvl in range(len(PYRAMID_CHANNELS)):
        x = _conv(params, f"pyr{lvl}_a", x, stride=2)
        x = _conv(params, f"pyr{lvl}_b", x)
        feats.append(x)
    return feats


def _cost_volume(f1, f2w, radius: int = COST_RADIUS):
    n, h, w, c = f1.shape
    pad = F.pad(f2w, (0, 0, radius, radius, radius, radius))
    rows = [(f1 * pad[:, dy:dy + h, dx:dx + w, :]).sum(dim=-1) * (1.0 / c)
            for dy in range(2 * radius + 1) for dx in range(2 * radius + 1)]
    return torch.stack(rows, dim=-1)


def _up2(flow):
    return flow.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2) * 2.0


def refine(params, f1s, f2s):
    """Coarse-to-fine flow from two pyramids, at pyramid-input size."""
    flow = None
    for lvl in reversed(range(len(PYRAMID_CHANNELS))):
        f1, f2 = f1s[lvl], f2s[lvl]
        if flow is None:
            flow = torch.zeros(f1.shape[:3] + (2,), device=f1.device)
            f2w = f2
        else:
            flow = _up2(flow)
            f2w = banded_warp(f2, flow, WARP_BAND)
        x = torch.cat([F.leaky_relu(_cost_volume(f1, f2w), 0.1), f1, flow], dim=-1)
        for i in range(ESTIMATOR_LAYERS):
            x = _conv(params, f"est{lvl}_{i}", x)
        flow = flow + _conv(params, f"est{lvl}_out", x, relu=False)
        if lvl == 0 and "ctx_out" in params:
            # the context head: dilated convs over the finest estimator
            # features and the flow, predicting a residual
            cx = torch.cat([x, flow], dim=-1)
            for i, dil in enumerate(CONTEXT_DILATIONS):
                cx = _conv(params, f"ctx_{i}", cx, dilation=dil)
            flow = flow + _conv(params, "ctx_out", cx, relu=False)
    return _up2(flow)


def resize_bilinear(x, size):
    """(N, H, W, C) -> (N, h, w, C): half-pixel centres, antialiased when
    shrinking."""
    h, w = x.shape[1], x.shape[2]
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size), mode="bilinear",
                      align_corners=False, antialias=size[0] < h or size[1] < w)
    return y.permute(0, 2, 3, 1)


def scaled(h: int, w: int, scale: float):
    return (int(round(h * scale)), int(round(w * scale))) if scale != 1.0 else (h, w)


def prep(params, frames_u8, scale: float):
    """Pyramids of (N, H, W, 3) uint8 frames estimated at `scale`: resized,
    then edge-padded to a multiple of 16."""
    n, h, w = frames_u8.shape[:3]
    hs, ws = scaled(h, w, scale)
    x = frames_u8.float() / 255.0
    if (hs, ws) != (h, w):
        x = resize_bilinear(x, (hs, ws))
    hp, wp = -(-hs // STRIDE) * STRIDE, -(-ws // STRIDE) * STRIDE
    rows = torch.arange(hp, device=x.device).clamp(max=hs - 1)
    cols = torch.arange(wp, device=x.device).clamp(max=ws - 1)
    return pyramid(params, x[:, rows][:, :, cols])


# ---------------------------------------------------------------------------
# the consistency check
# ---------------------------------------------------------------------------

def _symmetric_pad(x, r: int, axis: int):
    n = x.shape[axis]
    return torch.cat([x.narrow(axis, 0, r).flip(axis), x,
                      x.narrow(axis, n - r, r).flip(axis)], dim=axis)


def central_diff(x, axis: int):
    xp = _symmetric_pad(x, 1, axis)
    n = x.shape[axis]
    return 0.5 * (xp.narrow(axis, 2, n) - xp.narrow(axis, 0, n))


def gaussian_smooth(img, sigma: float):
    radius = max(1, int(3.0 * sigma + 0.5))
    xs = torch.arange(-radius, radius + 1, dtype=torch.float32, device=img.device)
    k = torch.exp(-0.5 * (xs / sigma) ** 2)
    k = k / k.sum()
    out = img
    for axis in (0, 1):
        xp = _symmetric_pad(out, radius, axis)
        acc = torch.zeros_like(img)
        for i in range(2 * radius + 1):
            acc = acc + k[i] * xp.narrow(axis, i, img.shape[axis])
        out = acc
    return out


def structure_eigenvalue(image255, rho: float = 3.0):
    """Smallest eigenvalue of the smoothed structure tensor, in [0, 1]."""
    dx = central_diff(image255, 1)
    dy = central_diff(image255, 0)
    dxx = gaussian_smooth((dx * dx).sum(-1), rho)
    dyy = gaussian_smooth((dy * dy).sum(-1), rho)
    dxy = gaussian_smooth((dx * dy).sum(-1), rho)
    half = 0.5 * (dxx + dyy)
    disc = half * half + dxy * dxy - dxx * dyy
    ev = torch.where(disc < 0, torch.zeros_like(disc),
                     half - torch.sqrt(torch.clamp(disc, min=0.0)))
    lo, hi = ev.min(), ev.max()
    return (ev - lo) / torch.clamp(hi - lo, min=1e-12)


def _minpool(x, lo: int, hi: int, axis: int):
    n = x.shape[axis]
    idx = torch.arange(n, device=x.device)
    out = None
    for d in range(lo, hi + 1):
        t = x.index_select(axis, (idx + d).clamp(0, n - 1))
        out = t if out is None else torch.minimum(out, t)
    return out


def min_filter(x, size: int):
    """Erosion of (H, W) by a size x size window clipped at the borders."""
    k = size // 2
    return _minpool(_minpool(x, -k, k, 0), -k, k, 1)


def consistency(flow1, flow2, image01, band: int, warp_limit: float, out_hw,
                erode: int = 0):
    """(certainty (H', W') in [0, 1], band signal) of flow1 (h, w, 2)
    cross-checked against flow2 at the flow's resolution, with the
    structure term of image01 resized to it; the mask is upsampled by
    nearest neighbour to out_hw and eroded by `erode` where it is not 0."""
    h, w = flow1.shape[:2]
    image = image01.float()
    if tuple(image.shape[:2]) != (h, w):
        image = resize_bilinear(image[None], (h, w))[0]
    dev = flow1.device
    xs = torch.arange(w, dtype=torch.float32, device=dev).view(1, w).expand(h, w)
    ys = torch.arange(h, dtype=torch.float32, device=dev).view(h, 1).expand(h, w)
    bx, by = xs + flow1[..., 0], ys + flow1[..., 1]
    x1, y1 = torch.floor(bx), torch.floor(by)
    in_bounds = (x1 >= 0) & (x1 + 1 <= w - 1) & (y1 >= 0) & (y1 + 1 <= h - 1)
    uv = banded_warp(flow2[None], flow1[None], band)[0]
    roundtrip = (bx + uv[..., 0] - xs) ** 2 + (by + uv[..., 1] - ys) ** 2
    mag = (flow1 * flow1).sum(-1) + (uv * uv).sum(-1)
    structure = structure_eigenvalue(image * 255.0)
    avg = structure.mean()
    structure_term = 4.0 / avg * torch.clamp(avg / 2.0 - structure, min=0.0)
    inconsistent = roundtrip >= 0.01 * mag + structure_term + 0.5
    dfx, dfy = central_diff(flow1, 1), central_diff(flow1, 0)
    edge = (dfx * dfx).sum(-1) + (dfy * dfy).sum(-1)
    boundary = edge > 0.01 * (flow1 * flow1).sum(-1) + 0.002
    rel = torch.full((h, w), 255.0, device=dev)
    rel = torch.where(boundary, torch.full_like(rel, MOTION_BOUNDARY_VALUE), rel)
    zero = torch.zeros_like(rel)
    rel = torch.where(inconsistent, zero, rel)
    rel = torch.where(in_bounds, rel, zero)
    absf = torch.maximum(flow1[..., 0].abs(), flow1[..., 1].abs())
    ok = (rel > 0.0).float()
    signal = torch.where(ok.mean() < 0.05, absf.max(), (absf * ok).max())
    # the warp-limit backstop, violations dilated by one flow pixel
    within = (absf <= warp_limit).float()
    mask = rel * _minpool(_minpool(within, -1, 1, 0), -1, 1, 1)
    hh, ww = out_hw
    if (hh, ww) != (h, w):
        fh, fw = hh // h, ww // w
        if (fh * h, fw * w) != (hh, ww):
            raise ValueError(f"the reference upsamples by whole factors only: {(h, w)} -> {out_hw}")
        mask = mask.repeat_interleave(fh, 0).repeat_interleave(fw, 1)
    if erode:
        mask = min_filter(mask, erode)
    return torch.clamp(mask, 0.0, 255.0) / 255.0, signal


class StreamingFlow:
    """One stream's (or one batch of synchronised streams') flow by the
    estimator of a flow family (``reference/flow_<model>.py``): call it
    with (N, H, W, 3) uint8 frames in playback order; it returns None for
    the first, else (backward flows (N, H, W, 2), certainties (N, H, W),
    engine band). The band of a pair comes from the previous pair's signal
    (its own maximum for the first pair), one bucket for the whole batch."""

    def __init__(self, family, params, scale: float, erode: int = 0):
        self.family, self.params, self.scale, self.erode = family, params, scale, erode
        self._prev = None
        self._signal = None

    @torch.no_grad()
    def __call__(self, frames_u8):
        n, h, w = frames_u8.shape[:3]
        est = self.family
        feats = est.features(self.params, frames_u8, self.scale)
        prev, self._prev = self._prev, feats
        if prev is None:
            return None
        hs, ws = est.scaled(h, w, self.scale)
        low_ab = est.pair(self.params, feats, prev)[:, :hs, :ws]
        low_ba = est.pair(self.params, prev, feats)[:, :hs, :ws]
        first = float(low_ab.abs().max()) if self._signal is None else self._signal
        warp_low = flow_band(first)
        band = flow_band(warp_low / self.scale) if self.scale != 1.0 else warp_low
        full = low_ab
        if (hs, ws) != (h, w):
            full = resize_bilinear(low_ab, (h, w)) / self.scale
        limit_low = band * hs / h
        certs, signals = [], []
        for i in range(n):
            c, s = consistency(low_ab[i], low_ba[i], frames_u8[i].float() / 255.0,
                               2 * warp_low, limit_low, (h, w), self.erode)
            certs.append(c)
            signals.append(s)
        self._signal = float(torch.stack(signals).max())
        return full, torch.stack(certs), band
