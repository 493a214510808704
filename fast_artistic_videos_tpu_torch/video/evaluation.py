"""Quantitative evaluation — the reference's ``-evaluate`` mode; counterpart
of ``fast_artistic_videos_tpu/video/evaluation.py``.

2D video (fast_artistic_video.lua:128-151 + core.lua:101-106):
  per frame: [style_loss, content_loss, temporal_loss] where the perceptual
  terms come from the VGG loss network against the style image and the
  current content frame, and the temporal term is the MSE between the
  flow-warped previous stylized frame and the current one, masked by the
  ground-truth (e.g. Sintel) occlusion map. ``backward_eval`` warps the
  current frame backward instead (for forward-only GT flow).

VR (fast_artistic_video_vr.lua:312-452): adds per-face seam metrics —
  gradient ratios along stitch borders (masked/unmasked mean gradient) and
  cross-face edge MSE.

Everything runs on the device of the tensors it is given (the scorer's on
its own ``device``, the card unless ``device="cpu"``), in float32 with TF32
off, whatever dtype the stylizer ran in; only Python floats come back to
the host. The temporal term uses the exact gather warp (``band=None``), not
the banded kernel. The seam metrics are torch ops where the JAX version
runs numpy.

Reference quirks handled deliberately (as in the JAX version):
  * evaluate_edge_top ignores its first argument and compares img2's top row
    against img2's own edge (:327-341) — we compare img1's top row against
    img2's edge, which is plainly what was meant.
  * the VR eval reads the undeclared opt.reliable_map_min_filter (nil at
    runtime, :408-424) — we use occlusions_min_filter.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core import device as device_mod
from ..core import io
from ..core.config import StylizeOptions, format_flow_name, parse_layers
from ..flow.estimator import resize_bilinear
from ..models import checkpoint, t7
from ..ops import filters, warp
from ..ops.preprocess import vgg_preprocess
from ..train import losses


def load_vgg_params(path: str, device=device_mod.DEFAULT):
    """VGG-16 loss-network weights as OIHW tensors on `device` (the card
    unless ``device="cpu"``): either the flattened .npz produced by the t7
    importer (keys 'convNN/w'), or a Torch vgg16.t7 directly."""
    if path.endswith(".t7"):
        params = t7.import_vgg16(t7.load_t7(path))
    else:
        params = {}
        with np.load(path) as z:
            for k in z.files:
                layer, leaf = k.rsplit("/", 1)
                params.setdefault(layer, {})[leaf] = z[k]
    return checkpoint.params_from_numpy(params, device)


def _dev(x) -> torch.device:
    """The device of a tensor; the CPU for numpy arrays."""
    return x.device if torch.is_tensor(x) else torch.device("cpu")


def _f32(x, device=None) -> torch.Tensor:
    """An array (numpy or tensor) as a float32 tensor on `device` (default:
    where it is)."""
    t = x if torch.is_tensor(x) else torch.from_numpy(np.ascontiguousarray(x))
    return t.to(device if device is not None else t.device, torch.float32)


class PerceptualScorer:
    """Style/content scoring of a stylized frame (core.lua:76-106)."""

    def __init__(self, opt: StylizeOptions, device=device_mod.DEFAULT):
        style_layers, style_weights = parse_layers(opt.style_layers, opt.style_weights)
        content_layers, content_weights = parse_layers(opt.content_layers, opt.content_weights)
        self.cfg = losses.PerceptualConfig(
            style_layers=tuple(int(l) for l in style_layers),
            style_weights=tuple(style_weights),
            content_layers=tuple(int(l) for l in content_layers),
            content_weights=tuple(content_weights),
            agg_type=opt.style_target_type,
        )
        if not opt.loss_network:
            raise ValueError("--evaluate requires --loss_network (VGG-16 weights)")
        self.device = device_mod.resolve(device)
        self.vgg_params = load_vgg_params(opt.loss_network, self.device)
        style = _scale_shorter(_f32(io.load_image(opt.style_image), self.device),
                               opt.style_image_size)
        with torch.no_grad():
            self.style_tgts = losses.style_targets(
                self.vgg_params, vgg_preprocess(style)[None], self.cfg)

    @torch.no_grad()
    def __call__(self, content, stylized):
        """(style, content) losses of a stylized frame, as Python floats (one
        copy to the host)."""
        x = vgg_preprocess(_f32(stylized, self.device))[None]
        tgt = vgg_preprocess(_f32(content, self.device))[None]
        _, per_layer = losses.perceptual_loss(self.vgg_params, x, tgt, self.style_tgts,
                                              self.cfg)
        style = sum(v for k, v in per_layer.items() if k.startswith("style"))
        cont = sum(v for k, v in per_layer.items() if k.startswith("content"))
        style, cont = torch.stack([torch.as_tensor(v, device=self.device).float()
                                   for v in (style, cont)]).tolist()
        return style, cont


@torch.no_grad()
def temporal_error(prev_stylized, stylized, flow, cert, backward_eval=False):
    """Masked warp MSE (fast_artistic_video.lua:133-146). cert: (H, W).
    Runs on stylized's device (numpy inputs: the CPU)."""
    dev = _dev(stylized)
    prev, cur = _f32(prev_stylized, dev), _f32(stylized, dev)
    flow, c3 = _f32(flow, dev), _f32(cert, dev)[..., None]
    if backward_eval:
        a, b = warp.bilinear_warp(cur, flow) * c3, prev * c3
    else:
        a, b = warp.bilinear_warp(prev, flow) * c3, cur * c3
    return float(((a - b) ** 2).mean())


class VideoEvaluator:
    """eval_fn for VideoDriver: returns [style, content, temporal] per frame
    (core.lua:214-226 ordering). The scorer runs on `device`; the temporal
    term on the stylized frame's device."""

    def __init__(self, opt: StylizeOptions, device=device_mod.DEFAULT):
        self.opt = opt
        self.scorer = PerceptualScorer(opt, device)

    def __call__(self, i: int, content, stylized, prev_stylized) -> List[float]:
        opt = self.opt
        style, cont = self.scorer(content, stylized)
        temporal = 0.0
        if i > 1 and prev_stylized is not None and opt.flow_pattern_eval:
            dev = _dev(stylized)
            flow = _f32(io.read_flo(format_flow_name(opt.flow_pattern_eval, i - 1, i)), dev)
            cert = _f32(io.load_image(
                format_flow_name(opt.occlusions_pattern_eval, i - 1, i), num_channels=1
            )[..., 0], dev)
            if opt.invert_occlusion_eval:
                cert = 1.0 - cert
            if opt.fix_occlusions_eval:
                from .driver_video import fix_occlusions_mask

                cert = fix_occlusions_mask(cert, flow)
            temporal = temporal_error(prev_stylized, stylized, flow, cert,
                                      opt.backward_eval)
        return [style, cont, temporal]


def write_eval_file(path: str, rows: List[List[float]]) -> None:
    """Append the evaluation rows in the reference format (core.lua:231-240):
    one semicolon-joined series per metric, then per-metric means, divided
    by the number of rows actually evaluated (core.lua:237 divides by
    opt.num_frames, 9999 by default; the JAX package fixes that the same
    way)."""
    cols = list(zip(*rows))
    with open(path, "a") as f:
        for series in cols:
            f.write(";".join(str(v) for v in series) + "\n")
        for series in cols:
            f.write(str(sum(series) / max(1, len(series))) + "\n")


# ---------------------------------------------------------------------------
# VR seam metrics
# ---------------------------------------------------------------------------

def _grad_valid(img, axis: int):
    """|central difference| over channels-max, valid region (the reference's
    max over per-channel |torch.conv2(x, [-1,0,1], 'V')|, :344-358)."""
    if axis == 1:
        g = (img[:, 2:] - img[:, :-2]).abs()
    else:
        g = (img[2:] - img[:-2]).abs()
    return g.amax(dim=-1)


def _maxpool3_same(x):
    """3x3 max over a (H, W) map, the borders padded with -inf."""
    return F.max_pool2d(x[None, None], 3, 1, 1)[0, 0]


@torch.no_grad()
def gradient_ratios(img, mask):
    """Seam gradient ratios (fast_artistic_video_vr.lua:344-387): how much
    stronger image gradients are along mask edges vs the whole face. img
    (H, W, C), mask (H, W), on img's device."""
    img = _f32(img)
    mask = _f32(mask, img.device)
    gx = _grad_valid(img, 1)              # (H, W-2)
    gy = _grad_valid(img, 0)              # (H-2, W)
    mask3 = mask[..., None]
    mgx = _maxpool3_same(_grad_valid(mask3, 1))
    mgy = _maxpool3_same(_grad_valid(mask3, 0))
    sx, sy, smx, smy, mx, my = torch.stack([
        gx.sum(), gy.sum(), (gx * mgx).sum(), (gy * mgy).sum(), mgx.sum(), mgy.sum()
    ]).tolist()
    full_x, full_y = sx / gx.numel(), sy / gy.numel()
    rx = smx / max(mx, 1e-12) / max(full_x, 1e-12)
    ry = smy / max(my, 1e-12) / max(full_y, 1e-12)
    rmag = (rx * mx + ry * my) / max(mx + my, 1e-12)
    return float(rx), float(ry), float(rmag)


def _mse(a, b) -> float:
    a = _f32(a)
    return float(((a - _f32(b, a.device)) ** 2).mean())


def edge_mse(img1, img2, edge: str) -> float:
    """MSE between touching edges (:312-319)."""
    if edge == "left":
        return _mse(img1[:, 0], img2[:, -1])
    if edge == "top":
        return _mse(img1[0, :], img2[-1, :])
    raise ValueError(edge)


def edge_mse_top(img1, img2, edge_other: str) -> float:
    """Top-face seams: img1's top row vs a rotated edge of img2 (:327-341;
    see module docstring for the fixed first-argument semantics)."""
    img1 = _f32(img1)
    img2 = _f32(img2, img1.device)
    side1 = img1[0, :]
    if edge_other == "left":
        side2 = img2[:, 0]
    elif edge_other == "right":
        side2 = img2[:, -1].flip(0)
    elif edge_other == "top":
        side2 = img2[0, :].flip(0)
    elif edge_other == "bottom":
        side2 = img2[-1, :]
    else:
        raise ValueError(edge_other)
    return _mse(side1, side2)


class VREvaluator:
    """eval_fn for VRDriver: per face returns
    [gradx_ratio, grady_ratio, gradmag_ratio, edge, style, content, temporal]
    (fast_artistic_video_vr.lua:403-452), on the driver's device tensors."""

    def __init__(self, opt, device=device_mod.DEFAULT):
        self.opt = opt
        self.scorer = PerceptualScorer(opt, device)

    def __call__(self, driver, i: int) -> Optional[List[float]]:
        from .driver_vr import PROC_ORDER

        opt = self.opt
        g = driver.geo
        pos = (i - 1) % 6
        seg = driver.segments
        mf = opt.occlusions_min_filter

        def trim(t):
            ow, oh = opt.overlap_pixel_w // 2, opt.overlap_pixel_h // 2
            return t[oh : t.shape[0] - oh, ow : t.shape[1] - ow]

        def erode(m):
            return filters.min_filter(m, mf)

        gradx = grady = gradmag = edge = 0.0
        if pos == 1:
            gradx, grady, gradmag = gradient_ratios(seg[1], erode(g.mask_left))
            edge = edge_mse(trim(seg[0]), trim(seg[1]), "left")
        elif pos == 2:
            gradx, grady, gradmag = gradient_ratios(seg[2], erode(g.mask_right))
            edge = edge_mse(trim(seg[2]), trim(seg[0]), "left")
        elif pos == 3:
            gradx, grady, gradmag = gradient_ratios(
                seg[3], erode(g.mask_right + g.mask_left)
            )
            edge = edge_mse(trim(seg[1]), trim(seg[3]), "left")
        elif pos == 4:
            gradx, grady, gradmag = gradient_ratios(seg[4], erode(g.mask_all))
            edge = (
                edge_mse_top(trim(seg[0]), trim(seg[4]), "top")
                + edge_mse_top(trim(seg[1]), trim(seg[4]), "right")
                + edge_mse_top(trim(seg[2]), trim(seg[4]), "left")
                + edge_mse_top(trim(seg[3]), trim(seg[4]), "bottom")
            ) / 4
        elif pos == 5:
            gradx, grady, gradmag = gradient_ratios(seg[5], erode(g.mask_all))

        style, cont = self.scorer(driver.last_content, seg[pos])
        temporal = 0.0
        has_patterns = bool(opt.flow_pattern_eval or opt.flow_pattern)
        if i > 6 and has_patterns and not getattr(opt, "no_consistency_eval", False):
            file_idx = (i - 1) // 6 + opt.start_frame
            pat_f = opt.flow_pattern_eval or opt.flow_pattern
            pat_c = opt.occlusions_pattern_eval or opt.occlusions_pattern
            fname = format_flow_name(pat_f, file_idx - 1, file_idx)
            cname = format_flow_name(pat_c, file_idx - 1, file_idx)
            if "%" in fname:
                fname = fname % PROC_ORDER[pos]
            if "%" in cname:
                cname = cname % PROC_ORDER[pos]
            flow = io.read_flo(fname)
            cert = io.load_image(cname, num_channels=1)[..., 0]
            if opt.invert_occlusion_eval:
                cert = 1.0 - cert
            temporal = temporal_error(
                driver.prev_segments[pos], seg[pos], flow, cert, opt.backward_eval
            )
        return [gradx, grady, gradmag, edge, style, cont, temporal]


def _scale_shorter(img, size: int):
    """Resize (H, W, C) so its shorter side is `size`: bilinear, antialiased
    when shrinking (``jax.image.resize(..., "bilinear")``)."""
    h, w = img.shape[:2]
    if h < w:
        nh, nw = size, max(1, round(w * size / h))
    else:
        nh, nw = max(1, round(h * size / w)), size
    return resize_bilinear(img, (nh, nw))


def ssim(a, b, window: int = 7) -> float:
    """Mean SSIM between two [0,1] images (H, W, C), in float64 on a's
    device (numpy: the CPU). Uniform window, standard constants (K1=0.01,
    K2=0.03, L=1)."""
    c1, c2 = 0.01**2, 0.03**2
    a = _f32(a).double()
    b = _f32(b, a.device).double()
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]

    def box(x):
        k = window
        out = F.pad(x, (0, 0, 1, 0, 1, 0)).cumsum(0).cumsum(1)
        s = out[k:, k:] - out[:-k, k:] - out[k:, :-k] + out[:-k, :-k]
        return s / (k * k)

    mu_a, mu_b = box(a), box(b)
    var_a = box(a * a) - mu_a**2
    var_b = box(b * b) - mu_b**2
    cov = box(a * b) - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2)
    return float((num / den).mean())
